"""The port's host-cost and capacity probes against the JAX package's
tools/host_cost_probe.py, on the CPU.

* ``probes.host_cost.make_digests`` equals the tool's digest builder,
  array for array;
* the port's ``Receiver._consume_digest`` over those digests leaves every
  channel in the state the JAX Receiver's leaves it (subframes, bits,
  framer, ephemeris mask), and ``measure`` counts the tool's subframes;
* ``probes.capacity``: its written-out per-block program equals the
  Receiver's (``_track_and_digest_carried`` then ``digest_to_host``), the
  tiled-digest check, and the combination arithmetic on given k and h.

The tool lives under tools/, outside the JAX package: it is imported by
its path.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
from stm32f4_sdr_gps_torch.ops.track_scan import state_from_track_state
from stm32f4_sdr_gps_torch.probes import capacity, host_cost, stress
from stm32f4_sdr_gps_torch.runtime.digest import digest_to_host
from stm32f4_sdr_gps_torch.runtime.receiver import _track_and_digest_carried

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "host_cost_probe", os.path.join(ROOT, "tools", "host_cost_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


def test_make_digests_matches_the_tool():
    ours = host_cost.make_digests(8, 1000, 3)
    theirs = TOOL.make_digests(8, 1000, 3)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a._fields == b._fields
        for name, x, y in zip(a._fields, a, b):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _channel_state(ch):
    f = vars(ch.framer)
    return {"subframes": ch.subframe_count, "bits": ch.bit_count,
            "mask": ch.eph.received_mask_proc,
            "subframe_time_ms": ch.subframe_time_ms,
            "subframe_tow_s": ch.subframe_tow_s,
            "residues": list(ch.boundary_residues),
            "framer": {k: v for k, v in f.items()}}


@pytest.mark.parametrize("n_chan", [8, 32])
def test_decode_matches_the_jax_receiver(n_chan):
    """Three 1000-epoch blocks (one warm-up, two timed) through both
    packages' ``_consume_digest``: every channel's subframes, bits,
    boundary ledger, ephemeris mask and framer state equal."""
    digests = host_cost.make_digests(n_chan, 1000, 3)
    rx = host_cost.receiver(n_chan, device="cpu")
    host_cost.decode(rx, digests, 1000)
    jrx = TOOL.Receiver(TOOL.ReceiverConfig(prns=rx.config.prns,
                                            enable_position=False))
    jrx.channels = [TOOL.ChannelStatus(prn=p, framer=jrx._new_framer())
                    for p in jrx.config.prns]
    for d in digests:
        jrx._consume_digest(d, 1000)
        jrx.epoch_cursor += 1000
    assert rx.epoch_cursor == jrx.epoch_cursor
    for ch, jch in zip(rx.channels, jrx.channels):
        assert _channel_state(ch) == _channel_state(jch), ch.prn
    # 150 bits a channel: preambles found and words decoded, no subframe
    # yet (test_measure_counts_the_tools_subframes decodes them)
    assert sum(ch.framer.words_decoded for ch in rx.channels) > 0


@pytest.mark.parametrize("n_chan", [8, 32])
def test_measure_counts_the_tools_subframes(n_chan):
    rec = host_cost.measure(n_chan, 1000, 8, device="cpu")
    want = TOOL.measure(n_chan, 1000, 8)
    assert rec["subframes_decoded"] == want["subframes_decoded"] > 0
    assert rec["channels"] == n_chan and rec["host_cpu"]
    assert rec["host_only_rt_x"] > 0


def test_receiver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match=r"Receiver\(device='cuda'\)"):
        host_cost.receiver(4)
    with pytest.raises(RuntimeError, match=r"capacity\.measure"):
        capacity.measure()


def _small_scan(n_epochs=60):
    """Four channels at 49 dBHz, 3 codes a bit, for the kernel's plain
    version: (ScanState, epochs, code rows, TrackConfig)."""
    from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture

    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=cp, cn0_dbhz=49.0,
                   codes_in_bit=3, nav_bits=list(np.arange(40) % 2))
            for p, d, cp in ((3, 1200.0, 100.0), (9, -700.0, 512.0),
                             (14, 2500.0, 900.0), (30, -3100.0, 20.0))]
    x, _ = simulate_capture(sats, num_epochs=n_epochs, seed=5)
    cfg = TrackConfig(codes_in_bit=3, in_kernel_scan=True)
    st, epochs, table = stress.track_inputs(
        x, [s.prn for s in sats], [s.code_phase_chips + 0.1 for s in sats],
        [s.doppler_hz + 15.0 for s in sats], cfg, "cpu")
    return state_from_track_state(st), epochs, table, cfg


def test_program_is_the_receivers_block():
    """capacity.program (the parts written out, marks between them) gives
    the Receiver's per-block program's state and digest exactly, and
    calls its mark after each of the three parts."""
    ps, x, u2, cfg = _small_scan()
    marks = []
    ps2, d = capacity.program(ps, x, u2, cfg, mark=lambda: marks.append(1))
    assert len(marks) == 3
    ps_r, _, d_r = _track_and_digest_carried(
        ps, x, u2, BASEBAND_PLAN, cfg, capacity.RX.code_filter_len,
        capacity.RX.enable_code_filter)
    for a, b in zip(ps2, ps_r):
        assert torch.equal(a, b)
    for name, a, b in zip(d._fields, d, digest_to_host(d_r)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert d.bit_count.sum() > 0
    capacity.check_receivers(ps, x, u2, cfg, d)
    with pytest.raises(capacity.CapacityError, match="snr_db"):
        capacity.check_receivers(ps, x, u2, cfg,
                                 d._replace(snr_db=d.snr_db + 1.0))


def test_tiled_digest_check():
    """A block at 8 channels (the 4 tiled twice) passes the check against
    the 4-channel digest tiled; a changed integer leaf, or a float leaf
    off by more than 1e-6 relative, fails it."""
    ps, x, u2, cfg = _small_scan()
    _, d4 = capacity.program(ps, x, u2, cfg)
    big, u2_8 = capacity.tiled(ps, u2, 8)
    _, d8 = capacity.program(big, x, u2_8, cfg)
    res = capacity.check_tiled(d4, d8, 8)
    assert set(res["exact"]) | set(res["rel"]) == set(d4._fields)
    assert all(r <= 1e-6 for r in res["rel"].values())
    bad = d8._replace(bit_count=d8.bit_count + np.eye(1, 8, 5, np.int32)[0])
    with pytest.raises(capacity.CapacityError, match="bit_count"):
        capacity.check_tiled(d4, bad, 8)
    off = d8.doppler_sum.copy()
    off[6] *= 1 + 1e-5
    with pytest.raises(capacity.CapacityError, match="doppler_sum"):
        capacity.check_tiled(d4, d8._replace(doppler_sum=off), 8)
    near = d8.doppler_sum.copy()
    near[6] = np.nextafter(near[6], np.float32(np.inf))
    assert "doppler_sum" in capacity.check_tiled(
        d4, d8._replace(doppler_sum=near), 8)["rel"]


@pytest.mark.parametrize("k, h, c, serial", [
    (500.0, 500.0, 32, 250.0),
    (100.0, 400.0, 256, 80.0),
    (1000.0, 10.0, 1024, 1000.0 / 101.0),
])
def test_capacity_combination(k, h, c, serial):
    """docs/SCALING.md's system-ceiling arithmetic: serial 1/(1/k + 1/h),
    pipelined min(k, h), the aggregate channels C times each."""
    r = capacity.combine(k, h, c)
    assert r["serial_x"] == pytest.approx(serial, rel=1e-12)
    assert r["pipelined_x"] == min(k, h)
    assert r["channels_rt_serial"] == pytest.approx(c * serial, rel=1e-12)
    assert r["channels_rt_pipelined"] == c * min(k, h)
    assert r["k"] == k and r["h"] == h
