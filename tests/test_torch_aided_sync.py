"""The port's aided bit sync (track/aided_sync.py and the Receiver's
_aided_sync_* chain) against the JAX package's.

* the decision functions on seeded histograms, prompt histories and
  states: phases and every state leaf exactly, confidences within rtol
  1e-6;
* the Receiver's window logic fed the same digest leaves in both
  packages: the same engage, unhealthy and pending decisions, exactly,
  and the re-anchored Doppler within 1e-3 Hz (the same FFT bin);
* every host mutation of the tracking state drops the tracking-scan
  kernel's carried state, so the next block rebuilds it from the new
  TrackState;
* the 30 dBHz run of tests/test_aided_sync.py in both packages, on both
  readback paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.acquire.engine import AcqResult as JAcqResult
from stm32f4_sdr_gps_tpu.config import COHERENT_TRACK as J_COHERENT
from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.runtime.receiver import ChannelStatus as JChannel
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_tpu.signal.nav_message import build_bitstream
from stm32f4_sdr_gps_tpu.signal.scenarios import CANONICAL_EPH
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_tpu.track import aided_sync as jas
from stm32f4_sdr_gps_tpu.track.state import TrackState as JTrackState
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch import convert
from stm32f4_sdr_gps_torch.acquire.engine import AcqResult
from stm32f4_sdr_gps_torch.config import COHERENT_TRACK, ReceiverConfig
from stm32f4_sdr_gps_torch.runtime import receiver as trx
from stm32f4_sdr_gps_torch.runtime.receiver import ChannelStatus, Receiver
from stm32f4_sdr_gps_torch.track import aided_sync as tas
from stm32f4_sdr_gps_torch.track.state import init_state

torch.set_num_threads(2)

CIB = 20
SPE = 2046


def _planted_hist(rng, c_cnt, cib=CIB, peaks=(), base=30):
    """(cib, C) Poisson flip counts with ``peaks[c] = (phase, excess,
    split)`` planted: ``excess`` flips at ``phase`` (``split`` of them
    one bin later, a bit edge near an epoch's midpoint)."""
    h = rng.poisson(base, (cib, c_cnt)).astype(np.int64)
    for c, (ph, excess, split) in enumerate(peaks):
        h[ph % cib, c] += excess - split
        h[(ph + 1) % cib, c] += split
    return h


@pytest.mark.parametrize("seed", range(4))
def test_boundary_from_flip_hist_matches_jax(seed):
    rng = np.random.default_rng(seed)
    peaks = [(int(rng.integers(CIB)), int(rng.integers(0, 120)),
              int(rng.integers(0, 40))) for _ in range(8)]
    hist = _planted_hist(rng, 8, peaks=peaks)
    want = jas.boundary_from_flip_hist(hist)
    got = tas.boundary_from_flip_hist(hist)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    # a 1-D histogram is one channel
    w1, g1 = jas.boundary_from_flip_hist(hist[:, 0]), \
        tas.boundary_from_flip_hist(hist[:, 0])
    assert g1[0].shape == (1,) and g1[0][0] == w1[0][0]


@pytest.mark.parametrize("first_epoch", [0, 7, 1234])
def test_find_bit_boundary_matches_jax(first_epoch):
    rng = np.random.default_rng(first_epoch)
    bits = rng.choice([-1.0, 1.0], (200, 5))
    ip = np.repeat(bits, CIB, axis=0)
    ip = ip * np.where(rng.random(ip.shape) < 0.16, -1.0, 1.0)
    ip = ip * rng.uniform(0.5, 2.0, ip.shape)
    want = jas.find_bit_boundary(ip, CIB, first_epoch=first_epoch)
    got = tas.find_bit_boundary(ip, CIB, first_epoch=first_epoch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert (got[0] == first_epoch % CIB).all()


def _random_leaves(rng, c, window=4):
    """Every TrackState leaf, seeded, in the JAX package's dtypes."""
    jst = j_init_state(c, rng.uniform(0, 1023, c), rng.uniform(-4e3, 4e3, c),
                       start_epoch=500, window=window)
    leaves = []
    for v in jst:
        a = np.asarray(v)
        if a.dtype == np.bool_:
            a = rng.random(a.shape) < 0.5
        elif a.dtype.kind == "i":
            a = rng.integers(-3, 40, a.shape).astype(a.dtype)
        else:
            a = rng.standard_normal(a.shape).astype(a.dtype)
        leaves.append(a)
    return leaves


@pytest.mark.parametrize("masked", [False, True])
def test_engage_bit_sync_matches_jax(masked):
    rng = np.random.default_rng(11 + masked)
    c = 7
    leaves = _random_leaves(rng, c)
    phases = rng.integers(0, CIB, c)
    mask = rng.random(c) < 0.5 if masked else None
    for next_epoch in (0, 19, 20, 4321):
        want = jas.engage_bit_sync(
            JTrackState(*(jnp.asarray(v) for v in leaves)), phases,
            next_epoch, CIB, mask)
        got = tas.engage_bit_sync(
            convert.track_state_from_numpy(leaves, device="cpu"), phases,
            next_epoch, CIB, mask)
        got_np = convert.track_state_to_numpy(got)
        for f in JTrackState._fields:
            w = np.asarray(getattr(want, f))
            assert got_np[f].dtype == w.dtype, f
            np.testing.assert_array_equal(got_np[f], w, err_msg=f)


PRNS3 = (9, 4, 17)


def _sats(prns=PRNS3, cn0=45.0):
    return [SimSat(prn=p, doppler_hz=d, code_phase_chips=cp, cn0_dbhz=cn0,
                   codes_in_bit=CIB, nav_bits=[1, 0, 0, 1] * 10)
            for p, d, cp in zip(prns, (1200.0, -800.0, 2500.0),
                                (500.0, 100.0, 900.0))]


def _step_receivers(window_ms):
    """A JAX and a port Receiver with the same three live channels and
    tracking state (and the port's code table, which its Doppler
    re-anchor reads), ready for _aided_sync_step."""
    kw = dict(prns=PRNS3, enable_position=False,
              aided_sync_window_ms=window_ms)
    jrx = JReceiver(JReceiverConfig(track=J_COHERENT, **kw))
    rx = Receiver(ReceiverConfig(track=COHERENT_TRACK, **kw), device="cpu")
    cp = np.array([500.0, 100.0, 900.0])
    dop = np.array([1203.0, -797.0, 2495.0])
    jrx.channels = [JChannel(prn=p) for p in PRNS3]
    rx.channels = [ChannelStatus(prn=p) for p in PRNS3]
    jrx.track_state = j_init_state(3, cp, dop, start_epoch=0)
    rx.track_state = init_state(3, cp, dop, start_epoch=0, device="cpu")
    rx.code_table = rx._code_rows(PRNS3)
    return jrx, rx


def test_aided_sync_step_decisions_match_jax():
    """Both packages' window logic on the same digest leaves, block after
    block: a confident channel engages on one window, a moderate one on
    two agreeing windows, a synced channel with a flat histogram turns
    unhealthy after two windows and is de-synced; every decision, the
    pending ledgers and the re-anchored Doppler agree."""
    rng = np.random.default_rng(5)
    n_ep = 256
    x, _ = simulate_capture(_sats(), num_epochs=n_ep, seed=9)
    ep = x.reshape(n_ep, SPE)
    j_ep, t_ep = jnp.asarray(ep), torch.as_tensor(ep)
    window = 2 * n_ep
    jrx, rx = _step_receivers(window)
    acted = {"engage": 0, "unhealthy": 0}
    for blk in range(12):
        # ch 0 confident at phase 3, ch 1 moderate at phase 11, ch 2 flat;
        # ch 2 reads as synced from the third block on
        hist = _planted_hist(rng, 3, base=4, peaks=[
            (3, 60, 10), (11, 13, 0), (0, 0, 0)])
        hist[:, 2] = 4
        if blk == 2:
            jrx.track_state = jrx.track_state._replace(
                period_sync_ok=jnp.asarray([False, False, True]))
            rx.track_state = rx.track_state._replace(
                period_sync_ok=torch.tensor([False, False, True]))
        first = rng.choice([-1, 1], 3).astype(np.int8)
        last = rng.choice([-1, 1], 3).astype(np.int8)
        sync_last = np.array([False, False, blk >= 2])
        grid_now = rng.integers(0, CIB, 3).astype(np.int32)
        cp0 = np.array([500.0, 100.0, 900.0], np.float32)
        before = (np.asarray(jrx.track_state.period_sync_ok).copy(),
                  np.asarray(jrx.track_state.right_period_cnt).copy())
        jrx._aided_sync_step(hist.copy(), first, last, sync_last, grid_now,
                             cp0, n_ep, j_ep)
        rx._aided_sync_step(hist.copy(), first, last, sync_last, grid_now,
                            cp0, n_ep, t_ep)
        for name in ("_pending_phase", "_pending_cnt", "_aided_low_conf",
                     "_flip_hist_ms", "_flip_prev_sign"):
            np.testing.assert_array_equal(getattr(rx, name),
                                          getattr(jrx, name), err_msg=name)
        if jrx._flip_hist is None:
            assert rx._flip_hist is None
        else:
            np.testing.assert_array_equal(rx._flip_hist, jrx._flip_hist)
        got = convert.track_state_to_numpy(rx.track_state)
        for f in JTrackState._fields:
            w = np.asarray(getattr(jrx.track_state, f))
            if f == "doppler_hz":
                np.testing.assert_allclose(got[f], w, atol=1e-3)
            else:
                np.testing.assert_array_equal(got[f], w, err_msg=f)
        after = np.asarray(jrx.track_state.period_sync_ok)
        acted["engage"] += int((after & ~before[0]).sum())
        acted["unhealthy"] += int((before[0] & ~after).sum())
        jrx.epoch_cursor += n_ep
        rx.epoch_cursor += n_ep
    assert acted["engage"] >= 2 and acted["unhealthy"] >= 1, acted


def _assert_carry_dropped(rx, blk, monkeypatch):
    """The next block rebuilds the kernel state from the TrackState the
    mutation left, not from the carried kernel state."""
    seen = []
    real = trx.state_from_track_state

    def spy(ts):
        seen.append(ts)
        return real(ts)

    mutated = rx.track_state
    assert mutated is not rx._scan_carry_ref
    monkeypatch.setattr(trx, "state_from_track_state", spy)
    rx._aided_sync_step = lambda *a: None     # no window decision after it
    rx.process_block(blk)
    assert len(seen) == 1 and seen[0] is mutated
    assert rx.track_state is rx._scan_carry_ref


@pytest.mark.parametrize("site", ["engage", "unhealthy", "reacquire",
                                  "drop"])
def test_host_mutation_drops_the_kernel_carry(site, monkeypatch):
    """Every host mutation of the tracking state (engage_bit_sync, the
    de-sync and the Doppler re-anchor of _aided_sync_step, concat_states
    in maybe_reacquire, the row selection in drop_dead_channels) builds a
    new TrackState, and the kernel's carried state is rebuilt from it at
    the next block (the kernel's plain version on the CPU)."""
    import dataclasses

    n_ep = 128
    x, _ = simulate_capture(_sats(), num_epochs=3 * n_ep, seed=4)
    track = dataclasses.replace(COHERENT_TRACK, in_kernel_scan=True,
                                pre_track_epochs=20)
    rx = Receiver(ReceiverConfig(prns=PRNS3 + (30,), track=track,
                                 enable_position=False,
                                 aided_sync_window_ms=n_ep),
                  device="cpu")
    for ch, (d, cp) in zip(rx.channels, ((1200.0, 500.0), (-800.0, 100.0),
                                         (2500.0, 900.0), (0.0, 0.0))):
        ch.acq = AcqResult(prn=ch.prn, detected=ch.prn != 30,
                           code_phase_chips=cp, doppler_hz=d,
                           peak_power=1.0, peak_ratio=3.0, peak_to_mean=9.0)
    rx.start_tracking(x)
    blocks = [x[i * n_ep * SPE:(i + 1) * n_ep * SPE] for i in range(3)]
    rx._aided_sync_step = lambda *a: None          # no window decisions yet
    rx.process_block(blocks[0])
    del rx._aided_sync_step
    assert rx.track_state is rx._scan_carry_ref
    t_ep = torch.as_tensor(blocks[1].reshape(n_ep, SPE))
    c = len(rx.channels)
    hist = np.zeros((CIB, c), np.int64)
    if site == "engage":
        hist[5] = 500
        sync = np.zeros(c, bool)
    elif site == "unhealthy":
        rx._aided_low_conf = np.full(c, 5)
        sync = np.ones(c, bool)
    if site in ("engage", "unhealthy"):
        rx._aided_sync_step(hist, np.ones(c, np.int8), np.ones(c, np.int8),
                            sync, np.zeros(c, np.int32),
                            np.zeros(c, np.float32), n_ep, t_ep)
        ok = rx.track_state.period_sync_ok
        assert bool(ok.all()) if site == "engage" else not bool(ok.any())
    elif site == "reacquire":
        rx.standby_channels[0].acq_hint_hz = None
        monkeypatch.setattr(trx, "acquire", lambda w, prns, *a, **k: [
            AcqResult(prn=p, detected=True, code_phase_chips=1.0,
                      doppler_hz=0.0, peak_power=1.0, peak_ratio=3.0,
                      peak_to_mean=9.0) for p in prns])
        rx.epoch_cursor = n_ep * 2
        assert rx.maybe_reacquire(x[: 2 * n_ep * SPE]) == [30]
        assert rx.track_state.doppler_hz.shape[0] == c + 1
    else:
        rx.epoch_cursor = 10_000
        for ch in rx.channels:
            ch.cn0_dbhz = 40.0
        rx.channels[1].cn0_dbhz = 0.0
        assert rx.drop_dead_channels() == [PRNS3[1]]
        assert rx.code_table.shape[0] == c - 1
    _assert_carry_dropped(rx, blocks[1], monkeypatch)


def _run_30dbhz(pkg, device_digest, x):
    cfg_kw = dict(prns=(9,), enable_position=False,
                  aided_sync_window_ms=3000, device_digest=device_digest)
    if pkg == "jax":
        rx = JReceiver(JReceiverConfig(track=J_COHERENT, **cfg_kw))
        acq = JAcqResult
    else:
        rx = Receiver(ReceiverConfig(track=COHERENT_TRACK, **cfg_kw),
                      device="cpu")
        acq = AcqResult
    ch = rx.channels[0]
    ch.acq = acq(prn=9, detected=True, code_phase_chips=500.0,
                 doppler_hz=1200.0, peak_power=1.0, peak_ratio=3.0,
                 peak_to_mean=10.0)
    ch.state_name = "ACQ_DONE"
    rx.start_tracking(x[: SPE * 300])
    blk = 500 * SPE
    for i in range(0, len(x) - blk + 1, blk):
        rx.process_block(x[i:i + blk])
    return rx


def _planted_matches(history, bits):
    """Decoded raw bits that agree with the planted bits, polarity free:
    each bit is matched to the planted bit on the nearest grid start."""
    agree = sum(int(v == bits[(e + CIB // 2) // CIB]) for v, e in history
                if (e + CIB // 2) // CIB < len(bits))
    return max(agree, len(history) - agree)


@pytest.fixture(scope="module")
def capture_30dbhz():
    """tests/test_aided_sync.py:137's capture: PRN 9 at 30 dBHz, 8 s."""
    stream = build_bitstream(CANONICAL_EPH, start_tow_6s=40,
                             num_subframes=2, subframe_ids=(1, 2))
    bits = list(stream[:400])
    sat = SimSat(prn=9, doppler_hz=1200.0, code_phase_chips=500.0,
                 cn0_dbhz=30.0, codes_in_bit=CIB, nav_bits=bits)
    x, _ = simulate_capture([sat], num_epochs=CIB * 200 + 4000, seed=5)
    return x, bits


@pytest.mark.parametrize("device_digest", [True, False],
                         ids=["digest", "full_readback"])
def test_receiver_aided_sync_30dbhz_matches_jax(device_digest,
                                                 capture_30dbhz):
    """tests/test_aided_sync.py's 30 dBHz run (acquisition handoff, the
    counters can't sync, the aided search engages the coherent loop) in
    both packages: both engage, the bit grid agrees mod codes_in_bit, and
    the port's bits match the planted ones at least as well as the JAX
    package's, less 2 bits (the closed loops may part at a marginal
    sign decision)."""
    x, bits = capture_30dbhz
    jrx = _run_30dbhz("jax", device_digest, x)
    rx = _run_30dbhz("torch", device_digest, x)
    jch, ch = jrx.channels[0], rx.channels[0]
    assert jch.bit_synced and ch.bit_synced, "aided sync never engaged"
    assert bool(rx.track_state.period_sync_ok[0])
    assert rx.aided_engagements.get(9, 0) >= 1
    assert ch.bit_count > 80
    grid = int(rx.track_state.last_swap_epoch[0]) % CIB
    assert grid == int(np.asarray(jrx.track_state.last_swap_epoch)[0]) % CIB
    assert _planted_matches(ch.framer.history, bits) >= \
        _planted_matches(jch.framer.history, bits) - 2
