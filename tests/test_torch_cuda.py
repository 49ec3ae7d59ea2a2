"""The hand-written kernels on the card against their plain torch
versions: the tracking scan (K1, in each of its modes), the per-epoch
E/P/L correlator (K2), the correlator-bank probe (P5), the epoch-cost
probes (P6-P8), the roll probes (P1-P4) and the handoff search's
kernels (csrc/pretrack.cu); K1 once a position of a mesh that repeats
the card; the captured tracking programs and the captured acquisition
(utils.graphs) replayed against their eager runs, bit for bit; the
int8 ingest from page-locked windows (utils/device.py ``HostPages``)
against the pageable path, bit for bit; a cold start on a complex-IQ
window in host memory against one on a window already on the card, bit
for bit.

Needs an NVIDIA GPU and nvcc; every test skips without a CUDA device.
Imports only the port, torch and numpy (the machine with the card has no
JAX), so run it there without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances of the tracking loops are those of
tests/test_pallas_scan.py:68-117 (kernel vs reference scan in the JAX
package).  Here the two sides run the same arithmetic and differ only in
the order of the 2046-sample float32 sums and in sincospif vs cos/sin, so
the integer decisions must agree exactly on a 48 dBHz signal scenario.
K2's sums: rtol 1e-4 / atol 1e-3 (tests/test_torch_epl.py says why), and
bit for bit against the sums K1 emits for the same epoch and state.
P5's sums: 1e-4 of the largest (float32 sums over T steps of 2048-term
row sums, in other orders on the two sides).  P6-P8: each probe module's
``tolerance`` (its docstring says why), at the check size on the probe's
inputs and on seeded ones.  P1-P4: bit for bit (a roll is a copy), at 8,
32 and 128 rows on the tools' inputs and on seeded ones, and at an odd
width (the row kernel's scalar path); the wrappers refuse outputs off a
16-byte boundary where the kernels store 16 bytes a thread.  The
matmul DFT's products (torch calls, not kernels): "highest" within the
float32 bound K * 2^-24 * (|a| @ |b|) of a float64 product and under 1 %
of a TF32 product's error; "default" within the same bound of the
float64 product of its bf16-rounded inputs, with a float32 result.
The handoff search's prompts and power: rtol 1e-5 of each channel's
largest, with equal Doppler bins and code peaks
(tests/test_torch_pretrack_kernels.py says why).
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.config import (BASEBAND_PLAN, ReceiverConfig,
                                          TrackConfig)
from stm32f4_sdr_gps_torch.ops import correlate as corr
from stm32f4_sdr_gps_torch.ops import epl
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
from stm32f4_sdr_gps_torch.probes import acquire_replay as ar
from stm32f4_sdr_gps_torch.probes import corr_bank as cb
from stm32f4_sdr_gps_torch.probes import pretrack_kernels as pk
from stm32f4_sdr_gps_torch.probes import (forest_chain, forest_constructs,
                                          forest_layout, mosaic_bisect,
                                          roll_wide)
from stm32f4_sdr_gps_torch.track.scan import track_block
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.track.state import init_state

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

PLAN = BASEBAND_PLAN
PRNS = [1, 4, 7, 9, 13, 18, 22, 30]
CIB = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scenario(num_epochs, seed=11):
    rng = np.random.default_rng(seed)
    sats = [SimSat(prn=prn, doppler_hz=float(rng.uniform(-4000, 4000)),
                   code_phase_chips=float(rng.uniform(0, 1023)),
                   cn0_dbhz=48.0, codes_in_bit=CIB,
                   nav_bits=list(rng.integers(0, 2, 200)))
            for prn in PRNS]
    x, _ = simulate_capture(sats, num_epochs=num_epochs, seed=seed)
    return x.reshape(num_epochs, PLAN.samples_per_epoch), sats


def _inputs(num_epochs, dev, seed=11):
    ep, sats = _scenario(num_epochs, seed)
    st = init_state(len(PRNS),
                    np.array([s.code_phase_chips + 0.1 for s in sats]),
                    np.array([s.doppler_hz + 15.0 for s in sats]),
                    device=dev)
    u2 = torch.as_tensor(upsampled_code_doubled(ca_table_bipolar(PRNS)),
                         device=dev)
    return ts.state_from_track_state(st), torch.as_tensor(ep, device=dev), u2


def assert_scan_match(ps_k, out_k, ps_r, out_r):
    """Kernel (k) vs plain version (r): test_pallas_scan tolerances on
    the floats, exact integer decisions and integer state."""
    ok = ts.outputs_from_raw(out_k)
    orf = ts.outputs_from_raw(out_r)
    np.testing.assert_allclose(ok.ip.cpu(), orf.ip.cpu(), rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(ok.qp.cpu(), orf.qp.cpu(), rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(ok.code_phase_chips.cpu(),
                               orf.code_phase_chips.cpu(), atol=5e-3)
    np.testing.assert_allclose(ok.doppler_hz.cpu(), orf.doppler_hz.cpu(),
                               atol=0.5)
    np.testing.assert_allclose(ok.snr_db.cpu(), orf.snr_db.cpu(), atol=0.1)
    for f in ("bit_ready", "bit_value", "bit_epoch", "period_sync_ok",
              "code_wrapped"):
        np.testing.assert_array_equal(getattr(ok, f).cpu(),
                                      getattr(orf, f).cpu(), err_msg=f)
    if orf.ie.numel():
        for f in ("ie", "qe", "il", "ql"):
            np.testing.assert_allclose(getattr(ok, f).cpu(),
                                       getattr(orf, f).cpu(), rtol=2e-2,
                                       atol=2.0, err_msg=f)
    np.testing.assert_array_equal(ps_k.i32.cpu(), ps_r.i32.cpu())
    np.testing.assert_array_equal(ps_k.win.cpu(), ps_r.win.cpu())
    assert orf.bit_ready.any(), "scenario never produced a nav bit"


def kick_epochs(out, acq_doppler, start_epoch=0):
    """(T, C) bool: epochs whose Doppler output is the watchdog kick
    target acq + (u - 0.5) * 500 with u = LCG(epoch * 37 + channel)."""
    from stm32f4_sdr_gps_torch.track.scan import _lcg_uniform

    t_cnt, c_cnt = out.shape[0], out.shape[2]
    seed = ((start_epoch + torch.arange(t_cnt))[:, None] * 37
            + torch.arange(c_cnt)[None, :])
    target = acq_doppler[None, :] + (_lcg_uniform(seed) - 0.5) * 500.0
    return (out[:, 3] - target).abs() < 1e-3


@pytest.mark.parametrize("window", [4, 6])
def test_kernel_matches_plain_version(dev, window):
    cfg = TrackConfig(codes_in_bit=CIB, pll_check_window=window,
                      pll_bad_state_threshold=10**6)
    ps0, x, u2 = _inputs(90, dev)
    if window != 4:
        ps0 = ps0._replace(win=torch.zeros((window, len(PRNS)),
                                           dtype=torch.int32, device=dev))
    n0 = ts.track_scan_cuda.launches
    ps_k, out_k = ts.track_scan(ps0, x, u2, PLAN, cfg)
    torch.cuda.synchronize()
    assert ts.track_scan_cuda.launches == n0 + 1
    ps_r, out_r = ts.track_scan_reference(ps0, x, u2, PLAN, cfg)
    assert_scan_match(ps_k, out_k, ps_r, out_r)


MODES = {
    "coherent_bit_vote": dict(coherent_bit_vote=True),
    "coherent_pll": dict(coherent_pll=True),
    "coherent_pll_ext5": dict(coherent_pll=True, pll_ext_bits=5),
    "emit_correlators": dict(emit_correlators=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_mode_matches_plain_version(dev, mode):
    """K1's other modes: the same rules, the E/L slots under the I/Q
    tolerance, the K-bit accumulators under test_pallas_scan's."""
    cfg = TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**6,
                      **MODES[mode])
    ps0, x, u2 = _inputs(90, dev)
    ps_k, out_k = ts.track_scan(ps0, x, u2, PLAN, cfg)
    torch.cuda.synchronize()
    assert out_k.shape[1] == (15 if cfg.emit_correlators else 11)
    ps_r, out_r = ts.track_scan_reference(ps0, x, u2, PLAN, cfg)
    assert_scan_match(ps_k, out_k, ps_r, out_r)
    np.testing.assert_allclose(ps_k.f32[14:].cpu(), ps_r.f32[14:].cpu(),
                               rtol=2e-2, atol=10.0)


def test_kernel_watchdog_kick_matches(dev):
    """Channels started 300 chips off track noise; with a zero threshold
    and an 8-epoch window the false-lock LCG kick fires within ~100
    epochs, and its epochs and every integer must agree exactly."""
    cfg = TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=0,
                      pll_check_window=8)
    ep, sats = _scenario(160)
    st = init_state(len(PRNS),
                    np.array([s.code_phase_chips + 300.0 for s in sats]),
                    np.array([s.doppler_hz + 15.0 for s in sats]),
                    window=8, device=dev)
    ps0 = ts.state_from_track_state(st)
    x = torch.as_tensor(ep, device=dev)
    u2 = torch.as_tensor(upsampled_code_doubled(ca_table_bipolar(PRNS)),
                         device=dev)
    ps_k, out_k = ts.track_scan_cuda(ps0, x, u2, PLAN, cfg)
    ps_r, out_r = ts.track_scan_reference(ps0, x, u2, PLAN, cfg)
    torch.cuda.synchronize()
    kicked = kick_epochs(out_r.cpu(), ps0.f32[7].cpu())
    assert kicked.any(), "no kick fired"
    assert torch.equal(kick_epochs(out_k.cpu(), ps0.f32[7].cpu()), kicked)
    np.testing.assert_array_equal(ps_k.i32.cpu(), ps_r.i32.cpu())
    np.testing.assert_array_equal(ps_k.win.cpu(), ps_r.win.cpu())


def test_kernel_split_equals_full(dev):
    cfg = TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**6)
    ps0, x, u2 = _inputs(80, dev, seed=5)
    ps_f, out_f = ts.track_scan_cuda(ps0, x, u2, PLAN, cfg)
    ps_a, out_a = ts.track_scan_cuda(ps0, x[:44], u2, PLAN, cfg)
    ps_b, out_b = ts.track_scan_cuda(ps_a, x[44:], u2, PLAN, cfg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out_f.cpu(),
                                  torch.cat([out_a, out_b]).cpu())
    np.testing.assert_array_equal(ps_f.f32.cpu(), ps_b.f32.cpu())
    np.testing.assert_array_equal(ps_f.i32.cpu(), ps_b.i32.cpu())
    np.testing.assert_array_equal(ps_f.win.cpu(), ps_b.win.cpu())


@pytest.mark.parametrize("side", ["at", "above", "twice"])
def test_kernel_grouping_matches_plain_version(dev, side):
    """C at the card's SM count (one channel per block), one past it (two
    channels per block, the last block half empty) and twice it plus 8
    (three per block): the 8 channels tiled to C.  Every channel must
    equal its 8-channel original bit for bit (grouping changes no
    channel's arithmetic), and the run must hold to the plain version."""
    from stm32f4_sdr_gps_torch.probes.scan_time import tiled

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c = {"at": sms, "above": sms + 1, "twice": 2 * sms + 8}[side]
    assert (ts.channels_per_block(c) == 1) == (side == "at")
    cfg = TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**6)
    ps0, x, u2 = _inputs(90, dev)
    big, u2_big = tiled(ps0, u2, c)
    ps_k, out_k = ts.track_scan_cuda(big, x, u2_big, PLAN, cfg)
    ps_8, out_8 = ts.track_scan_cuda(ps0, x, u2, PLAN, cfg)
    torch.cuda.synchronize()
    idx = torch.arange(c, device=dev) % len(PRNS)
    assert torch.equal(out_k, out_8[:, :, idx])
    for a, b in zip(ps_k, ps_8):
        assert torch.equal(a, b[:, idx])
    ps_r, out_r = ts.track_scan_reference(big, x, u2_big, PLAN, cfg)
    assert_scan_match(ps_k, out_k, ps_r, out_r)


def test_kernel_per_mesh_position_equals_unsharded(dev):
    """StreamingTracker on an 8-position mesh whose positions all name
    the card: K1 once a position a block (its channel rows each) equals
    one K1 launch over all the channels, bit for bit, in state planes
    and outputs, over two blocks."""
    from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
    from stm32f4_sdr_gps_torch.parallel.streaming import StreamingTracker

    cfg = TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**6)
    ps0, x, u2 = _inputs(90, dev)
    st0 = ts.state_to_track_state(ps0)
    tracker = StreamingTracker(st0, u2, make_mesh(
        time=2, chan=4, devices=[dev] * 8), PLAN, cfg)
    st_one = st0
    for blk in (x[:45], x[45:]):
        launches = ts.track_scan_cuda.launches
        got = tracker.process(blk)
        assert ts.track_scan_cuda.launches - launches == 8
        st_one, want = track_block(st_one, blk, u2, PLAN, cfg)
        for f, g, w in zip(want._fields, got, want):
            assert torch.equal(g, w), f
        for f, g, w in zip(st_one._fields, tracker.gather_state(dev),
                           st_one):
            assert torch.equal(g, w), f
    assert bool(want.bit_ready.any())


def test_scan_parts_builds_see_the_scan_inputs(dev):
    """probes/scan_parts.py at 4 channels: every build compiles without a
    stack frame or spills, and its checks hold (the replaying builds
    reproduce the kernel's outputs or its recorded sums bit for bit)."""
    from stm32f4_sdr_gps_torch.probes import scan_parts

    records = scan_parts.run([4])
    assert [r["build"] for r in records] == ["full"] + scan_parts.BUILDS
    for r in records:
        assert r["stack"] == 0 and r["spills"] == 0, r
        assert r["ms"] > 0


def test_col_parts_builds_check(dev):
    """probes/col_parts.py at 4 channels: every build runs; those that
    keep the exchange equal the host build of the decomposition bit for
    bit, and the 8 blocks of the cluster run on 8 SMs."""
    from stm32f4_sdr_gps_torch.probes import col_parts

    records = col_parts.run([4])
    assert {r["build"] for r in records} == set(col_parts.BUILDS)
    for r in records:
        assert r["check"] is (True if r["build"] in col_parts.CHECKED
                              else None), r
        assert r["sms"] == (8 if r["build"] == "sm_ids" else None), r
        assert r["ns_per_iter"] > 0


def test_receiver_runs_on_kernel(dev):
    """Receiver.run on the card (kernel tracking, device digest) on a
    compressed-bit 4-satellite capture: every channel tracks and decodes
    bits, and the plain version never runs."""
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    rng = np.random.default_rng(23)
    sats = [SimSat(prn=p, doppler_hz=d, cn0_dbhz=49.0, codes_in_bit=CIB,
                   nav_bits=rng.integers(0, 2, 300), delay_ms=dl)
            for p, d, dl in zip((2, 7, 15, 24), (-2500.0, 800.0, 3100.0,
                                                 -400.0),
                                (1.773, 6.402, 3.255, 9.911))]
    x, _ = simulate_capture(sats, num_epochs=700, seed=23)
    cfg = ReceiverConfig(prns=(2, 7, 15, 24),
                         track=TrackConfig(codes_in_bit=CIB,
                                           pll_bad_state_threshold=10**9),
                         enable_position=False)
    rx = Receiver(cfg, device=dev)
    n0 = ts.track_scan_cuda.launches
    r0 = ts.track_scan_reference.calls
    rx.run(x)
    assert ts.track_scan_cuda.launches > n0
    assert ts.track_scan_reference.calls == r0
    for ch in rx.channels:
        assert ch.state_name == "TRACKING"
        assert ch.bit_count > 50, (ch.prn, ch.bit_count)


WRAP_EDGES = (0.0, 0.2, 0.49, 0.51, 1022.6, 1022.99)


@pytest.mark.parametrize("c", [4, 32, 128])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_epl_kernel_matches_plain_version(dev, c, edges):
    rng = np.random.default_rng(c + 7 * edges)
    x = (rng.standard_normal(epl.S)
         + 1j * rng.standard_normal(epl.S)).astype(np.complex64)
    u2 = upsampled_code_doubled(
        ca_table_bipolar([1 + i % 32 for i in range(c)]))
    cp = (np.resize(np.array(WRAP_EDGES, np.float32), c) if edges
          else rng.uniform(0, 1023, c).astype(np.float32))
    dop = rng.uniform(-5000, 5000, c).astype(np.float32)
    ph = rng.uniform(0, 1, c).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (x, u2, cp, dop, ph)]
    n0 = epl.epl_correlate_cuda.launches
    got = epl.epl_correlate(*args, PLAN.sample_rate_hz)
    torch.cuda.synchronize()
    assert epl.epl_correlate_cuda.launches == n0 + 1
    want = epl.epl_correlate_halfchip(*args, PLAN.sample_rate_hz)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


def test_per_epoch_scan_on_kernel_matches_cpu(dev):
    """track_block on the per-epoch half-chip path: K2 on the card against
    the plain version on CPU copies, 90 epochs."""
    cfg = TrackConfig(codes_in_bit=CIB, use_pallas=True,
                      in_kernel_scan=False, pll_bad_state_threshold=10**6)
    ep, sats = _scenario(90)
    st = init_state(len(PRNS),
                    np.array([s.code_phase_chips + 0.1 for s in sats]),
                    np.array([s.doppler_hz + 15.0 for s in sats]),
                    device="cpu")
    u2 = torch.as_tensor(upsampled_code_doubled(ca_table_bipolar(PRNS)))
    x = torch.as_tensor(ep)
    n0 = epl.epl_correlate_cuda.launches
    p0 = epl.epl_correlate_halfchip.calls
    st_k, out_k = track_block(type(st)(*(t.to(dev) for t in st)),
                              x.to(dev), u2.to(dev), PLAN, cfg)
    torch.cuda.synchronize()
    assert epl.epl_correlate_cuda.launches == n0 + 90
    assert epl.epl_correlate_halfchip.calls == p0
    st_r, out_r = track_block(st, x, u2, PLAN, cfg)
    ps_k, ps_r = (ts.state_from_track_state(s) for s in (st_k, st_r))
    np.testing.assert_allclose(out_k.ip.cpu(), out_r.ip, rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(out_k.qp.cpu(), out_r.qp, rtol=2e-2, atol=2.0)
    np.testing.assert_allclose(out_k.code_phase_chips.cpu(),
                               out_r.code_phase_chips, atol=5e-3)
    np.testing.assert_allclose(out_k.doppler_hz.cpu(), out_r.doppler_hz,
                               atol=0.5)
    for f in ("bit_ready", "bit_value", "bit_epoch", "period_sync_ok",
              "code_wrapped"):
        np.testing.assert_array_equal(getattr(out_k, f).cpu(),
                                      getattr(out_r, f), err_msg=f)
    np.testing.assert_array_equal(ps_k.i32.cpu(), ps_r.i32)
    np.testing.assert_array_equal(ps_k.win.cpu(), ps_r.win)
    assert out_r.bit_ready.any(), "scenario never produced a nav bit"


def test_receiver_runs_on_epl_kernel(dev):
    """Receiver.run on the card on the per-epoch half-chip path: every
    epoch's E/P/L is a K2 launch, the plain version never runs."""
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    rng = np.random.default_rng(23)
    sats = [SimSat(prn=p, doppler_hz=d, cn0_dbhz=49.0, codes_in_bit=CIB,
                   nav_bits=rng.integers(0, 2, 300), delay_ms=dl)
            for p, d, dl in zip((2, 7, 15, 24), (-2500.0, 800.0, 3100.0,
                                                 -400.0),
                                (1.773, 6.402, 3.255, 9.911))]
    x, _ = simulate_capture(sats, num_epochs=400, seed=23)
    cfg = ReceiverConfig(prns=(2, 7, 15, 24),
                         track=TrackConfig(codes_in_bit=CIB,
                                           pll_bad_state_threshold=10**9,
                                           use_pallas=True,
                                           in_kernel_scan=False),
                         enable_position=False)
    rx = Receiver(cfg, device=dev)
    n0 = epl.epl_correlate_cuda.launches
    p0 = epl.epl_correlate_halfchip.calls
    k0 = ts.track_scan_cuda.launches
    report = rx.run(x)
    assert epl.epl_correlate_cuda.launches - n0 == \
        report.epochs_processed - cfg.acq.noncoherent_epochs > 0
    assert epl.epl_correlate_halfchip.calls == p0
    assert ts.track_scan_cuda.launches == k0
    for ch in rx.channels:
        assert ch.state_name == "TRACKING"
        assert ch.bit_count > 25, (ch.prn, ch.bit_count)


# K1's output slots of ie, qe, ip, qp, il, ql with emit_correlators
K1_SLOTS = [11, 12, 0, 1, 13, 14]


@pytest.mark.parametrize("c", [4, 32, 128])
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_epl_kernel_equals_k1_emitted_sums(dev, c, edges):
    """K2 adds an epoch's E/P/L in K1's order: with the same (m, ph,
    dopfs) its sums equal those K1 emits for its first epoch
    (emit_correlators), bit for bit.  K1 forms dopfs as st.f[DOP] / p.fs,
    K2 as dop[c] / fs, from the same float32 values."""
    rng = np.random.default_rng(50 + c + 7 * edges)
    x = (rng.standard_normal(epl.S)
         + 1j * rng.standard_normal(epl.S)).astype(np.complex64)
    u2 = upsampled_code_doubled(
        ca_table_bipolar([1 + i % 32 for i in range(c)]))
    cp = (np.resize(np.array(WRAP_EDGES, np.float32), c) if edges
          else rng.uniform(0, 1023, c).astype(np.float32))
    dop = rng.uniform(-5000, 5000, c).astype(np.float32)
    ph = rng.uniform(0, 1, c).astype(np.float32)
    args = [torch.as_tensor(a, device=dev) for a in (x, u2, cp, dop, ph)]
    got = torch.view_as_real(epl.epl_correlate_cuda(*args,
                                                    PLAN.sample_rate_hz))
    ps = ts.state_from_track_state(init_state(c, cp, dop, device=dev))
    ps.f32[0], ps.f32[1], ps.f32[2] = args[2], args[3], args[4]
    _, out = ts.track_scan_cuda(ps, args[0][None], args[1], PLAN,
                                TrackConfig(emit_correlators=True))
    torch.cuda.synchronize()
    want = out[0, K1_SLOTS].T.contiguous()
    assert torch.equal(got.reshape(c, 6).view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.parametrize("variant", ["fma", "mma"])
def test_corr_bank_kernel_matches_plain_version(dev, variant):
    args = cb.device_inputs(dev)[variant]
    n0 = cb.KERNELS[variant].launches
    got = cb.KERNELS[variant](*args, 200)
    torch.cuda.synchronize()
    assert cb.KERNELS[variant].launches == n0 + 1
    want = cb.PLAIN[variant](*args, 200).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("steps", [0, 1, 2, 63, 64, 65, 129])
@pytest.mark.parametrize("variant", ["fma", "mma"])
def test_corr_bank_kernel_step_counts(dev, variant, steps):
    """Odd step counts (the mma kernel takes its steps in pairs of
    register sets) and the edges of its 64-step accumulator flush."""
    args = cb.device_inputs(dev, seed=steps)[variant]
    got = cb.KERNELS[variant](*args, steps)
    torch.cuda.synchronize()
    want = cb.PLAIN[variant](*args, steps).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                               atol=1e-4 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("variant", ["fma", "mma"])
def test_corr_bank_library_call_matches_plain_version(dev, variant):
    """The one-call yardstick computes the probe's function on the card
    (tests/test_torch_corr_bank.py states the tolerances)."""
    args = cb.device_inputs(dev)[variant]
    res = cb.library_call(variant, args, 8)()
    got = cb.library_totals(variant, res, args[3] if variant == "mma"
                            else None, 8).cpu().numpy()
    want = cb.PLAIN[variant](*args, 8).cpu().numpy()
    atol = (1e-3 if variant == "fma"
            else 2 * 8 * 2.0 ** -9 * float(res.float().abs().max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


FOREST = {"P6": forest_chain, "P7": forest_constructs, "P8": forest_layout}
FOREST_CASES = [(probe, v) for probe, mod in FOREST.items()
                for v in mod.VARIANTS]


@pytest.mark.parametrize("which", ["probe", "seeded"])
@pytest.mark.parametrize("probe,variant", FOREST_CASES,
                         ids=[f"{p}-{v}" for p, v in FOREST_CASES])
def test_forest_kernel_matches_plain_version(dev, probe, variant, which):
    mod = FOREST[probe]
    args = mod.check_args(variant, which, dev)
    fn = mod.KERNELS[variant]
    n0 = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    want = mod.PLAIN[variant](*args)
    got, want = ((t if isinstance(t, tuple) else (t,)) for t in (got, want))
    rtol, atol = mod.tolerance(variant)
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert np.all(np.isfinite(g)) and np.all(np.isfinite(w))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["probe", "seeded"])
@pytest.mark.parametrize("c", [32, 4])
@pytest.mark.parametrize("g", [2, 64])
@pytest.mark.parametrize("variant", ["wide_col", "red_col", "roll_col"])
def test_col_kernel_equals_host_decomposition(dev, variant, g, c, which):
    """The col kernels (a grid of clusters; red_col's sums and roll_col's
    halo exchanged on mbarriers) against the host build of the same
    decomposition, bit for bit, over many iterations of the slots'
    double buffers."""
    x, w, _, _ = forest_layout.check_args(variant, which, dev, c)
    got = forest_layout.layout_cuda(x, w, variant, g)
    torch.cuda.synchronize()
    want = forest_layout.layout_col_host(x.cpu(), w.cpu(), variant, g)
    for gv, wv in zip(got, want):
        assert torch.equal(gv.cpu(), wv)


@pytest.mark.parametrize("c", [4, 256])
@pytest.mark.parametrize("variant", forest_constructs.VARIANTS)
def test_constructs_kernel_equals_host_build(dev, variant, c):
    """P7 with the planes in registers, at one partial warp (the warp
    vote) and at 8 warps (the block barrier), against the host build of
    its body: bit for bit, sincos within its tolerance."""
    args = forest_constructs.check_args(variant, "seeded", dev, c)
    got = forest_constructs.constructs_cuda(*args)
    torch.cuda.synchronize()
    want = forest_constructs.constructs_host(args[0].cpu(), *args[1:])
    rtol, atol = forest_constructs.tolerance(variant)
    for gv, wv in zip(got, want):
        if variant == "sincos":
            np.testing.assert_allclose(gv.cpu().numpy(), wv.numpy(),
                                       rtol=rtol, atol=atol)
        else:
            assert torch.equal(gv.cpu(), wv)


ROLL_CASES = ([(roll_wide, c) for c in roll_wide.CASES]
              + [(mosaic_bisect, c) for c in mosaic_bisect.CASES])


@pytest.mark.parametrize("rows", [8, 32, 128])
@pytest.mark.parametrize("which", ["probe", "seeded"])
@pytest.mark.parametrize("mod,case", ROLL_CASES,
                         ids=[c for _, c in ROLL_CASES])
def test_roll_kernel_matches_plain_version(dev, mod, case, which, rows):
    args = mod.check_args(case, which, dev, rows)
    fn = mod.KERNELS[case]
    n0 = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    want = mod.PLAIN[case](*args)
    got, want = ((t if isinstance(t, tuple) else (t,)) for t in (got, want))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rows", [8, 32, 128])
@pytest.mark.parametrize("case", ["dynwin_neg", "dynwin_pos", "statwin"])
def test_roll_kernel_odd_width(dev, case, rows):
    """At a width that is no multiple of 4 (rows off 16-byte boundaries)
    the kernel's scalar path, bit for bit."""
    args = roll_wide.check_args(case, "seeded", dev, rows,
                                roll_wide.ODD_WIDTH)
    got = roll_wide.KERNELS[case](*args)
    torch.cuda.synchronize()
    assert torch.equal(got, roll_wide.PLAIN[case](*args))


def _misaligned(shape, dev):
    n = int(np.prod(shape))
    return torch.empty(n + 4, device=dev)[1:n + 1].view(shape)


def test_roll_kernels_refuse_a_misaligned_out(dev):
    """The 16-byte stores need 16-byte aligned rows: the wrappers refuse
    an out off a 16-byte boundary, and launch nothing; at an odd width the
    scalar path takes it.  x may start anywhere (scalar loads)."""
    x, amt = roll_wide.check_args("dynwin_pos", "seeded", dev)
    n0 = roll_wide.dyn_roll_cuda.launches
    with pytest.raises(ValueError, match="16-byte"):
        roll_wide.dyn_roll_cuda(x, amt, out=_misaligned(x.shape, dev))
    assert roll_wide.dyn_roll_cuda.launches == n0
    x_off = _misaligned(x.shape, dev)
    x_off.copy_(x)
    got = roll_wide.dyn_roll_cuda(x_off, amt)
    torch.cuda.synchronize()
    assert torch.equal(got, roll_wide.roll_rows_reference(x, amt))
    args = roll_wide.check_args("barrel", "seeded", dev)
    for k in range(3):
        out = [torch.empty((8, roll_wide.WIN), device=dev) for _ in range(3)]
        out[k] = _misaligned((8, roll_wide.WIN), dev)
        with pytest.raises(ValueError, match="16-byte"):
            roll_wide.barrel_cuda(*args, out=tuple(out))
    x, amt = roll_wide.check_args("dynwin_pos", "seeded", dev,
                                  lanes=roll_wide.ODD_WIDTH)
    out = roll_wide.dyn_roll_cuda(x, amt, out=_misaligned(x.shape, dev))
    torch.cuda.synchronize()
    assert torch.equal(out, roll_wide.roll_rows_reference(x, amt))


def test_dft_products_hold_their_precision(dev):
    """The matmul DFT's products at the acquisition's shape against
    float64 products of the same inputs; with TF32 turned on, "highest"
    refuses to run rather than change the process-wide setting."""
    k = 2046
    a = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (64, k)).astype(np.float32), device=dev)
    wc, _ = corr.dft_tables_device(k, device=dev)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    def tf32(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
                ).view(torch.float32)

    def f64(x, y):
        return x.double() @ y.double()

    errs = {}
    for name, (x, y) in (("highest", (a, wc)),
                         ("default", (bf16(a), bf16(wc)))):
        got = corr.dft_matmul(a, wc, name)
        assert got.dtype == torch.float32, name
        err = (got.double() - f64(x, y)).abs()
        assert (err <= k * 2.0 ** -24 * f64(x.abs(), y.abs())).all(), name
        errs[name] = err.max().item()
    tf32_err = (f64(tf32(a), tf32(wc)) - f64(a, wc)).abs().max().item()
    assert errs["highest"] < 0.01 * tf32_err
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    try:
        m.fp32_precision = "tf32"
        with pytest.raises(RuntimeError, match="TF32"):
            corr.dft_matmul(a, wc, "highest")
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = prev


# ---------------------------------------------------------------- graphs

@pytest.mark.parametrize("name,c", [("k1_carried", 4), ("k1_carried", 256),
                                    ("k2_per_epoch", 8),
                                    ("reference_scan", 8)])
def test_replayed_program_equals_eager(dev, monkeypatch, name, c):
    """The captured programs (utils.graphs) against their eager runs
    (probes/graph_replay.py at 200-epoch blocks): every returned leaf bit
    for bit, block n's results unchanged by block n + 1, the counted
    launches, a channel dropped recaptured."""
    from stm32f4_sdr_gps_torch.probes import graph_replay as gr

    monkeypatch.setattr(gr, "BLOCK", 200)
    data = gr.scenario()
    eager = gr.run(name, c, data, True)
    replayed = gr.run(name, c, data, False)
    gr.check(name, c, eager, replayed)


def test_failed_capture_raises(dev):
    """A program that syncs with the host inside cannot be captured: the
    call raises, with no eager retry."""
    from stm32f4_sdr_gps_torch.utils import graphs

    @graphs.captured()
    def syncs(x):
        return x * x.sum().item()

    captures = graphs.stats["captures"]
    with pytest.raises(RuntimeError):
        syncs(torch.ones(4, device=dev))
    assert graphs.stats["captures"] == captures
    with graphs.disable_capture():
        assert torch.equal(syncs(torch.ones(4, device=dev)),
                           torch.full((4,), 4.0, device=dev))


@pytest.mark.parametrize("case", list(ar.CASES))
def test_captured_acquisition_equals_eager(dev, case):
    """The acquisition's captured program (acquire.engine._acquire_fused)
    against its eager run (probes/acquire_replay.py): every AcqResult
    field bit for bit on two windows and two PRN sets of one size, one
    capture, a replay and one readback a call."""
    ar.check(case, ar.scenario(), dev)


def test_acquisition_refuses_tf32_on_a_replayed_key(dev):
    """The "highest" DFT precision, captured with TF32 off, raises on its
    replayed key once TF32 is on, and captures nothing."""
    ar.tf32_refused(ar.scenario(), dev)


@pytest.mark.parametrize("case", list(pk.CASES))
def test_pretrack_kernel_matches_plain_loop(dev, case):
    kind, c, e = pk.CASES[case]
    rec = pk.check(kind, pk.inputs(c, e, dev))
    assert rec["launches"] == (1 if kind == "prompts" else 2)


def test_cold_start_handoff_on_kernels(dev):
    """A cold start on the card hands over through the two search
    kernels: three launches, no plain loop, and the code search uploads
    nothing."""
    from stm32f4_sdr_gps_torch.acquire import engine
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
    from stm32f4_sdr_gps_torch.track import pretrack
    from stm32f4_sdr_gps_torch.utils import profiling

    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=q, cn0_dbhz=48.0)
            for p, d, q in zip((2, 7, 15, 24), (-2500.0, 800.0, 3100.0,
                                                -400.0),
                               (120.3, 400.8, 650.1, 900.6))]
    x, _ = simulate_capture(sats, num_epochs=60, seed=31)
    rx = Receiver(ReceiverConfig(prns=(2, 7, 15, 24)), device=dev)
    x_d = torch.as_tensor(x, device=dev)
    before = (engine.squared_prompts_cuda.launches,
              pretrack.pretrack_power_cuda.launches,
              engine.squared_prompts_plain.calls,
              pretrack._pretrack_power.calls)
    rx.acquire_all(x_d)
    n = len(profiling.spans)
    rx.start_tracking(x_d[10 * 2046:], start_epoch=10)
    after = (engine.squared_prompts_cuda.launches,
             pretrack.pretrack_power_cuda.launches,
             engine.squared_prompts_plain.calls,
             pretrack._pretrack_power.calls)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 0, 0]
    by = {r.name: r for r in list(profiling.spans)[n:]}
    assert by["pretrack.code"].counts.get("upload", 0) == 0
    assert len(rx.channels) == 4


# ------------------------------------------- page-locked windows (HostPages)

#: the real-IF front end (SoftGNSS): 38,192 int8 samples a millisecond
INT8_FS, INT8_IF, INT8_SPE = 38192000.0, 9548000.0, 38192


def _int8_capture(epochs, seed):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(epochs * INT8_SPE) * 8.0)
    return np.clip(x, -127, 127).astype(np.int8)


def _moved(before, *names):
    from stm32f4_sdr_gps_torch.utils import profiling

    return {k: profiling.counters.get(k, 0) - before.get(k, 0)
            for k in names}


def test_registered_window_baseband_equals_the_pageable_path(dev):
    """A 266 ms window of a capture three windows long crosses from
    page-locked memory and gives the pageable copy's baseband bit for
    bit; so does a pinned tensor of the same bytes."""
    from stm32f4_sdr_gps_torch.signal import capture as cap
    from stm32f4_sdr_gps_torch.utils import profiling

    capture = _int8_capture(3 * 266, 41)
    window = capture[266 * INT8_SPE: 532 * INT8_SPE]
    want = cap.if_to_baseband_device(window.copy(), INT8_FS, INT8_IF,
                                     device=dev)
    before = dict(profiling.counters)
    got = cap.if_to_baseband_device(window, INT8_FS, INT8_IF, device=dev)
    pinned = torch.from_numpy(window).pin_memory()
    got_pinned = cap.if_to_baseband_device(pinned, INT8_FS, INT8_IF,
                                           device=dev)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_pinned, want)
    assert _moved(before, "upload", "upload.registered", "upload.register",
                  "upload.register_failed") == {
        "upload": 2, "upload.registered": 2, "upload.register": 1,
        "upload.register_failed": 0}


def test_a_buffer_dropped_and_allocated_again_yields_its_new_bytes(dev):
    """Each round frees the last capture and fills a new one of the same
    size (the allocator tends to hand back the same address): the window
    uploaded is the new capture's, and every capture's registration is
    taken and released."""
    import gc

    from stm32f4_sdr_gps_torch.utils import device, profiling

    n, w = 64 * INT8_SPE, 16 * INT8_SPE
    before = dict(profiling.counters)
    owners = set(device.host_pages._owners)
    addresses = set()
    for k in range(6):
        capture = np.full(n, k - 3, np.int8)
        capture[w: 2 * w] = (np.arange(w) + k) % 251 - 125
        addresses.add(capture.ctypes.data)
        got = device.upload_window(capture[w: 2 * w], dev)
        assert torch.equal(got.cpu(), torch.from_numpy(capture[w: 2 * w]))
        del capture
        gc.collect()
    assert _moved(before, "upload.registered", "upload.register",
                  "upload.register_failed") == {
        "upload.registered": 6, "upload.register": 6,
        "upload.register_failed": 0}
    assert set(device.host_pages._owners) == owners
    print(f"{len(addresses)} addresses over 6 captures")


def test_a_refused_registration_leaves_no_error_behind(dev):
    """A capture registered already (here by the test, through the same
    libcuda call) is refused: its windows cross pageable with the right
    bytes, the refusal is counted once, and the next kernel launch and
    synchronise on the card succeed."""
    import gc

    from stm32f4_sdr_gps_torch.utils import device, profiling

    capture = _int8_capture(40, 43)
    owners = set(device.host_pages._owners)
    torch.ones(1, device=dev)
    assert device.host_pages.register(capture.ctypes.data,
                                      capture.nbytes) == 0
    try:
        before = dict(profiling.counters)
        for k in range(3):
            win = capture[k * 10 * INT8_SPE:(k + 1) * 10 * INT8_SPE]
            got = device.upload_window(win, dev)
            y = torch.ones(8, device=dev) * 2
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), torch.from_numpy(win))
            assert float(y.sum()) == 16.0
        assert _moved(before, "upload", "upload.registered",
                      "upload.register", "upload.register_failed") == {
            "upload": 3, "upload.registered": 0, "upload.register": 0,
            "upload.register_failed": 1}
    finally:
        assert device.host_pages.unregister(capture.ctypes.data) == 0
    del capture, win
    gc.collect()
    assert set(device.host_pages._owners) == owners


def test_host_iq_window_crosses_by_dma_and_hands_over_as_on_the_card(dev):
    """A cold start on a complex-IQ window that is a view into a capture
    held whole (the all-in-view cell's host ingest): its two crossings,
    the 10 acquisition epochs and the 32 of the Doppler search (687,456
    bytes), go by DMA from the registered capture, and the handoff is
    the one a window already on the card gives, bit for bit."""
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
    from stm32f4_sdr_gps_torch.utils import profiling

    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=q, cn0_dbhz=c)
            for p, d, q, c in ((3, -2310.0, 200.25, 45.0),
                               (5, 1120.0, 611.25, 48.0),
                               (8, 3470.0, 87.6, 50.0))]
    x, _ = simulate_capture(sats, num_epochs=120, seed=26)
    w = x[:60 * 2046]
    cfg = ReceiverConfig(prns=tuple(range(1, 9)))

    def start(window):
        rx = Receiver(cfg, device=dev)
        rx.acquire_all(window)
        rx.start_tracking(window[10 * 2046:], start_epoch=10)
        return rx

    before = dict(profiling.counters)
    host = start(w)
    torch.cuda.synchronize()
    moved = _moved(before, "upload.samples", "samples.bytes",
                   "upload.registered", "upload.register_failed")
    assert moved == {"upload.samples": 2, "samples.bytes": 687_456,
                     "upload.registered": 2, "upload.register_failed": 0}
    before = dict(profiling.counters)
    card = start(torch.as_tensor(w, device=dev))
    assert _moved(before, "upload.samples", "samples.bytes") == {
        "upload.samples": 0, "samples.bytes": 0}
    assert [c.prn for c in host.channels] == [c.prn for c in card.channels]
    assert len(host.channels) >= 3
    for f in ("doppler_hz", "code_phase_chips"):
        assert torch.equal(getattr(host.track_state, f),
                           getattr(card.track_state, f)), f
