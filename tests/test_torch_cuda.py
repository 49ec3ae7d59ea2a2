"""The hand-written kernels on the card against their plain torch
versions: the tracking scan (K1), the per-epoch E/P/L correlator (K2), the
correlator-bank probe (P5) and the epoch-cost probes (P6-P8).

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
K2's sums: rtol 1e-4 / atol 1e-3 (tests/test_torch_epl.py says why).
P5's sums: 1e-4 of the largest (float32 sums over T steps of 2048-term
row sums, in other orders on the two sides).  P6-P8: each probe module's
``tolerance`` (its docstring says why), at the check size on the probe's
inputs and on seeded ones.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.config import (BASEBAND_PLAN, ReceiverConfig,
                                          TrackConfig)
from stm32f4_sdr_gps_torch.ops import epl
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
from stm32f4_sdr_gps_torch.probes import corr_bank as cb
from stm32f4_sdr_gps_torch.probes import (forest_chain, forest_constructs,
                                          forest_layout)
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
                    np.array([s.doppler_hz + 15.0 for s in sats]))
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
