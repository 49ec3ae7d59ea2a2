"""The port's acquisition modes against the JAX package's: bit-edge
hypotheses, the deep and full-bit presets, the matmul DFT (and its bf16
detection equivalence), the epoch-voting detector, the host fine-Doppler
search, the host and device peak analysis, and the presets themselves.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu import config as jcfg
from stm32f4_sdr_gps_tpu.acquire import engine as jeng
from stm32f4_sdr_gps_tpu.ops import correlate as jcorr
from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations as j_rot
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch import config as tcfg
from stm32f4_sdr_gps_torch.acquire import engine as teng
from stm32f4_sdr_gps_torch.ops import correlate as tcorr
from stm32f4_sdr_gps_torch.ops.wipeoff import doppler_rotations as t_rot
from tests.test_receiver import PRNS, _make_capture

torch.set_num_threads(2)

PLAN = jcfg.BASEBAND_PLAN
T_PLAN = tcfg.BASEBAND_PLAN
S = PLAN.samples_per_epoch
PRESETS = ("DEEP_ACQ", "ULTRA_ACQ", "WEAK_SIGNAL_TRACK", "COHERENT_TRACK",
           "DEEP_COHERENT_TRACK")
JAX_ONLY = ("pallas_interpret", "ablate")


def _cp_dist(a, b):
    d = abs(a - b) % 1023.0
    return min(d, 1023.0 - d)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    want = dataclasses.asdict(getattr(jcfg, name))
    got = dataclasses.asdict(getattr(tcfg, name))
    for k in JAX_ONLY:
        want.pop(k, None)
    assert got == want


def _seeded_cube_inputs(e, d_bins, prns, seed):
    rng = np.random.default_rng(seed)
    ep = (rng.standard_normal((e, S)) + 1j * rng.standard_normal((e, S))
          ).astype(np.complex64)
    bins = np.linspace(-700.0, 900.0, d_bins).astype(np.float32)
    j_in = (jnp.asarray(ep), jcorr.code_fft_conj(prns, PLAN),
            j_rot(jnp.asarray(bins), S, PLAN.sample_rate_hz))
    t_in = (torch.as_tensor(ep), tcorr.code_fft_conj(prns, T_PLAN,
                                                     device="cpu"),
            t_rot(torch.as_tensor(bins), S, T_PLAN.sample_rate_hz))
    return j_in, t_in


@pytest.mark.parametrize("coherent,n_hyp", [(4, 3), (5, 5), (3, 1)])
def test_acquisition_power_hypotheses_matches_jax(coherent, n_hyp):
    """Max-combined per-block-normalized power over the block-grid
    offsets, within 1e-4 of the cube's peak."""
    j_in, t_in = _seeded_cube_inputs(13, 3, [4, 17], seed=coherent)
    want = np.asarray(jeng.acquisition_power_hypotheses(
        *j_in, coherent=coherent, n_hyp=n_hyp))
    got = teng.acquisition_power_hypotheses(
        *t_in, coherent=coherent, n_hyp=n_hyp).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(want.max()))


def test_matmul_dft_cube_matches_jax():
    """The matmul-DFT cube (float32 products on the CPU in both packages,
    the code spectrum by the matmul DFT from the bit-packed table) within
    1e-3 of the peak of the JAX package's, and within 1e-3 of the port's
    FFT cube."""
    prns = [4, 17]
    j_in, t_in = _seeded_cube_inputs(4, 3, prns, seed=8)
    packed = jcorr.pack_code_bits(prns, PLAN)
    np.testing.assert_array_equal(tcorr.pack_code_bits(prns, T_PLAN), packed)
    jdft = jcorr.dft_tables_device(S)
    tdft = tcorr.dft_tables_device(S, device="cpu")
    jcfc = jcorr.code_spectrum_conj_matmul(
        jcorr.unpack_code_table(jnp.asarray(packed), S), *jdft)
    tcfc = tcorr.code_spectrum_conj_matmul(
        tcorr.unpack_code_table(torch.as_tensor(packed), S), *tdft)
    want = np.asarray(jeng.acquisition_power(j_in[0], jcfc, j_in[2],
                                             coherent=2, dft=jdft))
    got = teng.acquisition_power(t_in[0], tcfc, t_in[2], coherent=2,
                                 dft=tdft).numpy()
    peak = float(want.max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * peak)
    fft = teng.acquisition_power(*t_in, coherent=2).numpy()
    np.testing.assert_allclose(got, fft, rtol=0, atol=1e-3 * peak)


def test_tf32_reader_sees_both_switches():
    """The "highest" product's guard reads TF32 from either of torch's
    switches, also once the newer one has made the older unreadable; the
    setting is restored after."""
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    try:
        assert not tcorr.tf32_matmul_on()
        for switch, on in ((("fp32_precision", "tf32"), True),
                           (("fp32_precision", "ieee"), False),
                           (("allow_tf32", True), True),
                           (("allow_tf32", False), False)):
            setattr(m, *switch)
            assert tcorr.tf32_matmul_on() is on, switch
        torch.set_float32_matmul_precision("high")
        assert tcorr.tf32_matmul_on()
        torch.set_float32_matmul_precision("highest")
        assert not tcorr.tf32_matmul_on()
    finally:
        m.fp32_precision = prev


def _bf16_products(a, b, precision="highest"):
    """The card's "default" DFT product on the CPU: bf16 inputs, float32
    accumulation and result (torch.mm(..., out_dtype=torch.float32))."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).to(torch.bfloat16).to(torch.float32)
    out = a2 @ b.to(torch.bfloat16).to(torch.float32)
    return out.reshape(*lead, b.shape[-1])


def test_bf16_dft_precision_detection_equivalence(monkeypatch):
    """tests/test_acquisition.py:145 in the port: with the card's bf16
    product emulated, detection, Doppler (2 Hz), code phase (0.01 chip),
    peak ratio and peak-to-mean (2 %) agree with float32 at 45 dBHz with
    the default grid and at 31 dBHz with DEEP_ACQ."""
    s = S
    table = tcorr.unpack_code_table(
        torch.as_tensor(tcorr.pack_code_bits([9], T_PLAN)), s)
    wc, ws = tcorr.dft_tables_device(s, device="cpu")
    cfc = tcorr.code_spectrum_conj_matmul(table, wc, ws)
    for cn0, acq in ((45.0, tcfg.AcqConfig()), (31.0, tcfg.DEEP_ACQ)):
        sat = SimSat(prn=9, doppler_hz=1830.0, code_phase_chips=411.25,
                     cn0_dbhz=cn0, codes_in_bit=20, nav_bits=[0, 1] * 40)
        e = max(acq.noncoherent_epochs, 10)
        co = acq.coherent_epochs
        x, _ = simulate_capture([sat], num_epochs=e, seed=3)
        epochs = torch.as_tensor(x.reshape(e, s))
        bins = np.asarray(acq.doppler_bins_hz, np.float32)
        rot = t_rot(torch.as_tensor(bins), s, T_PLAN.sample_rate_hz)
        res = {}
        for name in ("f32", "bf16"):
            if name == "bf16":
                monkeypatch.setattr(tcorr, "dft_matmul", _bf16_products)
            p = teng.acquisition_power(epochs[: (e // co) * co], cfc, rot,
                                       coherent=co, dft=(wc, ws))
            res[name] = teng.analyze_power(p, [9], bins, T_PLAN, acq)[0]
        monkeypatch.undo()
        a, b = res["f32"], res["bf16"]
        assert a.detected and b.detected, cn0
        assert abs(a.doppler_hz - b.doppler_hz) < 2.0, cn0
        assert _cp_dist(a.code_phase_chips, b.code_phase_chips) < 0.01, cn0
        assert abs(a.peak_ratio - b.peak_ratio) < 0.02 * a.peak_ratio, cn0
        assert abs(a.peak_to_mean - b.peak_to_mean) \
            < 0.02 * a.peak_to_mean, cn0


def _weak_capture():
    """Two satellites with real 20 ms bits (a bit flip every other bit),
    Dopplers inside a narrowed grid, plus PRN 30 absent."""
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=cp, cn0_dbhz=44.0,
                   codes_in_bit=20, nav_bits=[0, 1, 1, 0] * 4)
            for p, d, cp in ((4, 150.0, 311.4), (21, -210.0, 802.9))]
    x, _ = simulate_capture(sats, num_epochs=130, seed=6)
    return x, [4, 21, 30]


@pytest.mark.parametrize("mode", ["DEEP_ACQ", "ULTRA_ACQ", "matmul_dft"])
def test_acquire_modes_match_jax(mode):
    """acquire() under the deep presets (ULTRA_ACQ's span narrowed to
    +/-300 Hz to keep its 20-epoch cubes small on the CPU; DEEP_ACQ's to
    +/-1 kHz) and on the matmul-DFT path: the same detections, Doppler
    within 1 Hz (the same bin), code phase within 0.05 chip."""
    x, prns = _weak_capture()
    if mode == "matmul_dft":
        kw = dict(doppler_span_hz=1000.0, use_matmul_dft=True)
        jc, tc = jcfg.AcqConfig(**kw), tcfg.AcqConfig(**kw)
    else:
        span = 300.0 if mode == "ULTRA_ACQ" else 1000.0
        jc = dataclasses.replace(getattr(jcfg, mode), doppler_span_hz=span)
        tc = dataclasses.replace(getattr(tcfg, mode), doppler_span_hz=span)
    want = jeng.acquire(x, prns, PLAN, jc)
    got = teng.acquire(x, prns, T_PLAN, tc, device="cpu")
    assert [r.detected for r in got] == [r.detected for r in want]
    assert [r.detected for r in got] == [True, True, False]
    for g, w in zip(got, want):
        if w.detected:
            assert abs(g.doppler_hz - w.doppler_hz) < 1.0, (mode, g, w)
            assert _cp_dist(g.code_phase_chips, w.code_phase_chips) < 0.05
            assert g.peak_ratio == pytest.approx(w.peak_ratio, rel=1e-3)


def test_acquire_epoch_vote_matches_jax():
    """The epoch-voting detector on the 4-satellite capture plus two
    absent PRNs: the same detections, Doppler bins and lag cells."""
    x, _ = _make_capture(120, seed=11)
    prns = list(PRNS) + [5, 30]
    want = jeng.acquire_epoch_vote(x, prns, PLAN, jcfg.AcqConfig())
    got = teng.acquire_epoch_vote(x, prns, T_PLAN, tcfg.AcqConfig(),
                                  device="cpu")
    assert [r.detected for r in got] == [r.detected for r in want]
    assert any(r.detected for r in got) and not all(r.detected for r in got)
    for g, w in zip(got, want):
        assert g.prn == w.prn
        assert g.doppler_hz == w.doppler_hz
        assert g.code_phase_chips == w.code_phase_chips
        assert g.peak_ratio == w.peak_ratio


def test_refine_doppler_host_matches_jax():
    """The per-channel host fine-Doppler search: the same FFT bin as the
    JAX package's, so the same frequency."""
    prns, true_dop = [4, 9], [1234.0, -2650.0]
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=50.0 * i,
                   cn0_dbhz=40.0, codes_in_bit=20, nav_bits=[1, 0] * 20)
            for i, (p, d) in enumerate(zip(prns, true_dop))]
    x, _ = simulate_capture(sats, num_epochs=128, seed=7)
    for i, (prn, coarse) in enumerate(zip(prns, (1200.0, -2600.0))):
        for n in (32, 128):
            want = jeng.refine_doppler(x, prn, 50.0 * i, coarse, PLAN,
                                       num_epochs=n)
            got = teng.refine_doppler(x, prn, 50.0 * i, coarse, T_PLAN,
                                      num_epochs=n, device="cpu")
            assert got == pytest.approx(want, abs=1e-9), (prn, n)
        assert abs(got - true_dop[i]) < 4.0


def _planted_cube(seed):
    rng = np.random.default_rng(seed)
    p = rng.exponential(1.0, (3, 7, S)).astype(np.float32)
    for i, (d, lag) in enumerate(((2, 100), (0, 2045), (6, 7))):
        p[i, d, lag] += 40.0
        p[i, d, (lag + 1) % S] += 15.0
        p[i, min(d + 1, 6), lag] += 10.0
    return p


@pytest.mark.parametrize("hints", [None, {4: 500.0, 9: -1000.0}])
def test_analyze_power_host_and_device_match_jax(hints):
    """analyze_power on a numpy cube (host path) and on a tensor (device
    path) against the JAX package's host and device paths, with and
    without Doppler hints applied first (apply_doppler_hints)."""
    cfg_j, cfg_t = jcfg.AcqConfig(), tcfg.AcqConfig()
    prns = [4, 9, 30]
    bins = np.linspace(-1500.0, 1500.0, 7).astype(np.float32)
    cube = _planted_cube(3)
    j_np = jeng.apply_doppler_hints(cube, prns, bins, hints, cfg_j)
    t_np = teng.apply_doppler_hints(cube, prns, bins, hints, cfg_t)
    t_dev = teng.apply_doppler_hints(torch.as_tensor(cube), prns, bins,
                                     hints, cfg_t)
    j_dev = jeng.apply_doppler_hints(jnp.asarray(cube), prns, bins, hints,
                                     cfg_j)
    np.testing.assert_array_equal(t_np, j_np)
    np.testing.assert_array_equal(t_dev.numpy(), np.asarray(j_dev))
    want_h = jeng.analyze_power(j_np, prns, bins, PLAN, cfg_j)
    want_d = jeng.analyze_power(j_dev, prns, bins, PLAN, cfg_j)
    got_h = teng.analyze_power(t_np, prns, bins, T_PLAN, cfg_t)
    got_d = teng.analyze_power(t_dev, prns, bins, T_PLAN, cfg_t)
    for got, want in ((got_h, want_h), (got_d, want_d), (got_d, want_h)):
        for g, w in zip(got, want):
            assert (g.prn, g.detected) == (w.prn, w.detected)
            assert g.doppler_hz == pytest.approx(w.doppler_hz, abs=1e-3)
            assert _cp_dist(g.code_phase_chips, w.code_phase_chips) < 1e-4
            assert g.peak_ratio == pytest.approx(w.peak_ratio, rel=1e-5)
            assert g.peak_to_mean == pytest.approx(w.peak_to_mean, rel=1e-5)
