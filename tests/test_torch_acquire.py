"""The port's acquisition and handoff against the JAX package's.

Capture: the 4-satellite compressed-bit capture of tests/test_receiver.py
(PRNs 2, 7, 15, 24 at 49 dBHz) searched for those PRNs plus two that are
absent (5, 30).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.acquire import engine as jeng
from stm32f4_sdr_gps_tpu.config import AcqConfig as JAcqConfig
from stm32f4_sdr_gps_tpu.config import BASEBAND_PLAN, TrackConfig as JTrack
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.pretrack import (
    refine_code_phase as j_refine_code_phase,
)
from stm32f4_sdr_gps_torch.acquire import engine as teng
from stm32f4_sdr_gps_torch.config import AcqConfig, TrackConfig
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as T_PLAN
from stm32f4_sdr_gps_torch.ops.correlate import code_fft_conj
from stm32f4_sdr_gps_torch.ops.wipeoff import doppler_rotations
from stm32f4_sdr_gps_torch.track.pretrack import refine_code_phase
from stm32f4_sdr_gps_torch.utils import profiling
from tests.test_receiver import PRNS, _make_capture

torch.set_num_threads(2)

SEARCH = PRNS + (5, 30)
S = BASEBAND_PLAN.samples_per_epoch


@pytest.fixture(scope="module")
def capture():
    x, _ = _make_capture(120, seed=11)
    return x


def _cp_dist(a, b):
    d = np.abs(np.asarray(a) - np.asarray(b)) % 1023.0
    return np.minimum(d, 1023.0 - d)


@pytest.mark.parametrize("hinted", [False, True])
def test_acquire_matches_jax(capture, hinted):
    hints = {7: 800.0, 30: 1000.0} if hinted else None
    want = jeng.acquire(capture, list(SEARCH), BASEBAND_PLAN, JAcqConfig(),
                        doppler_hints_hz=hints)
    got = teng.acquire(capture, list(SEARCH), T_PLAN, AcqConfig(),
                       doppler_hints_hz=hints, device="cpu")
    assert [r.detected for r in got] == [r.detected for r in want]
    assert [r.detected for r in got] == [True] * 4 + [False] * 2
    for g, w in zip(got, want):
        assert g.prn == w.prn
        if w.detected:
            assert _cp_dist(g.code_phase_chips, w.code_phase_chips) < 0.01
            assert abs(g.doppler_hz - w.doppler_hz) < 1.0
            assert g.peak_ratio == pytest.approx(w.peak_ratio, rel=1e-3)


def test_acquisition_power_coherent_matches_jax():
    """The non-coherent cube with 2-epoch coherent sums (inter-epoch
    Doppler phasor) on a small seeded input."""
    rng = np.random.default_rng(3)
    ep = (rng.standard_normal((4, S)) + 1j * rng.standard_normal((4, S))
          ).astype(np.complex64)
    bins = np.array([-500.0, 0.0, 1500.0], np.float32)
    prns = [4, 17]
    from stm32f4_sdr_gps_tpu.ops.correlate import code_fft_conj as j_cfc
    from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations as j_rot

    want = np.asarray(jeng.acquisition_power(
        jnp.asarray(ep), j_cfc(prns, BASEBAND_PLAN),
        j_rot(jnp.asarray(bins), S, BASEBAND_PLAN.sample_rate_hz),
        coherent=2))
    got = teng.acquisition_power(
        torch.as_tensor(ep), code_fft_conj(prns, T_PLAN, device="cpu"),
        doppler_rotations(torch.as_tensor(bins), S, T_PLAN.sample_rate_hz),
        coherent=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.max()))


def test_handoff_matches_jax(capture):
    """Fine Doppler (refine_doppler_device) within 0.5 Hz and pre-track
    code phase (refine_code_phase) within 0.05 chip of the JAX package,
    from the same coarse acquisition."""
    acq = jeng.acquire(capture, list(PRNS), BASEBAND_PLAN, JAcqConfig())
    table = ca_table_bipolar(PRNS)
    cp = np.array([r.code_phase_chips for r in acq])
    dop = np.array([r.doppler_hz for r in acq])
    ep = capture[: 32 * S].reshape(32, S)
    want = np.asarray(jeng.refine_doppler_device(
        jnp.asarray(ep), jnp.asarray(table), jnp.asarray(cp, jnp.float32),
        jnp.asarray(dop, jnp.float32), BASEBAND_PLAN))
    got = teng.refine_doppler_device(
        torch.as_tensor(ep), torch.as_tensor(table),
        torch.as_tensor(cp, dtype=torch.float32),
        torch.as_tensor(dop, dtype=torch.float32), T_PLAN).numpy()
    np.testing.assert_allclose(got, want, atol=0.5)
    fine = want.astype(np.float64)
    want_cp = j_refine_code_phase(capture, table, cp, fine, BASEBAND_PLAN,
                                  JTrack())
    got_cp = refine_code_phase(capture, table, cp, fine, T_PLAN,
                               TrackConfig(), device="cpu")
    assert _cp_dist(got_cp, want_cp).max() < 0.05


# ---------------------------------------------------------------- copies

SMALL = dict(doppler_span_hz=1000.0, noncoherent_epochs=4)


def _moved(run):
    """The counters ``run()`` moved (utils.profiling.counters)."""
    before = dict(profiling.counters)
    out = run()
    return out, {k: v - before.get(k, 0) for k, v in
                 profiling.counters.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("hinted", [False, True])
def test_acquire_reads_back_once(capture, hinted):
    """The (5, P) result of the cube's analysis comes back in one copy."""
    hints = {7: 800.0} if hinted else None
    _, moved = _moved(lambda: teng.acquire(
        torch.as_tensor(capture), list(SEARCH), T_PLAN, AcqConfig(),
        doppler_hints_hz=hints, device="cpu"))
    assert moved["readback"] == 1


@pytest.mark.parametrize("dft", [False, True], ids=["fft", "matmul_dft"])
def test_acquire_uploads_its_tables_once(capture, dft):
    """The configuration's tables are made once a process: a second call
    with the same PRNs, plan and grid uploads nothing but the samples;
    another PRN set uploads its codes (the matmul DFT's packed bits, or
    the sampled table of the FFT path) and reuses the grid."""
    cfg = AcqConfig(use_matmul_dft=dft, **SMALL)
    teng._code_spectra.cache_clear()
    teng._doppler_grid.cache_clear()

    def run(prns):
        return _moved(lambda: teng.acquire(capture, prns, T_PLAN, cfg,
                                           device="cpu"))

    first, moved = run(list(PRNS))
    assert moved["upload"] == 3 and moved["upload.samples"] == 1
    second, moved = run(list(PRNS))
    assert moved["upload"] == 1 and moved["upload.samples"] == 1
    assert second == first
    _, moved = run([5, 30])
    assert moved["upload"] == 2 and moved["upload.samples"] == 1


def test_analyze_power_tensor_equals_host(capture):
    """analyze_power on a tensor cube (the device analysis, one readback)
    gives the AcqResults of its numpy mirror on the same cube."""
    bins = np.asarray(AcqConfig().doppler_bins_hz, np.float32)
    power = teng.acquisition_power(
        torch.as_tensor(capture[: 10 * S].reshape(10, S)),
        code_fft_conj(list(SEARCH), T_PLAN, device="cpu"),
        doppler_rotations(torch.as_tensor(bins), S, T_PLAN.sample_rate_hz))
    got, moved = _moved(lambda: teng.analyze_power(
        power, list(SEARCH), bins, T_PLAN, AcqConfig()))
    want = teng.analyze_power(power.numpy(), list(SEARCH), bins, T_PLAN,
                              AcqConfig())
    assert moved == {"readback": 1}
    assert [r.detected for r in got] == [True] * 4 + [False] * 2
    for g, w in zip(got, want):
        assert (g.prn, g.detected) == (w.prn, w.detected)
        assert g.doppler_hz == w.doppler_hz
        assert g.code_phase_chips == w.code_phase_chips
        assert g.peak_power == w.peak_power
        assert g.peak_ratio == w.peak_ratio
        assert g.peak_to_mean == pytest.approx(w.peak_to_mean, rel=1e-6)
