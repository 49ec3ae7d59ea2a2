"""The port's correlation primitives against the JAX package's.

Inputs come from a numpy seed and go to both packages as numpy arrays.
Tolerance for sums over a 2046-sample epoch: rtol 1e-4 and atol 1e-3.  The
float32 sums run in another order in the two libraries; with unit-variance
terms the difference is about n * eps * |term| = 2046 * 6e-8 ~ 1e-4, and
a sum can sit near zero, where only an absolute bound means anything.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import BASEBAND_PLAN
from stm32f4_sdr_gps_tpu.ops import correlate as jcor
from stm32f4_sdr_gps_tpu.ops.pallas_epl import epl_correlate_pallas
from stm32f4_sdr_gps_tpu.ops.replica import sample_replicas as j_replicas
from stm32f4_sdr_gps_tpu.ops.wipeoff import carrier_wipeoff as j_wipeoff
from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations as j_rot
from stm32f4_sdr_gps_tpu.signal import ca_code as jca
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as T_PLAN
from stm32f4_sdr_gps_torch.ops import correlate as tcor
from stm32f4_sdr_gps_torch.ops.epl import (epl_correlate_halfchip,
                                           upsampled_code_doubled)
from stm32f4_sdr_gps_torch.ops.replica import sample_replicas
from stm32f4_sdr_gps_torch.ops.wipeoff import (carrier_wipeoff,
                                               doppler_rotations)
from stm32f4_sdr_gps_torch.signal import ca_code as tca

torch.set_num_threads(2)

S = BASEBAND_PLAN.samples_per_epoch
FS = BASEBAND_PLAN.sample_rate_hz
RTOL, ATOL = 1e-4, 1e-3


def _rand(seed=0, c=6):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(S) + 1j * rng.standard_normal(S)).astype(
        np.complex64)
    cp = rng.uniform(0, 1023, c).astype(np.float32)
    dop = rng.uniform(-5000, 5000, c).astype(np.float32)
    ph = rng.uniform(0, 1, c).astype(np.float32)
    return x, cp, dop, ph


def test_code_tables_match():
    prns = list(range(1, 33))
    np.testing.assert_array_equal(tca.ca_table_bipolar(prns),
                                  jca.ca_table_bipolar(prns))
    np.testing.assert_array_equal(tcor.sampled_code_table(prns, T_PLAN),
                                  jcor.sampled_code_table(prns, BASEBAND_PLAN))
    table = tca.ca_table_bipolar(prns)
    from stm32f4_sdr_gps_tpu.ops.pallas_epl import upsampled_code_doubled as ju
    np.testing.assert_array_equal(upsampled_code_doubled(table), ju(table))


def test_carrier_wipeoff_and_rotations_match():
    x, _, dop, ph = _rand(1)
    # jitted, as the JAX package runs it (XLA fuses the NCO multiply-add)
    y_j, end_j = jax.jit(j_wipeoff, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(dop), jnp.asarray(ph), FS)
    y_t, end_t = carrier_wipeoff(torch.as_tensor(x), torch.as_tensor(dop),
                                 torch.as_tensor(ph), FS)
    # unit-magnitude rotations of O(1) samples: elementwise, no sums
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_array_equal(end_t.numpy(), np.asarray(end_j))
    bins = np.arange(-7000, 7001, 500, dtype=np.float32)
    np.testing.assert_allclose(
        doppler_rotations(torch.as_tensor(bins), S, FS).numpy(),
        np.asarray(j_rot(jnp.asarray(bins), S, FS)), rtol=RTOL, atol=1e-5)


def test_sample_replicas_match_exactly():
    _, cp, dop, _ = _rand(2)
    table = tca.ca_table_bipolar([3, 5, 9, 11, 20, 31])
    freq = (np.float32(0.5) * (1 + dop / np.float32(1.57542e9))).astype(
        np.float32)
    lags = (-0.5, 0.0, 0.5)
    want = np.asarray(jax.jit(j_replicas, static_argnums=(3, 4))(
        jnp.asarray(table), jnp.asarray(cp), jnp.asarray(freq), S, lags))
    got = sample_replicas(torch.as_tensor(table), torch.as_tensor(cp),
                          torch.as_tensor(freq), S, lags).numpy()
    np.testing.assert_array_equal(got, want)


def test_epl_correlate_matches():
    x, cp, dop, ph = _rand(3)
    table = tca.ca_table_bipolar([3, 5, 9, 11, 20, 31])
    reps = tca.ca_table_bipolar([1, 2, 3, 4, 5, 6])[:, None, :].repeat(3, 1)
    reps = np.concatenate([reps, reps[:, :, :S - 1023]], axis=2)  # (C,3,S)
    y = np.tile(x, (6, 1))
    want = np.asarray(jcor.epl_correlate(jnp.asarray(y), jnp.asarray(reps)))
    got = tcor.epl_correlate(torch.as_tensor(y), torch.as_tensor(reps))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    del table, cp, dop, ph


def test_halfchip_epl_matches_jax_kernel():
    """The port's plain half-chip E/P/L vs the JAX Pallas kernel K2
    (interpret mode)."""
    x, cp, dop, ph = _rand(4)
    u2 = upsampled_code_doubled(tca.ca_table_bipolar([3, 5, 9, 11, 20, 31]))
    want = np.asarray(epl_correlate_pallas(
        jnp.asarray(x), jnp.asarray(u2), jnp.asarray(cp), jnp.asarray(dop),
        jnp.asarray(ph), FS, interpret=True))
    got = epl_correlate_halfchip(
        torch.as_tensor(x), torch.as_tensor(u2), torch.as_tensor(cp),
        torch.as_tensor(dop), torch.as_tensor(ph), FS).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_fft_circular_correlate_matches(batch):
    rng = np.random.default_rng(5)
    shape = batch + (S,)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64)
    prns = [1, 7, 19]
    want = np.asarray(jcor.fft_circular_correlate(
        jnp.asarray(x), jcor.code_fft_conj(prns, BASEBAND_PLAN)))
    got = tcor.fft_circular_correlate(
        torch.as_tensor(x),
        tcor.code_fft_conj(prns, T_PLAN, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tcor.noncoherent_power(torch.as_tensor(got)).numpy(),
        np.asarray(jcor.noncoherent_power(jnp.asarray(got))), rtol=1e-6)
