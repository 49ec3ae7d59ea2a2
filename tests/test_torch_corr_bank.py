"""The correlator-bank probe (the JAX package's TPU probe P5) in the port,
on the CPU: both plain torch versions against a numpy statement of
tools/mxu_corr_probe.py:56-87 on the probe's own inputs
(default_rng(0), tools/mxu_corr_probe.py:107-116), at a small step count.

The JAX probe itself cannot run in a test: at import it arms SIGALRM,
compiles its kernel for the TPU and parses a profiler trace, so it is
restated here in numpy, in float64 on the same float32 (and, for the
mma variant, bf16-rounded) step inputs.

Tolerance, rtol 1e-5 and atol 1e-3 on the (C, 1) sums: the plain
versions add in float32 (the fma variant its 2048-term row sums too),
which leaves about sqrt(2048) * 6e-8 of a 2048-term sum of unit terms,
~3e-6 relative, per step; the mma variant's products of bf16 values are
exact in float64 on both sides.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.probes import corr_bank as cb

torch.set_num_threads(2)

STEPS = 6
RTOL, ATOL = 1e-5, 1e-3


def _bf16(a):
    """float32 rounded to the nearest bfloat16 (ties to even), as
    float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _statement(variant, yr, yi, rep, rep_t, mask, steps):
    """tools/mxu_corr_probe.py:56-87 over ``steps`` grid steps, in
    float64 on the float32 step inputs yr + float32(t) * 1e-9."""
    acc = np.zeros((yr.shape[0], 1))
    for t in range(steps):
        y = (yr + np.float32(t) * np.float32(1e-9)).astype(np.float64)
        if variant == "fma":
            tot = sum(np.sum(a * r.astype(np.float64), axis=1, keepdims=True)
                      for r in rep for a in (y, yi.astype(np.float64)))
        else:
            rt = rep_t.astype(np.float64)
            m1 = _bf16(y.astype(np.float32)).astype(np.float64) @ rt
            m2 = _bf16(yi).astype(np.float64) @ rt
            tot = (np.sum(m1 * mask, axis=1, keepdims=True)
                   + np.sum(m2 * mask, axis=1, keepdims=True))
        acc += tot
    return acc


def test_probe_inputs_are_the_probes():
    yr, yi, rep, rep_t, mask = cb.probe_inputs()
    assert yr.shape == yi.shape == (32, 2048) and rep.shape == (3, 32, 2048)
    assert rep_t.shape == (2048, 128) and mask.shape == (32, 128)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        yr, rng.standard_normal((32, 2048)).astype(np.float32))
    assert set(np.unique(rep_t)) == {-1.0, 1.0}
    np.testing.assert_array_equal(np.argmax(mask, 1), 3 * np.arange(32))
    assert mask.sum() == 32
    # +-1 replicas are exact in bf16
    np.testing.assert_array_equal(_bf16(rep_t), rep_t)


@pytest.mark.parametrize("variant", ["fma", "mma"])
def test_plain_version_matches_probe_statement(variant):
    arrays = cb.probe_inputs()
    want = _statement(variant, *arrays, STEPS)
    args = cb.device_inputs(torch.device("cpu"))[variant]
    got = cb.PLAIN[variant](*args, STEPS)
    assert got.shape == (32, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the fma variant's perturbation is live: step 1 differs from step 0;
    # in the mma variant bf16 rounding absorbs it (as in the TPU probe)
    one, two = (_statement(variant, *arrays, n) for n in (1, 2))
    assert np.array_equal(two, 2 * one) == (variant == "mma")


def test_bf16_rounding_matches_torch():
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    want = torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(_bf16(x), want)


@pytest.mark.parametrize("variant", ["fma", "mma"])
def test_kernel_wrappers_refuse_cpu_tensors(variant):
    args = cb.device_inputs(torch.device("cpu"))[variant]
    n0 = cb.KERNELS[variant].launches
    with pytest.raises(ValueError, match="CUDA"):
        cb.KERNELS[variant](*args, STEPS)
    assert cb.KERNELS[variant].launches == n0


def test_cli_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cb.main(["corr_bank", "fma", "10"]) == 1
    assert cb.main(["corr_bank", "bogus"]) == 2
