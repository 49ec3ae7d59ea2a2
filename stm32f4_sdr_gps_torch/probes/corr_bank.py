"""The E/P/L correlator bank as vector sums or as tensor-core products.

Counterpart of the JAX package's TPU probe P5,
``tools/mxu_corr_probe.py`` (``make_fn.kernel``): 32 channels of a
2048-sample epoch correlated T times, each step perturbing ``yr`` by
``t * 1e-9`` and adding a per-channel total into a (C, 1) float32 sum.

* ``fma``: six multiply-reduce sums against ``rep`` (3, C, SP) per step;
* ``mma``: two bf16 (C, SP) @ (SP, N) products against ``repT`` with
  float32 accumulation, then a row sum masked by ``mask`` (C, N).

Each has a hand-written Hopper kernel (``csrc/corr_bank.cu``) behind a
wrapper that counts its launches, and a plain torch version.  The mma
plain version rounds the same inputs to bf16 and forms the products in
float64, so it is the exact statement the kernel's float32 accumulators
approximate.

    python -m stm32f4_sdr_gps_torch.probes.corr_bank [fma|mma] [T]

prints the kernel's time per step from CUDA events (needs a CUDA device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .common import check_tensor, event_ms, stream

C, SP, N = 32, 2048, 128
MMA_SLICES = 32        # K slices of the mma kernel (csrc/corr_bank.cu NBLK)


def probe_inputs(seed: int = 0):
    """(yr, yi, rep, repT, mask) as numpy float32 arrays, drawn as
    tools/mxu_corr_probe.py:107-116 draws them; repT holds +-1, exact in
    bf16, and mask[c, 3c] = 1."""
    rng = np.random.default_rng(seed)
    yr = rng.standard_normal((C, SP)).astype(np.float32)
    yi = rng.standard_normal((C, SP)).astype(np.float32)
    rep = np.sign(rng.standard_normal((3, C, SP))).astype(np.float32)
    rep_t = np.sign(rng.standard_normal((SP, N))).astype(np.float32)
    mask = np.zeros((C, N), np.float32)
    mask[np.arange(C), 3 * np.arange(C)] = 1.0
    return yr, yi, rep, rep_t, mask


def _perturbation(t: int) -> float:
    """float32(t) * float32(1e-9), rounded to float32 as the kernels and
    the JAX probe compute it (exact as a float32 scalar operand)."""
    return float(np.float32(t) * np.float32(1e-9))


def corr_bank_fma_reference(yr, yi, rep, steps: int) -> torch.Tensor:
    """Plain torch version of the fma variant: (C, 1) float32."""
    acc = torch.zeros((yr.shape[0], 1), dtype=torch.float32, device=yr.device)
    for t in range(steps):
        y = yr + _perturbation(t)
        s = [(a * r).sum(1, keepdim=True)
             for r in rep for a in (y, yi)]
        acc = acc + (s[0] + s[1] + s[2] + s[3] + s[4] + s[5])
    return acc


def corr_bank_mma_reference(yr, yi, rep_t, mask, steps: int) -> torch.Tensor:
    """Plain torch version of the mma variant: the bf16-rounded inputs'
    products in float64, rounded to float32, then the masked row sums and
    the float32 sum over steps.  (C, 1) float32."""
    r = rep_t.to(torch.float64)
    bi = yi.to(torch.bfloat16).to(torch.float64)
    m2 = (bi @ r).to(torch.float32)
    acc = torch.zeros((yr.shape[0], 1), dtype=torch.float32, device=yr.device)
    for t in range(steps):
        a = (yr + _perturbation(t)).to(torch.bfloat16).to(torch.float64)
        m1 = (a @ r).to(torch.float32)
        acc = acc + ((m1 * mask).sum(1, keepdim=True)
                     + (m2 * mask).sum(1, keepdim=True))
    return acc


def corr_bank_fma_cuda(yr, yi, rep, steps: int) -> torch.Tensor:
    """Launch the fma kernel (csrc/corr_bank.cu): yr, yi (C, 2048) and
    rep (3, C, 2048) float32 on the card.  ``launches`` counts them."""
    from ..ops.kernel_lib import corr_bank_lib

    if not yr.is_cuda:
        raise ValueError("corr_bank_fma_cuda needs CUDA tensors")
    c = yr.shape[0]
    for name, t, shape in (("yr", yr, (c, SP)), ("yi", yi, (c, SP)),
                           ("rep", rep, (3, c, SP))):
        check_tensor(name, t, shape, torch.float32, yr.device)
    out = torch.empty((c, 1), dtype=torch.float32, device=yr.device)
    if c == 0:
        return out
    lib = corr_bank_lib()
    with torch.cuda.device(yr.device):
        rc = lib.corr_bank_fma_launch(yr.data_ptr(), yi.data_ptr(),
                                      rep.data_ptr(), out.data_ptr(), c,
                                      steps, stream(yr.device))
    if rc != 0:
        raise RuntimeError(f"corr_bank fma launch failed: CUDA error {rc}")
    corr_bank_fma_cuda.launches += 1
    return out


corr_bank_fma_cuda.launches = 0


def corr_bank_mma_cuda(yr, yi, rep_t, mask, steps: int) -> torch.Tensor:
    """Launch the mma kernel (csrc/corr_bank.cu): yr, yi (32, 2048)
    float32, repT (2048, 128) bfloat16 and mask (32, 128) float32 on the
    card.  ``launches`` counts them."""
    from ..ops.kernel_lib import corr_bank_lib

    if not yr.is_cuda:
        raise ValueError("corr_bank_mma_cuda needs CUDA tensors")
    for name, t, shape, dtype in (
            ("yr", yr, (C, SP), torch.float32),
            ("yi", yi, (C, SP), torch.float32),
            ("repT", rep_t, (SP, N), torch.bfloat16),
            ("mask", mask, (C, N), torch.float32)):
        check_tensor(name, t, shape, dtype, yr.device)
    if rep_t.data_ptr() % 32:
        raise ValueError("repT must be 32-byte aligned (wmma loads)")
    out = torch.empty((C, 1), dtype=torch.float32, device=yr.device)
    partial = torch.empty((MMA_SLICES, C), dtype=torch.float32,
                          device=yr.device)
    lib = corr_bank_lib()
    with torch.cuda.device(yr.device):
        rc = lib.corr_bank_mma_launch(
            yr.data_ptr(), yi.data_ptr(), rep_t.data_ptr(), mask.data_ptr(),
            out.data_ptr(), partial.data_ptr(), C, steps,
            stream(yr.device))
    if rc != 0:
        raise RuntimeError(f"corr_bank mma launch failed: CUDA error {rc}")
    corr_bank_mma_cuda.launches += 1
    return out


corr_bank_mma_cuda.launches = 0


def device_inputs(device, seed: int = 0) -> dict:
    """The probe's inputs as tensors on ``device``, keyed by variant: the
    arguments of each kernel wrapper and plain version before ``steps``."""
    yr, yi, rep, rep_t, mask = (torch.as_tensor(a, device=device)
                                for a in probe_inputs(seed))
    return {"fma": (yr, yi, rep),
            "mma": (yr, yi, rep_t.to(torch.bfloat16), mask)}


KERNELS = {"fma": corr_bank_fma_cuda, "mma": corr_bank_mma_cuda}
PLAIN = {"fma": corr_bank_fma_reference, "mma": corr_bank_mma_reference}


def ns_per_step(variant: str, args: tuple, steps: int, reps: int = 5) -> float:
    """Median over ``reps`` launches of the kernel's CUDA-event time, per
    step, in nanoseconds (after one warm-up launch)."""
    fn = KERNELS[variant]
    return event_ms(lambda: fn(*args, steps), reps) * 1e6 / steps


def run(variant: str, steps: int) -> float:
    """The probe on the card: one variant on the probe's inputs, its
    time per step printed and returned (ns)."""
    args = device_inputs(torch.device("cuda"))[variant]
    ns = ns_per_step(variant, args, steps)
    print(f"{variant}: C={C} SP={SP} N={N} T={steps} on "
          f"{torch.cuda.get_device_name(0)}: {ns:.1f} ns/step")
    return ns


def main(argv) -> int:
    variant = argv[1] if len(argv) > 1 else "fma"
    steps = int(argv[2]) if len(argv) > 2 else 1600
    if variant not in KERNELS:
        print(f"usage: {argv[0]} [fma|mma] [T]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("corr_bank: needs a CUDA device", file=sys.stderr)
        return 1
    run(variant, steps)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
