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
approximate.  :func:`library_call` is each variant's yardstick: every
step's products in one torch call.

    python -m stm32f4_sdr_gps_torch.probes.corr_bank [fma|mma] [T]

prints the kernel's device time per step (CUDA events around launches
queued behind a device sleep; needs a CUDA device): a launch's time over
its T steps, which the kernel runs side by side, so a throughput
comparable with the one-call yardstick.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .common import SLEEP_CYCLES, check_tensor, queued_ms, stream, warm_up

C, SP, N = 32, 2048, 128
FMA_SPLIT = 8          # blocks a channel of the fma kernel (csrc/corr_bank.cu)
MMA_CTAS = 128         # K slices of 16, one CTA each, of the mma kernel
MMA_ROWS = 2 * C       # the mma kernel's A: yr_t rows over yi rows


def scratch_shape(variant: str, c: int = C) -> tuple:
    """The float32 scratch a variant's kernel writes its partial sums to
    at ``c`` channels: fma (C, FMA_SPLIT), one per channel and block; mma
    (MMA_CTAS, MMA_ROWS), one per CTA and stacked row."""
    return (c, FMA_SPLIT) if variant == "fma" else (MMA_CTAS, MMA_ROWS)


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


def _check_steps(steps) -> None:
    if not isinstance(steps, int) or steps < 0:
        raise ValueError(f"steps: want an int >= 0, got {steps!r}")


def corr_bank_fma_cuda(yr, yi, rep, steps: int) -> torch.Tensor:
    """Launch the fma kernel (csrc/corr_bank.cu): yr, yi (C, 2048) and
    rep (3, C, 2048) float32 on the card.  The arguments are checked
    before the device, so the checks also run on CPU tensors, which the
    wrapper then refuses.  ``launches`` counts the launches."""
    from ..ops.kernel_lib import corr_bank_lib

    c = yr.shape[0]
    for name, t, shape in (("yr", yr, (c, SP)), ("yi", yi, (c, SP)),
                           ("rep", rep, (3, c, SP))):
        check_tensor(name, t, shape, torch.float32, yr.device)
    _check_steps(steps)
    if not yr.is_cuda:
        raise ValueError("corr_bank_fma_cuda needs CUDA tensors")
    out = torch.empty((c, 1), dtype=torch.float32, device=yr.device)
    if c == 0:
        return out
    partial = torch.empty(scratch_shape("fma", c), dtype=torch.float32,
                          device=yr.device)
    lib = corr_bank_lib()
    with torch.cuda.device(yr.device):
        rc = lib.corr_bank_fma_launch(yr.data_ptr(), yi.data_ptr(),
                                      rep.data_ptr(), out.data_ptr(),
                                      partial.data_ptr(), c, steps,
                                      stream(yr.device))
    if rc != 0:
        raise RuntimeError(f"corr_bank fma launch failed: CUDA error {rc}")
    corr_bank_fma_cuda.launches += 1
    return out


corr_bank_fma_cuda.launches = 0


def corr_bank_mma_cuda(yr, yi, rep_t, mask, steps: int) -> torch.Tensor:
    """Launch the mma kernel (csrc/corr_bank.cu): yr, yi (32, 2048)
    float32 and 8-byte aligned, repT (2048, 128) bfloat16 and mask
    (32, 128) float32 on the card.  Checked as the fma wrapper checks;
    ``launches`` counts the launches."""
    from ..ops.kernel_lib import corr_bank_lib

    for name, t, shape, dtype in (
            ("yr", yr, (C, SP), torch.float32),
            ("yi", yi, (C, SP), torch.float32),
            ("repT", rep_t, (SP, N), torch.bfloat16),
            ("mask", mask, (C, N), torch.float32)):
        check_tensor(name, t, shape, dtype, yr.device)
    for name, t in (("yr", yr), ("yi", yi)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (float2 loads)")
    _check_steps(steps)
    if not yr.is_cuda:
        raise ValueError("corr_bank_mma_cuda needs CUDA tensors")
    out = torch.empty((C, 1), dtype=torch.float32, device=yr.device)
    partial = torch.empty(scratch_shape("mma"), dtype=torch.float32,
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


def _stacked_steps(yr, yi, steps: int) -> torch.Tensor:
    """(2, T, C, SP) float32: every step's perturbed yr_t over yi."""
    pert = torch.tensor([_perturbation(t) for t in range(steps)],
                        dtype=torch.float32, device=yr.device)
    return torch.stack([yr[None] + pert[:, None, None],
                        yi[None].expand(steps, -1, -1)])


def library_call(variant: str, args: tuple, steps: int):
    """The yardstick: a function of no arguments that forms every step's
    products of ``variant`` in one torch call, on inputs stacked here,
    outside the timed call.  ``args`` are the kernel's (``device_inputs``).

    * ``fma``: one float32 ``torch.bmm`` of each channel's (2T, SP) rows,
      yr_t and yi for every step, with its (SP, 3) replica rows, giving
      (C, 2T, 3): all six sums of every step.  TF32 is switched off for
      it (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
      default), so the products stay float32.
    * ``mma``: one bf16 ``torch.matmul`` of the (2 T C, SP) stacked rows,
      yr_t and yi for every step (the kernel's work), with repT, giving
      the (2 T C, N) products in bf16.
    * ``mma_yr``: the same over the yr_t rows alone, (T C, N): half the
      work."""
    if variant == "fma":
        yr, yi, rep = args
        torch.backends.cuda.matmul.allow_tf32 = False
        y_all = _stacked_steps(yr, yi, steps).permute(2, 1, 0, 3).reshape(
            yr.shape[0], 2 * steps, SP).contiguous()        # (C, 2T, SP)
        rep_t = rep.permute(1, 2, 0).contiguous()           # (C, SP, 3)
        return lambda: torch.bmm(y_all, rep_t)
    yr, yi, rep_t, _ = args
    stacked = _stacked_steps(yr, yi, steps).to(torch.bfloat16)
    if variant == "mma_yr":
        stacked = stacked[0]
    a_all = stacked.reshape(-1, SP).contiguous()
    return lambda: torch.matmul(a_all, rep_t)


LIBRARY = ("fma", "mma", "mma_yr")


def library_totals(variant: str, result: torch.Tensor, mask=None,
                   steps: int = 0) -> torch.Tensor:
    """A yardstick's result reduced to the probe's (C, 1) output: the
    fma sums added over steps and lags; the mma rows masked, row-summed
    and added over steps and products, in float64."""
    r = result.to(torch.float64)
    if variant == "fma":
        return r.sum((1, 2))[:, None]
    r = r.reshape(-1, steps, C, N) * mask.to(torch.float64)
    return r.sum((0, 1, 3))[:, None]


def ns_per_step(variant: str, args: tuple, steps: int, reps: int = 5) -> float:
    """The kernel's device time per step in nanoseconds: the median over
    ``reps`` of 10 launches queued behind a device sleep (after a warm-up),
    per launch, over its ``steps``.  A launch runs its steps side by side,
    so this is a throughput."""
    fn = KERNELS[variant]
    warm_up(lambda: fn(*args, steps))
    return queued_ms(lambda: fn(*args, steps), reps, 10,
                     SLEEP_CYCLES) * 1e6 / steps


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
