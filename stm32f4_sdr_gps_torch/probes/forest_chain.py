"""Dependent chains of tiny ops: the epoch-cost probe P6 on the card.

Counterpart of the JAX package's TPU probe P6, ``tools/forest_probe.py``
(``build.kernel``): G sequential steps of 8 iterations, each running K
dependent op pairs on every element of a float32 state, then the final
state.  Eleven variants (``VARIANTS``), by op and by the rows each channel
carries as independent chains:

* ``fma``: ``a = a*1.000001 + b; b = b*0.999999 + a``, each one rounding
  (``fmaf`` in the kernel; the JAX reference's XLA lowering fuses them);
* ``sel``: a compare and two selects, ``b``'s update taking the new ``a``;
* ``int``: int32 ``min``/``xor``/``max``/add with wrap-around, converted
  from and back to float32 once per iteration;
* rows: 1 for ``c1`` (state (2, C, 1)) and ``lc`` ((2, 1, C)), 4 for
  ``k4``, 8 for ``fc``, 16 for ``kc``; ``ilp`` runs 4 chains of K/4 pairs
  on an (8, C, 1) state whose planes interleave a and b.

On the TPU ``c1`` and ``lc`` differed in layout only (sublanes against
lanes).  On the card both are one chain per thread and run the same code:
they give the same numbers in different shapes, and both names stay.

The kernel (``csrc/forest.cu``, ``chain_kernel``) runs one thread per
channel with its rows in registers and the G x 8 loop inside the launch.
The plain torch version forms each fused step in float64 and rounds it to
float32, which is the fused result except for a rare double rounding.

The probe's own inputs (all 0.5) overflow: the fma chains grow about 2.6x
per pair and every element is inf after about 93 pairs, so at the
probe's size (65,536 pairs) all five fma variants return inf.  Kernel and
plain version are therefore compared at the check size (G = 2, K = 4: 64
pairs, about 3e26) on those inputs and on seeded ones; the probe's size
is for timing.

    python -m stm32f4_sdr_gps_torch.probes.forest_chain [variant|all] [C] [K] [G]

prints the kernel's ns per iteration and per op pair (needs a CUDA
device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.wipeoff import fma
from .common import (SLEEP_CYCLES, check_tensor, queued_ms, stream,
                     warm_up)

C, K, G = 32, 64, 128          # the probe's size (forest_probe.py:53-55)
CHECK_K, CHECK_G = 4, 2        # the size at which kernel and plain compare
CHECK_SEED = 3
ITERS = 8
VARIANTS = ["c1_fma", "lc_fma", "fc_fma", "ilp_fma",
            "c1_sel", "lc_sel", "c1_int", "lc_int",
            "kc_fma", "k4_fma", "kc_sel"]
_A, _B = float(np.float32(1.000001)), float(np.float32(0.999999))


def state_shape(variant: str, c: int = C) -> tuple:
    """The variant's state shape (forest_probe.py:61-74)."""
    return {"c1": (2, c, 1), "lc": (2, 1, c), "fc": (2, 8, c),
            "kc": (2, 16, c, 1), "k4": (2, 4, c, 1),
            "ilp": (8, c, 1)}[variant.split("_")[0]]


def channels(variant: str, shape) -> int:
    """C of a state shape of this variant."""
    return shape[1] if variant.split("_")[0] in ("c1", "ilp") else shape[2]


def probe_inputs(variant: str, c: int = C) -> np.ndarray:
    """The probe's state: ``ones * 0.5`` (forest_probe.py:138)."""
    return np.full(state_shape(variant, c), 0.5, np.float32)


def check_inputs(variant: str, seed: int, c: int = C) -> np.ndarray:
    """A seeded state away from the chains' fixed points: uniform in
    [-4, 4), so that the int variants' truncation gives -3..3 and the
    selects take both branches."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-4.0, 4.0, state_shape(variant, c)).astype(np.float32)


def check_args(variant: str, which: str, device="cpu", c: int = C) -> tuple:
    """The wrapper's (and the plain version's) arguments at the check
    size, on the probe's inputs (``which="probe"``) or the seeded ones."""
    x = (probe_inputs(variant, c) if which == "probe"
         else check_inputs(variant, CHECK_SEED, c))
    return torch.as_tensor(x, device=device), variant, CHECK_K, CHECK_G


def tolerance(variant: str) -> tuple:
    """(rtol, atol) of the kernel against the plain version: rtol 1e-5 for
    the fused steps (the plain version rounds a float64 result once, a
    rare double rounding apart from fmaf), exact for selects and int ops."""
    return (1e-5, 0.0) if variant.endswith("fma") else (0.0, 0.0)


def _chains(x: torch.Tensor, variant: str):
    """(a, b) views of the state: the ilp variant's chain j is planes 2j
    and 2j + 1; every other variant's a is plane 0 and b plane 1."""
    if variant.startswith("ilp"):
        return x[0::2], x[1::2]
    return x[0], x[1]


def chain_reference(x: torch.Tensor, variant: str, k: int = K,
                    g: int = G) -> torch.Tensor:
    """Plain torch version of P6: the final state, of x's shape."""
    op = variant.split("_")[1]
    pairs = k // 4 if variant.startswith("ilp") else k
    out = x.clone()
    a, b = (t.clone() for t in _chains(out, variant))
    for _ in range(g * ITERS):
        if op == "int":
            ai, bi = a.to(torch.int32), b.to(torch.int32)
            for _ in range(pairs):
                ai = torch.clamp(ai + 1, max=1000) ^ bi
                bi = torch.clamp(bi - 1, min=-1000) + ai
            a, b = ai.to(torch.float32), bi.to(torch.float32)
        elif op == "sel":
            for _ in range(pairs):
                m = a > b
                a = torch.where(m, a * 0.5 + b, b - a)
                b = torch.where(m, b, b * 0.5 + a)
        else:
            for _ in range(pairs):
                a = fma(a, _A, b)
                b = fma(b, _B, a)
    oa, ob = _chains(out, variant)
    oa.copy_(a)
    ob.copy_(b)
    return out


def _checked(x: torch.Tensor, variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown P6 variant {variant!r}")
    c = channels(variant, x.shape)
    check_tensor("x", x, state_shape(variant, c), torch.float32, x.device)
    return c


def chain_cuda(x: torch.Tensor, variant: str, k: int = K,
               g: int = G) -> torch.Tensor:
    """Launch P6's kernel (csrc/forest.cu) on a CUDA state of the
    variant's shape.  ``launches`` counts the launches."""
    from ..ops.kernel_lib import forest_lib

    if not x.is_cuda:
        raise ValueError("chain_cuda needs CUDA tensors")
    c = _checked(x, variant)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = forest_lib().forest_chain_launch(
            x.data_ptr(), out.data_ptr(), VARIANTS.index(variant), c, k, g,
            stream(x.device))
    if rc != 0:
        raise RuntimeError(f"forest_chain {variant} launch failed: CUDA "
                           f"error {rc}")
    chain_cuda.launches += 1
    return out


chain_cuda.launches = 0


def chain_host(x: torch.Tensor, variant: str, k: int = K,
               g: int = G) -> torch.Tensor:
    """P6 through the g++ host build of the kernel's per-channel code, on
    a CPU state."""
    from ..ops.kernel_lib import host_lib

    c = _checked(x, variant)
    out = torch.empty_like(x)
    if host_lib().forest_chain_host(x.data_ptr(), out.data_ptr(),
                                    VARIANTS.index(variant), c, k, g):
        raise ValueError(f"forest_chain_host refused {variant} at C={c}")
    return out


# each variant's kernel wrapper and plain version (both take the variant)
KERNELS = dict.fromkeys(VARIANTS, chain_cuda)
PLAIN = dict.fromkeys(VARIANTS, chain_reference)


def ns_per_iter(variant: str, x: torch.Tensor, k: int = K,
                g: int = G) -> float:
    """The kernel's time per inner iteration in ns: the device time per
    launch (median of 5 CUDA-event timed runs of 10 launches queued behind
    a device sleep, so the wrapper's host time stays out), over G * 8."""
    return queued_ms(lambda: chain_cuda(x, variant, k, g), 5, 10,
                     SLEEP_CYCLES) * 1e6 / (g * ITERS)


# the dependent-issue latency of an FP32 or INT32 arithmetic instruction
# (FFMA, FADD, FSEL, FSETP, IADD3, LOP3, IMNMX) on the card, in cycles
ALU_LATENCY_CYCLES = 4
# the instruction each pair of an op issues once (twice for fma), by which
# chip_smoke.py counts the pairs in a loop trip of chain_kernel's SASS
PAIR_MARKER = {"fma": ("FFMA", 2), "sel": ("FSETP", 1), "int": ("LOP3", 1)}


def latency_bound_ns(variant: str, dep: float, issue: float, mhz: float,
                     k: int = K) -> float:
    """The least time of one iteration in ns at an SM clock of ``mhz``:
    the larger of one chain's ``k`` dependent pairs (``k / 4`` for ilp) at
    ``dep`` dependent instructions a pair, each ALU_LATENCY_CYCLES long,
    and the instructions of all the channel's chains (``issue`` a pair)
    issued one a cycle by its warp (C <= 32 channels are one warp)."""
    rows = {"c1": 1, "lc": 1, "k4": 4, "ilp": 4, "fc": 8, "kc": 16}[
        variant.split("_")[0]]
    pairs = k // 4 if variant.startswith("ilp") else k
    cycles = max(pairs * dep * ALU_LATENCY_CYCLES, rows * pairs * issue)
    return cycles / mhz * 1e3


def run(variants=VARIANTS, c: int = C, k: int = K, g: int = G) -> dict:
    """The probe on the card: each variant on the probe's inputs; ns per
    iteration and per op pair printed, and returned by variant."""
    res = {}
    for i, v in enumerate(variants):
        x = torch.as_tensor(probe_inputs(v, c), device="cuda")
        if i == 0:
            warm_up(lambda: chain_cuda(x, v, k, g))
        ns = ns_per_iter(v, x, k, g)
        per_pair = ns / (k // 4 if v.startswith("ilp") else k)
        res[v] = {"ns_per_iter": ns, "ns_per_pair": per_pair}
        print(f"P6 {v}: C={c} K={k} G={g} on "
              f"{torch.cuda.get_device_name(0)}: {ns:.1f} ns/iter, "
              f"{per_pair:.3f} ns/op-pair")
    return res


def main(argv) -> int:
    which = argv[1] if len(argv) > 1 else "all"
    if which != "all" and which not in VARIANTS:
        print(f"usage: {argv[0]} [{'|'.join(VARIANTS)}|all] [C] [K] [G]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("forest_chain: needs a CUDA device", file=sys.stderr)
        return 1
    c, k, g = (int(a) for a in (argv[2:5] + [C, K, G][len(argv[2:5]):]))
    run(VARIANTS if which == "all" else [which], c, k, g)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
