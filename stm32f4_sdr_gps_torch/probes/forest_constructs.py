"""The tracking update's constructs, one at a time: the epoch-cost probe P7
on the card.

Counterpart of the JAX package's TPU probe P7, ``tools/forest_probe2.py``
(``build.kernel``): G steps of 8 iterations of a minimal epoch body on a
(13, C, 1) float32 and a (13, C, 1) int32 state (``base``: load planes 0
and 1, two fused fma pairs, store them), plus one construct per variant
(``VARIANTS``):

* ``when_any`` / ``when_any4``: 1 or 4 guards ``any(a > b * 1e9 + j)``
  over all channels, each followed by a store that the body's own store
  overwrites; on the card a block barrier each (``__syncthreads_or``);
* ``concat16``: the 16 pieces ``a * (1 + 0.01 j)`` stored to output row 0;
* ``stack13``: all 13 planes written as ``a * (1 + 0.001 j)``;
* ``imod4``: four int32 floor-mods ``ia = (ib - ia) mod (20 + j)``;
* ``fdiv4``: four IEEE divides ``a = b / max(a, 1e-12); b = a + b``;
* ``dynstore``: ``a`` stored to output row g (the grid step);
* ``sincos``: ``a = cos(a) + sin(b)``;
* ``costas``: the tracking kernel's polynomial Costas discriminator
  (``costas_err`` in ``csrc/track_epoch.cuh``, ``_costas_err_poly`` here);
* ``lcg``: the watchdog kick's LCG uniform of ``ia`` and a select.

Two of them are the tracking loop's own code bit for bit (``costas``,
``lcg``), so on the card this probe measures K1's serial update by part.

Semantics the port fixes, against the TPU probe:

* the (G, C, 16) output starts as ``torch.zeros``: the probe writes only
  row 0 (at the end) and, in ``dynstore``, row g, and left the other rows
  undefined;
* everything the work writes is returned: the output and the final 13 +
  13 state planes, so the checks see each construct's effect and the
  compiler cannot drop it as dead.

The kernel (``csrc/forest.cu``, ``constructs_kernel``) runs one thread
per channel with all C channels in one block and the planes in shared
memory.  The plain torch version forms the fused steps in float64 and
rounds them to float32.  At the probe's size the chains overflow (the
base's b grows about 5x per iteration: inf long before 1024 iterations),
so kernel and plain version are compared at G = 2 and timed at G = 128.

    python -m stm32f4_sdr_gps_torch.probes.forest_constructs [variant|all] [C] [G]

prints the kernel's ns per iteration and each construct's delta over
``base``, at the probe's size and on finite values (needs a CUDA
device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.track_scan import _costas_err_poly
from ..ops.wipeoff import fma
from ..track.scan import _lcg_uniform
from .common import (SLEEP_CYCLES, check_tensor, queued_ms, stream,
                     warm_up)

C, G = 32, 128                 # the probe's size (forest_probe2.py:57-58)
CHECK_G = 2
CHECK_SEED = 3
ITERS = 8
NP = 13                        # state planes
OUT_W = 16                     # output row width
VARIANTS = ["base", "when_any", "when_any4", "concat16", "stack13",
            "imod4", "fdiv4", "dynstore", "sincos", "costas", "lcg"]
_A, _B = float(np.float32(1.000001)), float(np.float32(0.999999))
_CONCAT = [float(np.float32(1.0 + 0.01 * j)) for j in range(OUT_W)]
_STACK = [float(np.float32(1.0 + 0.001 * j)) for j in range(NP)]


def probe_inputs(c: int = C) -> np.ndarray:
    """The probe's state: ``ones * 0.5`` (forest_probe2.py:161); the int
    planes are its truncation, 0."""
    return np.full((NP, c, 1), 0.5, np.float32)


def check_inputs(seed: int, c: int = C, variant: str = "") -> np.ndarray:
    """A seeded state: magnitudes uniform in [0.5, 30) with random signs,
    so the int planes (their truncation) vary per channel for imod4 and
    lcg and costas meets both signs of a and b.  fdiv4 takes the
    magnitudes alone: from a negative a its divide by max(a, 1e-12)
    overflows to inf within two iterations."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 30.0, (NP, c, 1))
    if variant != "fdiv4":
        x *= rng.choice([-1.0, 1.0], x.shape)
    return x.astype(np.float32)


def check_args(variant: str, which: str, device="cpu", c: int = C) -> tuple:
    """The wrapper's (and the plain version's) arguments at the check
    size, on the probe's inputs (``which="probe"``) or the seeded ones."""
    x = (probe_inputs(c) if which == "probe"
         else check_inputs(CHECK_SEED, c, variant))
    return torch.as_tensor(x, device=device), variant, CHECK_G


def tolerance(variant: str) -> tuple:
    """(rtol, atol) of the kernel against the plain version: rtol 1e-5 on
    everything, as every construct rides on the fused chain (the plain
    version rounds a float64 result once, a rare double rounding apart
    from fmaf); sincos also atol 1e-5 on a = cos(a) + sin(b), for an ulp
    between the card's cosf / sinf and torch's carried along the chain."""
    return (1e-5, 1e-5) if variant == "sincos" else (1e-5, 0.0)


def constructs_reference(x: torch.Tensor, variant: str,
                         g: int = G) -> tuple:
    """Plain torch version of P7: (out (G, C, 16) f32, st (13, C, 1) f32,
    sti (13, C, 1) i32)."""
    c = x.shape[1]
    dev = x.device
    st = x[:, :, 0].clone()
    sti = x[:, :, 0].to(torch.int32)
    out = torch.zeros((g, c, OUT_W), dtype=torch.float32, device=dev)
    concat = torch.tensor(_CONCAT, device=dev)
    stack = torch.tensor(_STACK, device=dev)
    for gi in range(g):
        for _ in range(ITERS):
            a, b = st[0].clone(), st[1].clone()
            ia, ib = sti[0].clone(), sti[1].clone()
            for _ in range(2):
                a = fma(a, _A, b)
                b = fma(b, _B, a)
            if variant in ("when_any", "when_any4"):
                for j in range(1 if variant == "when_any" else 4):
                    if bool((a > fma(b, 1e9, torch.full_like(b, j))).any()):
                        st[0] = a + 1.0
            elif variant == "concat16":
                out[0] = a[:, None] * concat[None, :]
            elif variant == "stack13":
                st[:] = a[None, :] * stack[:, None]
            elif variant == "imod4":
                for j in range(4):
                    ia = torch.remainder(ib - ia, 20 + j)
            elif variant == "fdiv4":
                for _ in range(4):
                    a = b / torch.maximum(a, torch.full_like(a, 1e-12))
                    b = a + b
            elif variant == "dynstore":
                out[gi] = a[:, None]
            elif variant == "sincos":
                a = torch.cos(a) + torch.sin(b)
            elif variant == "costas":
                a = _costas_err_poly(a, b)
            elif variant == "lcg":
                a = torch.where(_lcg_uniform(ia) > 0.5, a, b)
            st[0] = a
            st[1] = b
            if variant == "imod4":
                sti[0] = ia
    out[0] = st[0][:, None]
    return out, st[:, :, None], sti[:, :, None]


def _checked(x: torch.Tensor, variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown P7 variant {variant!r}")
    c = x.shape[1] if x.dim() == 3 else -1
    check_tensor("x", x, (NP, c, 1), torch.float32, x.device)
    return c


def _outputs(c: int, g: int, device) -> tuple:
    return (torch.zeros((g, c, OUT_W), dtype=torch.float32, device=device),
            torch.empty((NP, c, 1), dtype=torch.float32, device=device),
            torch.empty((NP, c, 1), dtype=torch.int32, device=device))


def constructs_cuda(x: torch.Tensor, variant: str, g: int = G,
                    out: tuple | None = None) -> tuple:
    """Launch P7's kernel (csrc/forest.cu) on a CUDA (13, C, 1) state,
    C <= 1024.  ``out``, if given, is the (out, st, sti) triple to write,
    its first member zeroed by the caller.  ``launches`` counts the
    launches."""
    from ..ops.kernel_lib import forest_lib

    if not x.is_cuda:
        raise ValueError("constructs_cuda needs CUDA tensors")
    c = _checked(x, variant)
    if out is None:
        out = _outputs(c, g, x.device)
    for name, t, want in zip(("out", "st", "sti"), out,
                             _outputs(c, g, "meta")):
        check_tensor(name, t, want.shape, want.dtype, x.device)
    with torch.cuda.device(x.device):
        rc = forest_lib().forest_constructs_launch(
            x.data_ptr(), *(t.data_ptr() for t in out),
            VARIANTS.index(variant), c, g, stream(x.device))
    if rc != 0:
        raise RuntimeError(f"forest_constructs {variant} launch failed: "
                           f"CUDA error {rc}")
    constructs_cuda.launches += 1
    return out


constructs_cuda.launches = 0


def constructs_host(x: torch.Tensor, variant: str, g: int = G) -> tuple:
    """P7 through the g++ host build of the kernel's bodies, on a CPU
    state."""
    from ..ops.kernel_lib import host_lib

    c = _checked(x, variant)
    out = _outputs(c, g, x.device)
    if host_lib().forest_constructs_host(
            x.data_ptr(), *(t.data_ptr() for t in out),
            VARIANTS.index(variant), c, g):
        raise ValueError(f"forest_constructs_host refused {variant} at "
                         f"C={c}")
    return out


# each variant's kernel wrapper and plain version (both take the variant)
KERNELS = dict.fromkeys(VARIANTS, constructs_cuda)
PLAIN = dict.fromkeys(VARIANTS, constructs_reference)


def ns_per_iter(variant: str, x: torch.Tensor, g: int = G) -> float:
    """The kernel's time per inner iteration in ns: the device time per
    launch into one preallocated output (median of 5 CUDA-event timed runs
    of 10 launches queued behind a device sleep, so the wrapper's host
    time stays out), over G * 8."""
    out = _outputs(x.shape[1], g, x.device)
    return queued_ms(lambda: constructs_cuda(x, variant, g, out), 5, 10,
                     SLEEP_CYCLES) * 1e6 \
        / (g * ITERS)


# the probe's inputs stay finite for 4 steps (32 iterations) in every
# variant; past that the chain runs on inf and NaN
FINITE_G = 4


def ns_per_iter_finite(variant: str, x: torch.Tensor) -> float:
    """The kernel's time per inner iteration in ns on finite values: the
    device time of a FINITE_G-step launch less that of a 1-step launch
    (each the median of 3 runs of 50 launches queued back to back), over
    the 8 (FINITE_G - 1) iterations between them.  IEEE divides and cosf
    / sinf take slower paths on inf, NaN and huge arguments, which the
    probe's size reaches after about 40 iterations."""
    def launch_ms(g):
        out = _outputs(x.shape[1], g, x.device)
        return queued_ms(lambda: constructs_cuda(x, variant, g, out), 3, 50,
                         4 * SLEEP_CYCLES)

    return ((launch_ms(FINITE_G) - launch_ms(1)) * 1e6
            / ((FINITE_G - 1) * ITERS))


def run(variants=VARIANTS, c: int = C, g: int = G,
        finite: bool = True) -> dict:
    """The probe on the card: each variant on the probe's inputs; ns per
    iteration at the probe's size and (``finite``) on finite values, each
    with its delta over ``base``, printed and returned by variant."""
    x = torch.as_tensor(probe_inputs(c), device="cuda")
    warm_up(lambda: constructs_cuda(x, "base", g))
    base = ns_per_iter("base", x, g)
    base_f = ns_per_iter_finite("base", x) if finite else None
    res = {}
    for v in variants:
        ns = base if v == "base" else ns_per_iter(v, x, g)
        res[v] = {"ns_per_iter": ns, "delta_ns": ns - base}
        line = (f"P7 {v}: C={c} G={g} on {torch.cuda.get_device_name(0)}: "
                f"{ns:.1f} ns/iter (delta vs base {ns - base:+.1f})")
        if finite:
            nf = base_f if v == "base" else ns_per_iter_finite(v, x)
            res[v].update(ns_per_iter_finite=nf, delta_ns_finite=nf - base_f)
            line += (f"; on finite values {nf:.1f} ns/iter (delta "
                     f"{nf - base_f:+.1f})")
        print(line)
    return res


def main(argv) -> int:
    which = argv[1] if len(argv) > 1 else "all"
    if which != "all" and which not in VARIANTS:
        print(f"usage: {argv[0]} [{'|'.join(VARIANTS)}|all] [C] [G]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("forest_constructs: needs a CUDA device", file=sys.stderr)
        return 1
    c, g = (int(a) for a in (argv[2:4] + [C, G][len(argv[2:4]):]))
    run(VARIANTS if which == "all" else [which], c, g)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
