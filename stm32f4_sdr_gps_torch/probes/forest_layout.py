"""Layouts of the correlator's reductions and of the replica barrel: the
epoch-cost probe P8 on the card.

Counterpart of the JAX package's TPU probe P8, ``tools/forest_probe3.py``
(``build.kernel``): G steps of 8 iterations on a float32 state of 8
planes (``st``) and a wide float32 plane ``wst`` of 2048 samples per
channel, channel-major (C, 2048) for the ``_row`` variants and
sample-major (2048, C) for the ``_col`` ones (``VARIANTS``):

* ``tr6`` / ``tr2``: planes 0-5 / 0-1 of ``st`` relaid out, scaled by
  1.000001 and relaid back (the TPU's sublane <-> lane transposes);
* ``wide_*``: 14 fused passes ``a = a*1.000001 + w; a = a*0.999999 - w``
  on every sample, the result the next iteration's plane;
* ``red_*``: six multiply-reduce sums ``sum_k w (w + j)`` per channel,
  added into ``st[0]`` (the E/P/L bank's six sums);
* ``roll_*``: a 4-stage barrel: each stage reads the sample 1, 2, 4, 8
  ahead (cyclically) wherever the channel's mask ``st[0] > 0.5`` holds.
Every variant also scales ``st[7]`` by 1.0000001 each iteration.

Semantics the port fixes, against the TPU probe:

* ``red_row``, ``roll_row`` and ``roll_col`` do not trace on today's JAX:
  the row variants' state was (8, 1, C), into whose (1, 1, 1) slice
  ``red_row`` stored a (1, C, 1) sum and against which ``roll_row``
  broadcast a (1, C) mask, and ``pltpu.roll(w, -s, ax)`` refuses a
  negative amount.  Here they compute their evident intent: the row
  variants' state is (8, C, 1) (the same memory as (8, 1, C)) and the
  roll amount is folded to ``W - s`` (the JAX package's own spelling,
  ``tools/tpu_roll_wide_probe.py:162-164``), which reads the sample ``s``
  ahead;
* everything the work writes is returned: ``wst`` beside ``st``.  (On the
  probe's own inputs ``w`` is a constant 0.25, so a roll of it is itself,
  and ``st[0]`` is 0.5, so no mask holds; the seeded check inputs make
  both visible.)

The kernels (``csrc/forest.cu``): ``tr_kernel``, one block that moves the
planes through shared memory between a thread per channel and a thread
per (plane, channel); ``row_kernel``, one block per channel with its
8 KB row in shared memory; ``col_kernel``, the sample-major plane over a
grid of thread-block clusters (C in 1, 2, 4, 8, 16, 32).  Each cluster of
8 blocks takes CG = min(C, 8) channels, so a channel has 256 threads as
in ``row_kernel`` and C = 32 runs on 32 blocks; block r of a cluster
holds samples [256 r, 256 r + 256) of its channels.  ``red_col``'s ranks
send their sums to rank 0 and ``roll_col``'s each send the first 15 rows
of their new slab to the rank before (the barrel's stages shift by 15
samples in all), both by stores into the other block's shared memory
that complete on its mbarrier: no cluster barrier inside the loop.
``layout_col_host`` runs that decomposition on the host (the g++ build),
in the kernel's summation order.

    python -m stm32f4_sdr_gps_torch.probes.forest_layout [variant|all] [C] [G]

prints the kernel's ns per iteration (needs a CUDA device).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.wipeoff import fma
from .common import (SLEEP_CYCLES, check_tensor, queued_ms, stream,
                     warm_up)

C, G = 32, 128                 # the probe's size (forest_probe3.py:51-54)
CHECK_G = 2
CHECK_SEED = 3
ITERS = 8
SP = 2048
NST = 8
VARIANTS = ["tr6", "tr2", "wide_row", "wide_col", "red_row", "red_col",
            "roll_row", "roll_col"]
_A, _B = float(np.float32(1.000001)), float(np.float32(0.999999))
_ST7 = float(np.float32(1.0000001))
_STAGES = (1, 2, 4, 8)


def state_shape(variant: str, c: int = C) -> tuple:
    """(8, C, 1) for tr6 and the row variants, (8, 1, C) otherwise."""
    if variant == "tr6" or variant.endswith("_row"):
        return (NST, c, 1)
    return (NST, 1, c)


def plane_shape(variant: str, c: int = C) -> tuple:
    return (SP, c) if variant.endswith("_col") else (c, SP)


def supports(variant: str, c: int) -> bool:
    """Whether the kernel takes C channels: a cluster's col kernel needs C
    to divide 32, tr6 / tr2 one block of 6C / 2C threads."""
    if variant.endswith("_col"):
        return 1 <= c <= 32 and 32 % c == 0
    if variant in ("tr6", "tr2"):
        return 1 <= c and (6 if variant == "tr6" else 2) * c <= 1024
    return c >= 1


def probe_inputs(variant: str, c: int = C) -> tuple:
    """The probe's (st, w): ``ones * 0.5`` and ``ones * 0.25``
    (forest_probe3.py:144-145)."""
    return (np.full(state_shape(variant, c), 0.5, np.float32),
            np.full(plane_shape(variant, c), 0.25, np.float32))


def check_inputs(variant: str, seed: int, c: int = C) -> tuple:
    """A seeded (st, w): st uniform in [0.1, 0.9) with st[0] above 0.5 on
    half the channels (chosen at random), w uniform in [-1, 1) per
    channel row (transposed for the col variants, so both layouts carry
    the same rows)."""
    rng = np.random.default_rng(seed)
    st = rng.uniform(0.1, 0.9, (NST, c))
    st[0] = rng.uniform(0.1, 0.45, c)
    st[0, rng.permutation(c)[:c // 2]] += 0.5
    w = rng.uniform(-1.0, 1.0, (c, SP)).astype(np.float32)
    if variant.endswith("_col"):
        w = np.ascontiguousarray(w.T)
    return st.astype(np.float32).reshape(state_shape(variant, c)), w


def check_args(variant: str, which: str, device="cpu", c: int = C) -> tuple:
    """The wrapper's (and the plain version's) arguments at the check
    size, on the probe's inputs (``which="probe"``) or the seeded ones."""
    arrays = (probe_inputs(variant, c) if which == "probe"
              else check_inputs(variant, CHECK_SEED, c))
    return (*(torch.as_tensor(a, device=device) for a in arrays), variant,
            CHECK_G)


def tolerance(variant: str) -> tuple:
    """(rtol, atol) of the kernel against the plain version: rtol 1e-5 for
    the fused wide passes (the plain version rounds a float64 result once)
    and for the sums of 2048 terms (another order); the transposes'
    scalings and the barrel exact."""
    return ((1e-5, 0.0) if variant.startswith(("wide", "red"))
            else (0.0, 0.0))


def layout_reference(x: torch.Tensor, w: torch.Tensor, variant: str,
                     g: int = G) -> tuple:
    """Plain torch version of P8: (st of x's shape, wst of w's shape)."""
    col = variant.endswith("_col")
    c = w.shape[1] if col else w.shape[0]
    axis = 0 if col else 1
    st = x.reshape(NST, c).clone()
    wst = w.clone()
    for _ in range(g * ITERS):
        if variant in ("tr6", "tr2"):
            n = 6 if variant == "tr6" else 2
            st[:n] = st[:n] * _A
        elif variant.startswith("wide"):
            a = wst
            for _ in range(7):
                a = fma(a, _A, wst)
                a = fma(a, _B, -wst)
            wst = a
        elif variant.startswith("red"):
            acc = [(wst * (wst + j)).sum(axis) for j in range(6)]
            st[0] = torch.stack(acc).sum(0)
        else:
            m = st[0] > 0.5
            m = m[None, :] if col else m[:, None]
            for s in _STAGES:
                wst = torch.where(m, torch.roll(wst, -s, axis), wst)
        st[7] = st[7] * _ST7
    return st.reshape(x.shape), wst


def _checked(x: torch.Tensor, w: torch.Tensor, variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"unknown P8 variant {variant!r}")
    c = w.shape[-1] if variant.endswith("_col") else w.shape[0]
    if not supports(variant, c):
        raise ValueError(f"P8 {variant} does not take C={c}")
    check_tensor("x", x, state_shape(variant, c), torch.float32, x.device)
    check_tensor("w", w, plane_shape(variant, c), torch.float32, x.device)
    return c


def layout_cuda(x: torch.Tensor, w: torch.Tensor, variant: str,
                g: int = G, out: tuple | None = None) -> tuple:
    """Launch P8's kernel (csrc/forest.cu) on a CUDA state and plane.
    ``out``, if given, is the (st, wst) pair to write (tr6 and tr2 leave
    its wst alone).  ``launches`` counts the launches."""
    from ..ops.kernel_lib import forest_lib

    if not x.is_cuda:
        raise ValueError("layout_cuda needs CUDA tensors")
    c = _checked(x, w, variant)
    if out is None:
        out = (torch.empty_like(x),
               w.clone() if variant.startswith("tr") else torch.empty_like(w))
    for name, t, like in zip(("st", "wst"), out, (x, w)):
        check_tensor(name, t, like.shape, torch.float32, x.device)
    with torch.cuda.device(x.device):
        rc = forest_lib().forest_layout_launch(
            x.data_ptr(), w.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            VARIANTS.index(variant), c, g, stream(x.device))
    if rc != 0:
        raise RuntimeError(f"forest_layout {variant} launch failed: CUDA "
                           f"error {rc}")
    layout_cuda.launches += 1
    return out


layout_cuda.launches = 0


def layout_host(x: torch.Tensor, w: torch.Tensor, variant: str,
                g: int = G) -> tuple:
    """P8 through the g++ host build of the kernels' bodies, on CPU
    tensors."""
    from ..ops.kernel_lib import host_lib

    c = _checked(x, w, variant)
    st, wst = torch.empty_like(x), torch.empty_like(w)
    if host_lib().forest_layout_host(x.data_ptr(), w.data_ptr(),
                                     st.data_ptr(), wst.data_ptr(),
                                     VARIANTS.index(variant), c, g):
        raise ValueError(f"forest_layout_host refused {variant} at C={c}")
    return st, wst


def layout_col_host(x: torch.Tensor, w: torch.Tensor, variant: str,
                    g: int = G) -> tuple:
    """P8's col variants through the g++ host build of col_kernel's
    decomposition (channel groups, rank slabs, roll_col's 15-row halo and
    ghost-zone stages, red_col's rank-order sum), on CPU tensors: the
    kernel's output bit for bit."""
    from ..ops.kernel_lib import host_lib

    c = _checked(x, w, variant)
    st, wst = torch.empty_like(x), torch.empty_like(w)
    if host_lib().forest_layout_col_host(x.data_ptr(), w.data_ptr(),
                                         st.data_ptr(), wst.data_ptr(),
                                         VARIANTS.index(variant), c, g):
        raise ValueError(f"forest_layout_col_host refused {variant} at "
                         f"C={c}")
    return st, wst


# each variant's kernel wrapper and plain version (both take the variant)
KERNELS = dict.fromkeys(VARIANTS, layout_cuda)
PLAIN = dict.fromkeys(VARIANTS, layout_reference)


def ns_per_iter(variant: str, x: torch.Tensor, w: torch.Tensor,
                g: int = G) -> float:
    """The kernel's time per inner iteration in ns: the device time per
    launch into one preallocated output (median of 5 CUDA-event timed runs
    of 10 launches queued behind a device sleep, so the wrapper's host
    time stays out), over G * 8."""
    out = (torch.empty_like(x), torch.empty_like(w))
    return queued_ms(lambda: layout_cuda(x, w, variant, g, out), 5, 10,
                     SLEEP_CYCLES) * 1e6 \
        / (g * ITERS)


def run(variants=VARIANTS, c: int = C, g: int = G) -> dict:
    """The probe on the card: each variant that takes C channels on the
    probe's inputs; ns per iteration printed and returned by variant."""
    res = {}
    for v in variants:
        if not supports(v, c):
            print(f"P8 {v}: does not take C={c}, skipped")
            continue
        x, w = (torch.as_tensor(a, device="cuda")
                for a in probe_inputs(v, c))
        if not res:
            warm_up(lambda: layout_cuda(x, w, v, g))
        ns = ns_per_iter(v, x, w, g)
        res[v] = {"ns_per_iter": ns}
        print(f"P8 {v}: C={c} G={g} on {torch.cuda.get_device_name(0)}: "
              f"{ns:.1f} ns/iter")
    return res


def main(argv) -> int:
    which = argv[1] if len(argv) > 1 else "all"
    if which != "all" and which not in VARIANTS:
        print(f"usage: {argv[0]} [{'|'.join(VARIANTS)}|all] [C] [G]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("forest_layout: needs a CUDA device", file=sys.stderr)
        return 1
    c, g = (int(a) for a in (argv[2:4] + [C, G][len(argv[2:4]):]))
    run(VARIANTS if which == "all" else [which], c, g)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
