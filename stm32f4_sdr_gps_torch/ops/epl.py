"""Half-chip E/P/L correlator over the doubled upsampled code.

Torch port of the correlator contract of the JAX package's
ops/pallas_epl.py: at exactly 2 samples/chip the sampled replica
``code[floor(phase + k/2)]`` depends only on the *integer half-chip*
part of the code phase — for any sub-half-chip fraction mu in [0,1),
``floor((M + mu + k)/2) == floor((M + k)/2)``.  So the code NCO is a
slice at offset M into a doubled 2-sample/chip upsampled code, with
E/P/L at offsets M-1, M, M+1.  The fractional phase still advances in
the loop state, so long-term code tracking stays exact.

The JAX package's per-epoch kernel K2 (``_epl_kernel_real``) has three
counterparts here, and :func:`epl_correlate` picks by device:

* :func:`epl_correlate_cuda`, the hand-written Hopper kernel
  (``csrc/epl.cu``), for tensors on a CUDA device;
* :func:`epl_correlate_halfchip`, its plain torch version, for tensors on
  the CPU;
* :func:`epl_correlate_host`, the kernel's arithmetic built for the host
  with g++, which the CPU tests hold against the plain version.

There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.  The tracking-scan kernel (ops.track_scan) computes the
same sums inside its loop, from the same source (``csrc/track_epoch.cuh``)
and in the same order, so for the same epoch and state the two kernels'
sums are equal bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import CODE_LENGTH

S = 2 * CODE_LENGTH            # 2046 samples / epoch at 2 samples/chip
U2P = 4352                     # width of a doubled upsampled code row

_TWO_PI = 2.0 * math.pi


def upsampled_code_doubled(code_table: np.ndarray) -> np.ndarray:
    """(C, U2P) float32: code upsampled to 2 samples/chip, tiled to
    U2P samples: ``U[j] = code[floor(j/2) mod 1023]``, so
    ``U[j] == U[j + S]``.  A correlator at half-chip shift m in [1, S]
    reads ``U[m - 1 + k]`` .. ``U[m + 1 + k]`` for k < S, all inside the
    row."""
    c = code_table.shape[0]
    j = np.arange(U2P)
    idx = (j // 2) % CODE_LENGTH
    out = np.empty((c, U2P), dtype=np.float32)
    out[:, :] = code_table[:, idx]
    return out


def halfchip_shift(code_phase_chips: torch.Tensor) -> torch.Tensor:
    """(C,) int64 integer half-chip shift m = floor(2 * phase) mod S,
    with 0 folded to S so the early lag's start m - 1 stays >= 0."""
    m = torch.remainder(torch.floor(2.0 * code_phase_chips).to(torch.int64), S)
    return torch.where(m == 0, torch.full_like(m, S), m)


def epl_correlate_halfchip(
    x: torch.Tensor,                     # (S,) complex64 epoch
    u2: torch.Tensor,                    # (C, U2P) doubled upsampled codes
    code_phase_chips: torch.Tensor,      # (C,) f32
    doppler_hz: torch.Tensor,            # (C,) f32
    carrier_phase_cycles: torch.Tensor,  # (C,) f32
    sample_rate_hz: float,
) -> torch.Tensor:
    """(C, 3) complex64 E/P/L correlations with the carrier rotated off
    exactly per sample: angle ``ph + (dop / fs) * k`` in cycles, wrapped
    to [0, 1) before the cos/sin."""
    dev = u2.device
    k = torch.arange(S, dtype=torch.float32, device=dev)
    dopfs = doppler_hz / sample_rate_hz
    ang = carrier_phase_cycles[:, None] + dopfs[:, None] * k[None, :]
    ang = ang - torch.floor(ang)
    c = torch.cos(_TWO_PI * ang)
    s = torch.sin(_TWO_PI * ang)
    xr = x.real[None, :]
    xi = x.imag[None, :]
    yr = xr * c + xi * s
    yi = xi * c - xr * s
    m = halfchip_shift(code_phase_chips)
    idx = m[:, None] - 1 + torch.arange(S + 2, device=dev)[None, :]
    win = torch.gather(u2, 1, idx)                       # (C, S + 2)
    sums = []
    for lag in range(3):
        rep = win[:, lag:lag + S]
        sums.append(torch.complex((yr * rep).sum(1), (yi * rep).sum(1)))
    epl_correlate_halfchip.calls += 1
    return torch.stack(sums, dim=1)


epl_correlate_halfchip.calls = 0


def _check(x, u2, code_phase_chips, doppler_hz, carrier_phase_cycles):
    """Raise on what the kernel and its host build do not take."""
    if x.shape != (S,) or x.dtype != torch.complex64:
        raise ValueError(f"x: want ({S},) complex64, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if u2.dim() != 2 or u2.shape[1] != U2P or u2.dtype != torch.float32:
        raise ValueError(f"u2: want (C, {U2P}) float32, got "
                         f"{tuple(u2.shape)} {u2.dtype}")
    c = u2.shape[0]
    for name, t in (("code_phase_chips", code_phase_chips),
                    ("doppler_hz", doppler_hz),
                    ("carrier_phase_cycles", carrier_phase_cycles)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want ({c},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("x", x), ("u2", u2), ("code_phase_chips",
                                           code_phase_chips),
                    ("doppler_hz", doppler_hz),
                    ("carrier_phase_cycles", carrier_phase_cycles)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def epl_correlate_cuda(x, u2, code_phase_chips, doppler_hz,
                       carrier_phase_cycles, sample_rate_hz):
    """Launch the per-epoch E/P/L kernel (csrc/epl.cu) on the card: same
    contract as :func:`epl_correlate_halfchip`.
    ``epl_correlate_cuda.launches`` counts kernel launches."""
    from .kernel_lib import epl_lib

    if not x.is_cuda:
        raise ValueError("epl_correlate_cuda needs CUDA tensors")
    _check(x, u2, code_phase_chips, doppler_hz, carrier_phase_cycles)
    c = u2.shape[0]
    out = torch.empty((c, 3), dtype=torch.complex64, device=x.device)
    if c == 0:
        return out
    lib = epl_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.epl_launch(
            x.data_ptr(), u2.data_ptr(), code_phase_chips.data_ptr(),
            doppler_hz.data_ptr(), carrier_phase_cycles.data_ptr(),
            out.data_ptr(), c, sample_rate_hz, stream)
    if rc != 0:
        raise RuntimeError(f"epl kernel launch failed: CUDA error {rc}")
    epl_correlate_cuda.launches += 1
    return out


epl_correlate_cuda.launches = 0


def epl_correlate_host(x, u2, code_phase_chips, doppler_hz,
                       carrier_phase_cycles, sample_rate_hz):
    """The kernel's arithmetic built for the host with g++
    (csrc/kernels_host.cpp) on CPU tensors, summed in the kernel's order:
    the check of the CUDA source on a machine without a GPU."""
    from .kernel_lib import host_lib

    if x.device.type != "cpu":
        raise ValueError("epl_correlate_host needs CPU tensors")
    _check(x, u2, code_phase_chips, doppler_hz, carrier_phase_cycles)
    c = u2.shape[0]
    out = torch.empty((c, 3), dtype=torch.complex64)
    rc = host_lib().epl_host(
        x.data_ptr(), u2.data_ptr(), code_phase_chips.data_ptr(),
        doppler_hz.data_ptr(), carrier_phase_cycles.data_ptr(),
        out.data_ptr(), c, sample_rate_hz)
    if rc != 0:
        raise RuntimeError("epl_host: half-chip shift out of range")
    return out


def epl_correlate(x, u2, code_phase_chips, doppler_hz, carrier_phase_cycles,
                  sample_rate_hz):
    """(C, 3) complex64 half-chip E/P/L of one epoch: the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    if x.is_cuda:
        return epl_correlate_cuda(x, u2, code_phase_chips, doppler_hz,
                                  carrier_phase_cycles, sample_rate_hz)
    if x.device.type == "cpu":
        return epl_correlate_halfchip(x, u2, code_phase_chips, doppler_hz,
                                      carrier_phase_cycles, sample_rate_hz)
    raise ValueError(f"no E/P/L correlator for device {x.device}")
