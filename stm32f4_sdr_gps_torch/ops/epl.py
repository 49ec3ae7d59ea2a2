"""Half-chip E/P/L correlator over the doubled upsampled code.

Torch port of the correlator contract of the JAX package's
ops/pallas_epl.py: at exactly 2 samples/chip the sampled replica
``code[floor(phase + k/2)]`` depends only on the *integer half-chip*
part of the code phase — for any sub-half-chip fraction mu in [0,1),
``floor((M + mu + k)/2) == floor((M + k)/2)``.  So the code NCO is a
slice at offset M into a doubled 2-sample/chip upsampled code, with
E/P/L at offsets M-1, M, M+1.  The fractional phase still advances in
the loop state, so long-term code tracking stays exact.

:func:`epl_correlate_halfchip` is the plain torch version of the JAX
package's per-epoch kernel K2 (``_epl_kernel_real``); the hand-written
Hopper kernel for it is still to come (ROADMAP Queue 2).  The tracking
scan kernel (ops.track_scan) computes the same sums inside its loop.
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
    return torch.stack(sums, dim=1)
