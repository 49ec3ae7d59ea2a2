"""Carrier NCO wipe-off (torch port of the JAX package's ops/wipeoff.py).

An exact complex rotation at the tracked Doppler with phase carried
across epochs, kept as fractional cycles wrapped each epoch so float32
stays accurate indefinitely.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi


def _f32(v: float) -> float:
    """A Python float rounded to float32, as torch rounds a scalar operand
    of a float32 tensor op."""
    return float(np.float32(v))


def fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 operands with one rounding, as a fused
    multiply-add computes it.  The NCOs (code phase, carrier phase, the
    replica's sample positions) advance this way because the JAX
    reference's XLA lowering fuses these multiply-adds: a separately
    rounded product drifts an accumulated phase from it by an ulp every
    few epochs.  The product and sum of float32 values at these
    magnitudes are exact in float64, so one rounding back to float32 is
    the fused result."""
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float64)
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def _unit_phasor(cycles: torch.Tensor) -> torch.Tensor:
    """exp(-j*2pi*cycles) as complex64."""
    ang = cycles * -_TWO_PI
    return torch.complex(torch.cos(ang), torch.sin(ang))


def carrier_wipeoff(
    x: torch.Tensor,               # (n,) or (C, n) complex input
    freq_hz: torch.Tensor,         # (C,) carrier offset to remove
    phase_cycles: torch.Tensor,    # (C,) carrier phase at sample 0
    sample_rate_hz: float,
) -> tuple:
    """Rotate the carrier off: y = x * exp(-j*2pi*(phase + f*t)).

    Returns ``(y, end_phase_cycles)`` where ``y`` is (C, n) and
    ``end_phase_cycles`` is the (wrapped) phase at sample n, for carrying
    into the next epoch.
    """
    n = x.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=x.device) / sample_rate_hz
    ph = phase_cycles[:, None] + freq_hz[:, None] * t[None, :]
    ph = ph - torch.floor(ph)
    y = torch.atleast_2d(x) * _unit_phasor(ph)
    end = fma(freq_hz, _f32(n / sample_rate_hz), phase_cycles)
    end = end - torch.floor(end)
    return y, end


def doppler_rotations(
    doppler_bins_hz: torch.Tensor,  # (D,)
    num_samples: int,
    sample_rate_hz: float,
) -> torch.Tensor:
    """(D, n) complex64 rotation table exp(-j*2pi*f_d*t) for acquisition."""
    t = torch.arange(num_samples, dtype=torch.float32,
                     device=doppler_bins_hz.device) / sample_rate_hz
    ph = doppler_bins_hz[:, None] * t[None, :]
    ph = ph - torch.floor(ph)
    return _unit_phasor(ph)
