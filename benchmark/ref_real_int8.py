"""The plain reference of the ``real_int8`` front end's ingest, the
benchmark's own copy: int8 real samples at M / L of 2.046 MHz with the
IF at a quarter of the rate, to 2.046 MHz complex baseband, in float64
the direct way (mix by ``exp(-j 2 pi IF t)``, L - 1 zeros after each
sample, the low-pass taps, every M-th sample kept; zeros before the
window).  The taps are designed here as the program designs them
(a Kaiser-windowed sinc of L * 128 taps at L times the rate, -6 dB at
1.023 MHz, beta 8, summing to 2 L); the CPU tests hold the program's
ingest and taps to this copy.  Imports nothing of the program."""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

BASEBAND_HZ = 2046000
TAPS_PER_PHASE = 128
CUTOFF_HZ = 1.023e6
KAISER_BETA = 8.0


def ratio(sample_rate_hz: float) -> tuple:
    """``(L, M)``: the rate is M / L of 2.046 MHz in lowest terms."""
    r = Fraction(int(round(float(sample_rate_hz))), BASEBAND_HZ)
    return r.denominator, r.numerator


def taps(sample_rate_hz: float) -> np.ndarray:
    """The low-pass's L * 128 float64 taps at L times the rate."""
    up, _ = ratio(sample_rate_hz)
    n = up * TAPS_PER_PHASE
    wc = 2.0 * CUTOFF_HZ / (up * float(sample_rate_hz))
    k = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = wc * np.sinc(wc * k) * np.kaiser(n, KAISER_BETA)
    return h * (2.0 * up / h.sum())


def lag_s(sample_rate_hz: float) -> float:
    """From an epoch's start to the centre of its first output sample:
    output m is the filter's output at up-sampled instant M m, and the
    symmetric taps centre it (L 128 - 1) / 2 up-sampled samples earlier,
    so the lag is negative."""
    up, _ = ratio(sample_rate_hz)
    return -(up * TAPS_PER_PHASE - 1) / 2.0 / (up * float(sample_rate_hz))


def to_baseband(samples, sample_rate_hz: float,
                if_hz: float) -> torch.Tensor:
    """complex128 baseband at 2.046 MHz from int8 real samples (a whole
    number of M-sample frames), on the CPU."""
    up, down = ratio(sample_rate_hz)
    x = torch.as_tensor(np.asarray(samples, dtype=np.int8)).to(torch.float64)
    n = x.numel()
    if n % down:
        raise ValueError(f"{n} samples: want whole frames of {down}")
    t = torch.arange(n, dtype=torch.float64) / float(sample_rate_hz)
    mixed = x * torch.exp(-2j * np.pi * float(if_hz) * t)
    h = torch.as_tensor(taps(sample_rate_hz))
    w = h.flip(0).reshape(1, 1, -1)
    parts = []
    for part in (mixed.real, mixed.imag):
        stuffed = torch.zeros(n * up, dtype=torch.float64)
        stuffed[::up] = part
        padded = F.pad(stuffed.reshape(1, 1, -1), (h.numel() - 1, 0))
        parts.append(F.conv1d(padded, w, stride=down).reshape(-1)
                     [: n * up // down])
    return torch.complex(parts[0], parts[1])
