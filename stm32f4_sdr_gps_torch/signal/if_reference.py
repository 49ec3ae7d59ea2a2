"""The float64 reference of the real-IF ingest
(``signal/capture.py`` :func:`~.capture.if_to_baseband_device`), done the
direct way in plain PyTorch, with no kernel of the port: the int8 samples
mixed by ``exp(-j 2 pi IF t)`` evaluated in float64, L - 1 zeros put in
after each, the result convolved with the same low-pass taps
(:func:`~.capture.if_resample_taps`, float64) with zeros before the
window, and every M-th sample kept.  The CPU tests and ``chip_smoke.py``
hold the kernel and its plain version to it."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .capture import if_resample_ratio, if_resample_taps


def if_to_baseband_reference(samples, sample_rate_hz: float,
                             if_hz: float) -> torch.Tensor:
    """complex128 baseband at 2.046 MHz, ``M / L`` of the input rate, from
    int8 real samples (a numpy array or a tensor; any whole number of
    M-sample frames), on the CPU."""
    up, down = if_resample_ratio(sample_rate_hz)
    x = torch.as_tensor(np.asarray(samples, dtype=np.int8)
                        if not isinstance(samples, torch.Tensor)
                        else samples.cpu()).to(torch.float64)
    n = x.numel()
    if n % down:
        raise ValueError(f"{n} samples: want whole frames of {down}")
    t = torch.arange(n, dtype=torch.float64) / float(sample_rate_hz)
    mixed = x * torch.exp(-2j * np.pi * float(if_hz) * t)
    h = torch.as_tensor(if_resample_taps(sample_rate_hz))
    w = h.flip(0).reshape(1, 1, -1)
    out = []
    for part in (mixed.real, mixed.imag):
        stuffed = torch.zeros(n * up, dtype=torch.float64)
        stuffed[::up] = part
        # y[u] = sum_k h[k] stuffed[u - k] at u = M m, zeros before 0
        padded = F.pad(stuffed.reshape(1, 1, -1), (h.numel() - 1, 0))
        out.append(F.conv1d(padded, w, stride=down).reshape(-1)
                   [: n * up // down])
    return torch.complex(out[0], out[1])
