"""C/A replica sampling, the "code NCO" (torch port of the JAX package's
ops/replica.py).

The bipolar code is gathered at a *fractional* code phase for all
channels and all correlator lags at once.  The E/P/L lags are code-phase
offsets (+/-0.5 chip by default, tracking.c:122-138).
"""

from __future__ import annotations

import torch

from ..config import CODE_LENGTH
from ..utils.device import upload
from .wipeoff import fma


def sample_replicas(
    code_table: torch.Tensor,       # (C, 1023) bipolar float32
    code_phase_chips: torch.Tensor,  # (C,) code phase at sample 0
    code_freq_chips_per_sample: torch.Tensor,  # (C,) incl. code Doppler
    num_samples: int,
    lag_offsets_chips,               # (L,) e.g. (-0.5, 0.0, +0.5)
) -> torch.Tensor:
    """Return (C, L, num_samples) sampled bipolar replicas.

    Sample ``k`` of lag ``l`` reads chip
    ``floor(phase + lag[l] + k * freq) mod 1023``.  A positive ``lag``
    samples *later* code (an "early" correlator replica leads the prompt,
    i.e. uses a negative offset).
    """
    dev = code_table.device
    lags = upload(lag_offsets_chips, dev, torch.float32)
    k = torch.arange(num_samples, dtype=torch.float32, device=dev)
    # one fused multiply-add per sample, as the JAX reference computes
    # it: at 2 samples/chip many samples sit within an ulp of a chip edge,
    # where a second rounding can move floor() to the neighbouring chip
    chip = fma(code_freq_chips_per_sample[:, None, None], k[None, None, :],
               code_phase_chips[:, None, None] + lags[None, :, None])
    idx = torch.remainder(torch.floor(chip).to(torch.int64), CODE_LENGTH)
    table = code_table.unsqueeze(1).expand(-1, idx.shape[1], -1)
    return torch.gather(table, 2, idx)
