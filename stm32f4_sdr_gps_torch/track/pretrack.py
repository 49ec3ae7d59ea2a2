"""Pre-track code-phase refinement (torch port of the JAX package's
track/pretrack.py).

The firmware refines the coarse acquisition code phase by exhaustively
correlating a +/-15 half-chip zone over ~20-30 rounds, then voting for
the longest chain of identical argmax phases (``tracking.c:398-499``).
Here the whole zone is correlated for all channels over E epochs in one
batched tensor program, its power integrated non-coherently, and the
(interpolated) argmax taken.
"""

from __future__ import annotations

import numpy as np
import torch

from ..acquire.engine import epochs_on
from ..config import SignalPlan, TrackConfig
from ..ops.replica import sample_replicas
from ..ops.wipeoff import carrier_wipeoff
from ..utils.device import card_or_cpu, readback, upload


def _pretrack_power(
    epochs: torch.Tensor,         # (E, S)
    code_table: torch.Tensor,     # (C, 1023)
    code_phase: torch.Tensor,     # (C,)
    doppler_hz: torch.Tensor,     # (C,)
    plan: SignalPlan,
    num_offsets: int,
) -> torch.Tensor:
    """(C, K) prompt power summed over epochs at K half-chip offsets."""
    s_cnt = plan.samples_per_epoch
    dev = epochs.device
    offsets = (torch.arange(num_offsets, dtype=torch.float32, device=dev)
               - (num_offsets - 1) / 2.0) * 0.5     # half-chip grid
    code_freq = torch.full_like(code_phase, plan.chips_per_sample)
    replicas = sample_replicas(code_table, code_phase, code_freq,
                               s_cnt, offsets)      # (C, K, S)
    acc = torch.zeros((code_table.shape[0], num_offsets),
                      dtype=torch.float32, device=dev)
    phase = torch.zeros_like(doppler_hz)
    for t in range(epochs.shape[0]):
        y, phase = carrier_wipeoff(epochs[t], doppler_hz, phase,
                                   plan.sample_rate_hz)
        corr = torch.complex(
            torch.einsum("cn,ckn->ck", y.real, replicas),
            torch.einsum("cn,ckn->ck", y.imag, replicas))
        acc = acc + torch.abs(corr) ** 2
    return acc


def refine_code_phase(
    samples,
    code_table: np.ndarray,        # (C, 1023) bipolar
    code_phase_chips: np.ndarray,  # (C,) coarse acquisition result
    doppler_hz: np.ndarray,        # (C,)
    plan: SignalPlan,
    cfg: TrackConfig = TrackConfig(),
    num_epochs: int | None = None,
    device="cuda",
) -> np.ndarray:
    """Return refined (C,) code phases (chips, sub-half-chip accurate),
    computed on ``device``: the card unless the caller asks for the CPU;
    raises without a card."""
    device = card_or_cpu(device, "refine_code_phase")
    s_cnt = plan.samples_per_epoch
    e = min(num_epochs or cfg.pre_track_epochs, len(samples) // s_cnt)
    epochs = epochs_on(samples, e, s_cnt, device)
    k = cfg.pre_track_zone_halfchips + 1
    power = readback(_pretrack_power(
        epochs,
        upload(code_table, device, torch.float32),
        upload(code_phase_chips, device, torch.float32),
        upload(doppler_hz, device, torch.float32),
        plan,
        k,
    ))
    best = power.argmax(axis=1)
    # parabolic interpolation around the peak (clamped at zone edges)
    refined = []
    for c, b in enumerate(best):
        if 0 < b < k - 1:
            ym1, y0, yp1 = power[c, b - 1], power[c, b], power[c, b + 1]
            denom = ym1 - 2 * y0 + yp1
            frac = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
        else:
            frac = 0.0
        off = (b - (k - 1) / 2.0 + np.clip(frac, -0.5, 0.5)) * 0.5
        refined.append((code_phase_chips[c] + off) % 1023.0)
    return np.asarray(refined)
