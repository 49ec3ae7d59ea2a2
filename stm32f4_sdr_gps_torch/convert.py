"""Conversions between the JAX package's tracking state and the port's.

They take and give numpy arrays only, so this module imports neither
package's array library beyond torch: a caller hands over the leaves of
the JAX package's ``TrackState`` or ``PallasScanState`` as numpy arrays
(``np.asarray`` of each) and gets the port's tensors back, or the
reverse.  The tests use them to feed both packages the same state, and
the checkpoint loader to put a saved state on the receiver's device.
Like every entry point of the port, they put tensors on the card unless
the caller asks for the CPU (``device="cpu"``), and raise without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.track_scan import ScanState
from .track.state import TrackState
from .utils.device import card_or_cpu

# dtype of each TrackState leaf in both packages
_DTYPES = {
    "fll_primed": np.bool_,
    "ip_sign_window": np.int8,
    "prev_ip_sign": np.int8,
    "period_sync_ok": np.bool_,
    "pll_bad_cnt": np.int32,
    "pll_bad_master_cnt": np.int32,
    "snr_cnt": np.int32,
    "last_swap_epoch": np.int32,
    "right_period_cnt": np.int32,
    "old_remainder": np.int32,
    "bit_pos_cnt": np.int32,
    "bit_neg_cnt": np.int32,
    "epoch_idx": np.int32,
    "code_wraps": np.int32,
    "ext_bit_cnt": np.int32,
}


def track_state_from_numpy(leaves, device="cuda") -> TrackState:
    """Port TrackState from the JAX TrackState's leaves in field order
    (``[np.asarray(v) for v in jax_track_state]``), on ``device``."""
    device = card_or_cpu(device, "track_state_from_numpy")
    return TrackState(*(
        torch.tensor(np.asarray(v, dtype=_DTYPES.get(f, np.float32)),
                     device=device)
        for f, v in zip(TrackState._fields, leaves, strict=True)))


def track_state_to_numpy(ts: TrackState) -> dict:
    """The port TrackState's leaves as numpy arrays, by field name (the
    JAX TrackState's dtypes)."""
    return {f: getattr(ts, f).cpu().numpy().astype(
        _DTYPES.get(f, np.float32)) for f in TrackState._fields}


def scan_state_from_jax(f32: np.ndarray, i32: np.ndarray, win: np.ndarray,
                        device="cuda") -> ScanState:
    """Port kernel state from a JAX ``PallasScanState``'s f32 (16, C, 1),
    i32 (14, C, 1) and win (W, C, 1) planes, on ``device``: the trailing
    singleton axis is dropped.  The JAX kernel's carrier-ramp cache
    (``ramp``/``dref``) has no counterpart in the port and is not taken."""
    device = card_or_cpu(device, "scan_state_from_jax")
    def plane(a, dtype):
        return torch.tensor(np.asarray(a, dtype=dtype)[..., 0],
                            device=device)

    return ScanState(f32=plane(f32, np.float32), i32=plane(i32, np.int32),
                     win=plane(win, np.int32))
