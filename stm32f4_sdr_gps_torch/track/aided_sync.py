"""Aided bit synchronization: histogram boundary search on prompts
(torch port of the JAX package's track/aided_sync.py).

The run-time bit-sync state machine (nav_data.c:46-138 equivalent in
track.scan) needs ~10 s of >=36 dBHz signal before it declares sync —
per-epoch sign flips must repeatedly land on the 20 ms grid.  At the
C/N0 the coherent PLL targets (26-30 dBHz) that never happens: noise
flips swamp the counters.

This module finds the boundary instead, the classic way: sign flips of
the prompt history are histogrammed modulo the bit length.  Noise flips
spread uniformly over the ``cib`` phase bins; genuine data transitions
concentrate in the boundary bin.  The result seeds the scan state
(``engage_bit_sync``) so the grid-locked coherent loop
(config.TrackConfig.coherent_pll) can engage immediately — closing the
cold-start path: DEEP_ACQ -> refine_doppler -> aided sync -> coherent
tracking.  The decision statistics are host numpy; only
``engage_bit_sync`` touches the (C,) state tensors, on their device.

The firmware has no equivalent (it simply cannot decode there).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .state import TrackState


def boundary_from_flip_hist(
    counts: np.ndarray,          # (cib,) or (cib, C) flip counts per residue
) -> Tuple[np.ndarray, np.ndarray]:
    """Boundary phase + confidence from a sign-flip histogram whose
    bins are GLOBAL epoch residues mod ``cib``.

    This is the decision half of :func:`find_bit_boundary`, split out so
    a device-computed histogram (runtime.digest ``flip_hist``) feeds the
    same math without the (T, C) prompt history ever reaching the host.
    Returns ``(boundary_phase, confidence)`` per channel.
    """
    counts = np.asarray(counts, dtype=np.int64)
    if counts.ndim == 1:
        counts = counts[:, None]
    cib, c_cnt = counts.shape
    phases = np.zeros(c_cnt, np.int64)
    confs = np.zeros(c_cnt)
    for c in range(c_cnt):
        col = counts[:, c]
        # a bit edge near an epoch-fraction of 0.5 splits its flips
        # between two adjacent residues — score adjacent PAIRS so the
        # detection doesn't lose half its energy to the split
        pair = col + np.roll(col, -1)
        b = int(np.argmax(pair))
        keep = np.ones(cib, bool)
        keep[[(b - 1) % cib, b, (b + 1) % cib]] = False  # overlapping pairs
        rest = pair[keep]
        confs[c] = (pair[b] - rest.mean()) / (rest.std() + 1e-9)
        # within the winning pair, the stronger bin is the boundary
        # (a sharp edge puts everything in one bin; a split edge makes
        # either choice correct to within one epoch)
        phases[c] = b if col[b] >= col[(b + 1) % cib] else ((b + 1) % cib)
    return phases, confs


def find_bit_boundary(
    ip_history: np.ndarray,      # (T,) or (T, C) prompt I history
    cib: int,
    first_epoch: int = 0,        # global ledger epoch of ip_history[0]
) -> Tuple[np.ndarray, np.ndarray]:
    """Histogram sign flips mod ``cib``.

    Returns ``(boundary_phase, confidence)`` per channel: the global
    epoch residue at which bits start, and the boundary bin's excess
    over the other bins in sigmas (>~5 is a confident detection).
    """
    ip = np.asarray(ip_history, dtype=np.float64)
    if ip.ndim == 1:
        ip = ip[:, None]
    t_cnt, c_cnt = ip.shape
    s = np.where(ip > 0, 1, -1)
    flips = s[1:] != s[:-1]                      # flip entering epoch t
    phase_bins = (np.arange(1, t_cnt) + first_epoch) % cib
    counts = np.stack(
        [np.bincount(phase_bins[flips[:, c]], minlength=cib)
         for c in range(c_cnt)], axis=1)
    return boundary_from_flip_hist(counts)


def engage_bit_sync(
    state: TrackState,
    boundary_phase: np.ndarray,   # (C,) epoch residues from find_bit_boundary
    next_epoch: int,              # global epoch of the next sample block
    cib: int,
    mask: np.ndarray = None,      # (C,) bool: engage only these channels
) -> TrackState:
    """Seed the scan state as bit-synced on the given boundary grid.

    The swap ledger is set to the most recent boundary at or before
    ``next_epoch`` with ``old_remainder`` consistent, so the first scan
    step sees no spurious bit completion and the first genuine boundary
    fires normally.  Vote counters and coherent sums start clean.
    """
    c = state.code_phase_chips.shape[0]
    if mask is None:
        mask = np.ones(c, bool)
    mask = np.asarray(mask, bool)
    bp = np.broadcast_to(np.asarray(boundary_phase), (c,))
    ls = next_epoch - ((next_epoch - bp) % cib)
    old_rem = (next_epoch - 1 - ls) % cib

    dev = state.code_phase_chips.device
    m = torch.as_tensor(mask, device=dev)

    def pick(new, cur, dtype):
        new = torch.as_tensor(np.array(np.broadcast_to(new, (c,))),
                              device=dev).to(dtype)
        return torch.where(m, new, cur)

    i32, f32 = torch.int32, torch.float32
    return state._replace(
        period_sync_ok=torch.where(m, True, state.period_sync_ok),
        right_period_cnt=pick(10, state.right_period_cnt, i32),
        last_swap_epoch=pick(ls, state.last_swap_epoch, i32),
        old_remainder=pick(old_rem, state.old_remainder, i32),
        bit_pos_cnt=pick(0, state.bit_pos_cnt, i32),
        bit_neg_cnt=pick(0, state.bit_neg_cnt, i32),
        bit_ip_sum=pick(0.0, state.bit_ip_sum, f32),
        bit_qp_sum=pick(0.0, state.bit_qp_sum, f32),
        # K-bit data-wipeoff accumulator (pll_ext_bits) restarts with
        # the fresh boundary — stale partial sums from a previous
        # grid would rotate the first extended update
        ext_ip_sum=pick(0.0, state.ext_ip_sum, f32),
        ext_qp_sum=pick(0.0, state.ext_qp_sum, f32),
        ext_bit_cnt=pick(0, state.ext_bit_cnt, i32),
    )
