"""Tracking channel state (torch port of the JAX package's
track/state.py).

The equivalent of ``gps_tracking_t`` + the bit-sync half of
``gps_nav_data_t`` (gps_misc.h:62-133).  All leaves carry a leading
channel axis so N channels advance *every* epoch as a batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CODE_LENGTH, TrackConfig
from ..utils.device import card_or_cpu, upload


class TrackState(NamedTuple):
    """Per-channel tracking loop state; every field has shape (C,) unless
    noted."""

    # NCOs
    carrier_phase_cycles: torch.Tensor    # f32, wrapped to [0,1)
    doppler_hz: torch.Tensor              # f32, carrier offset estimate
    code_phase_chips: torch.Tensor        # f32, phase at epoch start [0,1023)
    # Loop filter memories (tracking.c fields)
    dll_err_prev: torch.Tensor            # f32  (dll_code_err)
    pll_err_prev: torch.Tensor            # f32  (pll_code_err, half-cycles)
    fll_theta_prev: torch.Tensor          # f32  (atan(Q/I) of prev epoch)
    fll_err_prev: torch.Tensor            # f32  (fll_err)
    fll_primed: torch.Tensor              # bool (have a previous theta)
    # False-lock watchdog (tracking.c:261-327)
    ip_sign_window: torch.Tensor          # (C, W) i8 of IP signs
    pll_bad_cnt: torch.Tensor             # i32
    pll_bad_master_cnt: torch.Tensor      # i32
    acq_doppler_hz: torch.Tensor          # f32, acquisition result (kick anchor)
    # SNR estimator (tracking.c:147-169)
    snr_i_sum: torch.Tensor               # f32
    snr_q_sum: torch.Tensor               # f32
    snr_cnt: torch.Tensor                 # i32
    snr_db: torch.Tensor                  # f32
    # Bit sync (nav_data.c:46-138)
    prev_ip_sign: torch.Tensor            # i8 (+1/-1)
    last_swap_epoch: torch.Tensor         # i32, epoch of last sign swap
    right_period_cnt: torch.Tensor        # i32
    period_sync_ok: torch.Tensor          # bool
    old_remainder: torch.Tensor           # i32
    bit_pos_cnt: torch.Tensor             # i32
    bit_neg_cnt: torch.Tensor             # i32
    bit_ip_sum: torch.Tensor              # f32 prompt-I sum over the bit
    bit_qp_sum: torch.Tensor              # f32 prompt-Q sum over the bit
    # Ledger
    epoch_idx: torch.Tensor               # i32, global epoch counter
    code_wraps: torch.Tensor              # i32, net code-phase wraps
    # K-bit data-wipeoff accumulator of the coherent modes (carried so
    # the state matches the JAX package's; stays zero on the port's
    # default path)
    ext_ip_sum: torch.Tensor              # f32
    ext_qp_sum: torch.Tensor              # f32
    ext_bit_cnt: torch.Tensor             # i32


class TrackOutputs(NamedTuple):
    """Per-epoch observables emitted by the scan, each (T, C).

    The E/L correlator outputs are diagnostics, emitted as zero-size
    placeholders unless cfg.emit_correlators."""

    ip: torch.Tensor
    qp: torch.Tensor
    ie: torch.Tensor
    qe: torch.Tensor
    il: torch.Tensor
    ql: torch.Tensor
    code_phase_chips: torch.Tensor
    doppler_hz: torch.Tensor
    snr_db: torch.Tensor
    bit_ready: torch.Tensor    # bool: a nav bit completed this epoch
    bit_value: torch.Tensor    # i8 0/1 (majority vote, pre-polarity)
    bit_epoch: torch.Tensor    # i32 epoch index at which the bit *started*
    period_sync_ok: torch.Tensor
    code_wrapped: torch.Tensor  # bool: code phase wrapped this epoch


def concat_states(a: TrackState, b: TrackState) -> TrackState:
    """Concatenate two channel batches along the channel axis."""
    return TrackState(*(torch.cat([x, y], dim=0) for x, y in zip(a, b)))


def init_state(
    num_channels: int,
    code_phase_chips: np.ndarray,
    doppler_hz: np.ndarray,
    start_epoch: int = 0,
    window: int | None = None,
    device="cuda",
) -> TrackState:
    """``window`` = watchdog sign-window width; must equal the
    TrackConfig.pll_check_window the state will be scanned with.  The
    state lives on ``device``: the card unless the caller asks for the
    CPU; raises without a card.  Each host vector is uploaded once
    (``acq_doppler_hz`` is a device copy of ``doppler_hz``)."""
    device = card_or_cpu(device, "init_state")
    c = num_channels
    if window is None:
        window = TrackConfig().pll_check_window

    def f32(v):
        return upload(np.array(np.broadcast_to(v, (c,)), np.float32),
                      device)

    def full(v, dtype):
        return torch.full((c,), v, dtype=dtype, device=device)

    zf = full(0.0, torch.float32)
    zi = full(0, torch.int32)
    dop = f32(doppler_hz)
    return TrackState(
        carrier_phase_cycles=zf,
        doppler_hz=dop,
        code_phase_chips=f32(np.asarray(code_phase_chips) % CODE_LENGTH),
        dll_err_prev=zf,
        pll_err_prev=zf,
        fll_theta_prev=zf,
        fll_err_prev=zf,
        fll_primed=full(False, torch.bool),
        ip_sign_window=torch.zeros((c, window), dtype=torch.int8,
                                   device=device),
        pll_bad_cnt=zi,
        pll_bad_master_cnt=zi,
        acq_doppler_hz=dop.clone(),
        snr_i_sum=zf,
        snr_q_sum=zf,
        snr_cnt=zi,
        snr_db=zf,
        prev_ip_sign=full(1, torch.int8),
        last_swap_epoch=full(start_epoch, torch.int32),
        right_period_cnt=zi,
        period_sync_ok=full(False, torch.bool),
        old_remainder=zi,
        bit_pos_cnt=zi,
        bit_neg_cnt=zi,
        bit_ip_sum=zf,
        bit_qp_sum=zf,
        epoch_idx=full(start_epoch, torch.int32),
        code_wraps=zi,
        ext_ip_sum=zf,
        ext_qp_sum=zf,
        ext_bit_cnt=zi,
    )
