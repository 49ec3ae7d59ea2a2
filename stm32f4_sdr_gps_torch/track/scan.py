"""Batched multi-channel tracking over 1 ms epochs (torch port of the JAX
package's track/scan.py).

The firmware's tracking fast path (``tracking.c:92-170`` and the
bit-sync part of ``nav_data.c:46-138``) with all C channels advanced
*every* epoch as a batch axis:

* E/P/L correlation is a replica gather + carrier rotation +
  multiply-reduce over the epoch (gps_misc.c hot loops);
* DLL / Costas-PLL / FLL discriminators and gain constants follow
  tracking.c:175-393 (gains in config.TrackConfig);
* time stays sequential with 1 ms loop closure; parallelism comes from
  channels.

:func:`track_block` is a Python loop over :func:`track_epoch_step` — the
per-epoch reference scan — unless ``cfg.in_kernel_scan`` resolves to
True, in which case the whole block runs as the tracking-scan kernel
(ops.track_scan).  In half-chip mode (``cfg.use_pallas``) each epoch's
E/P/L goes through ops.epl.epl_correlate, which launches the per-epoch
kernel (csrc/epl.cu) for CUDA tensors and runs its plain torch version
for CPU tensors; that scan is also the spec the tracking-scan kernel is
held to.
"""

from __future__ import annotations

import math

import torch

from ..config import (
    CODE_LENGTH,
    FREQ_L1_HZ,
    SignalPlan,
    TrackConfig,
    resolve_in_kernel_scan,
)
from ..ops import epl as half_chip
from ..ops.correlate import epl_correlate
from ..ops.replica import sample_replicas
from ..ops.wipeoff import _f32, carrier_wipeoff, fma
from .state import TrackOutputs, TrackState

_U32 = 0xFFFFFFFF


def check_supported(cfg: TrackConfig) -> None:
    """Raise for the tracking modes the port does not run yet."""
    if cfg.coherent_pll or cfg.coherent_bit_vote or cfg.pll_ext_bits > 1:
        raise NotImplementedError(
            "coherent tracking modes (coherent_pll, coherent_bit_vote, "
            "pll_ext_bits > 1) are not ported yet: ROADMAP Queue 1, "
            "'coherent modes in K1 plus track/aided_sync.py'")


def _wrap_half(x):
    """Wrap to (-0.5, 0.5] half-cycle range (the +/-pi/2 folds of
    tracking.c:188-192, 233-242 expressed in cycles)."""
    return x - torch.round(x)


def _costas_phase_err(ip, qp):
    """atan2-based Costas discriminator in *half-cycles*, range (-0.5, 0.5]:
    atan2(QP*sign(IP), |IP|)/pi (tracking.c:179-183)."""
    return torch.atan2(qp * torch.sign(ip), torch.abs(ip)) / math.pi


def _u32_mul(s: torch.Tensor, k: int) -> torch.Tensor:
    """(s * k) mod 2**32 for int64 s in [0, 2**32) without int64
    overflow: split k into 16-bit halves."""
    lo = s * (k & 0xFFFF)
    hi = ((s * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _lcg_uniform(seed: torch.Tensor) -> torch.Tensor:
    """Deterministic per-channel uniform in [0,1) from an integer seed
    (replaces rand() in the false-lock kick, tracking.c:317-323).  uint32
    arithmetic, bit for bit as the JAX package computes it, carried in
    int64 masked to 32 bits."""
    s = seed.to(torch.int64) & _U32
    s = (_u32_mul(s, 1664525) + 1013904223) & _U32
    s = s ^ (s >> 16)
    s = _u32_mul(s, 2246822519)
    return (s >> 8).to(torch.float32) / float(1 << 24)


def track_epoch_step(
    state: TrackState,
    x_epoch: torch.Tensor,         # (S,) complex64 — one 1 ms epoch
    code_table: torch.Tensor,      # (C, 1023) bipolar, or (C, U2P) doubled
    plan: SignalPlan,
    cfg: TrackConfig,
) -> tuple:
    """Advance all channels one epoch.  Returns (new_state, outputs)."""
    fs = plan.sample_rate_hz
    s_cnt = plan.samples_per_epoch
    f32 = torch.float32

    # ---- code NCO: carrier-aided code frequency --------------------------
    code_freq_cps = (
        float(plan.chips_per_sample)
        * (1.0 + state.doppler_hz / FREQ_L1_HZ)
    )

    if cfg.use_pallas:
        # half-chip E/P/L over the doubled upsampled code (code_table =
        # ops.epl.upsampled_code_doubled): the kernel on a CUDA device
        epl = half_chip.epl_correlate(
            x_epoch, code_table, state.code_phase_chips, state.doppler_hz,
            state.carrier_phase_cycles, fs)
        carrier_phase = fma(state.doppler_hz, _f32(s_cnt / fs),
                            state.carrier_phase_cycles)
        carrier_phase = carrier_phase - torch.floor(carrier_phase)
    else:
        lags = (-cfg.epl_spacing_chips, 0.0, cfg.epl_spacing_chips)
        replicas = sample_replicas(
            code_table, state.code_phase_chips, code_freq_cps, s_cnt, lags
        )
        y, carrier_phase = carrier_wipeoff(
            x_epoch, state.doppler_hz, state.carrier_phase_cycles, fs
        )
        epl = epl_correlate(y, replicas)          # (C, 3) complex
    ie, ip, il = epl[:, 0].real, epl[:, 1].real, epl[:, 2].real
    qe, qp, ql = epl[:, 0].imag, epl[:, 1].imag, epl[:, 2].imag
    zero = torch.zeros_like(ip)

    # Epochs that may contain a nav-bit edge (known once bit-synced):
    # freeze DLL and FLL there (nav_data.c:145-218 accurate-sync role).
    rem_pred = torch.remainder(
        state.epoch_idx - state.last_swap_epoch, cfg.codes_in_bit
    )
    edge_zone = state.period_sync_ok & (
        (rem_pred == 0) | (rem_pred == cfg.codes_in_bit - 1)
    )

    # ---- DLL (tracking.c:333-393) ---------------------------------------
    e2 = ie * ie + qe * qe
    l2 = il * il + ql * ql
    code_err_raw = -(e2 - l2) / torch.clamp(e2 + l2, min=1e-12)
    code_err = torch.where(edge_zone, state.dll_err_prev, code_err_raw)
    dll_delta_fine = (
        cfg.dll_c1 * (code_err - state.dll_err_prev)
        + cfg.dll_c2 * cfg.dt_s * code_err
    )
    dll_delta_fine = torch.where(edge_zone, zero, dll_delta_fine)
    # firmware fine units are 1/16 chip (GPS_FINE_RATIO on half-chips)
    dll_delta_chips = dll_delta_fine / cfg.fine_ratio

    # natural code-phase advance over the epoch + DLL correction
    new_code_phase = (
        fma(code_freq_cps, float(s_cnt), state.code_phase_chips)
        + dll_delta_chips
    )
    wrapped_phase = torch.remainder(new_code_phase, float(CODE_LENGTH))
    # Net wraps beyond the nominal one-code-period advance => the
    # "code phase swap" ledger (gps_master.c:228-247 semantics).
    nominal = state.code_phase_chips + float(plan.chips_per_sample) * s_cnt
    code_wrapped = torch.abs(new_code_phase - nominal) > (CODE_LENGTH / 2)

    # ---- PLL (tracking.c:175-209) ---------------------------------------
    phase_err = _costas_phase_err(ip, qp)           # half-cycles
    sync = state.period_sync_ok
    pll_c1 = torch.where(sync, cfg.pll_narrow_c1, cfg.pll_wide_c1).to(f32)
    pll_c2 = torch.where(sync, cfg.pll_narrow_c2, cfg.pll_wide_c2).to(f32)
    pll_delta = (
        pll_c1 * _wrap_half(phase_err - state.pll_err_prev)
        + pll_c2 * cfg.dt_s * phase_err
    ) * cfg.pll_scale

    # ---- FLL (tracking.c:214-256) ---------------------------------------
    theta = phase_err
    freq_diff = _wrap_half(theta - state.fll_theta_prev)
    old_diff = _wrap_half(freq_diff - state.fll_err_prev)
    fll_delta = torch.where(
        state.fll_primed & ~edge_zone,
        (cfg.fll_c1 * cfg.dt_s * old_diff + cfg.fll_c2 * cfg.dt_s * freq_diff)
        * cfg.fll_scale,
        zero,
    )
    new_doppler = state.doppler_hz + pll_delta + fll_delta

    # ---- false-lock watchdog (tracking.c:261-327) -----------------------
    ip_sign = torch.where(ip > 0, 1, -1).to(torch.int8)
    win = torch.cat([state.ip_sign_window[:, 1:], ip_sign[:, None]], dim=1)
    transitions = (win[:, 1:] != win[:, :-1]).to(torch.int32).sum(1)
    window_end = (torch.remainder(state.epoch_idx, cfg.pll_check_window)
                  == cfg.pll_check_window - 1)
    bad = transitions > 1
    bad_cnt = torch.where(
        window_end,
        torch.where(bad, torch.clamp(state.pll_bad_cnt + 1, max=10),
                    torch.clamp(state.pll_bad_cnt - 1, min=0)),
        state.pll_bad_cnt,
    )
    master = torch.where(
        window_end & (bad_cnt > 9),
        state.pll_bad_master_cnt + 1,
        torch.where(window_end & (bad_cnt == 0), 0, state.pll_bad_master_cnt),
    )
    kick = master > cfg.pll_bad_state_threshold
    chan = torch.arange(ip.shape[0], dtype=torch.int64, device=ip.device)
    rand = _lcg_uniform(state.epoch_idx.to(torch.int64) * 37 + chan)
    kick_target = state.acq_doppler_hz + (rand - 0.5) * 500.0
    new_doppler = torch.where(kick, kick_target, new_doppler)
    bad_cnt = torch.where(kick, 0, bad_cnt).to(torch.int32)
    master = torch.where(kick, 0, master).to(torch.int32)

    # ---- SNR (tracking.c:147-169) ---------------------------------------
    snr_i = state.snr_i_sum + torch.abs(ip)
    snr_q = state.snr_q_sum + torch.abs(qp)
    snr_cnt = state.snr_cnt + 1
    snr_done = snr_cnt >= cfg.snr_window_epochs
    snr_db = torch.where(
        snr_done,
        10.0 * torch.log10(torch.clamp(snr_i, min=1e-9)
                           / torch.clamp(snr_q, min=1e-9)),
        state.snr_db,
    )
    snr_i = torch.where(snr_done, zero, snr_i)
    snr_q = torch.where(snr_done, zero, snr_q)
    snr_cnt = torch.where(snr_done, 0, snr_cnt).to(torch.int32)

    # ---- bit sync (nav_data.c:46-138) -----------------------------------
    cib = cfg.codes_in_bit
    epoch = state.epoch_idx
    sign_flip = ip_sign != state.prev_ip_sign
    rem_at_flip = torch.remainder(epoch - state.last_swap_epoch, cib)
    on_grid = (rem_at_flip <= 1) | (rem_at_flip == cib - 1)
    rpc = torch.where(
        sign_flip & on_grid,
        torch.clamp(state.right_period_cnt + 1, max=10),
        torch.where(sign_flip, torch.clamp(state.right_period_cnt - 1, min=0),
                    state.right_period_cnt),
    )
    sync_ok = torch.where(
        sign_flip,
        torch.where(rpc > cfg.bit_sync_up, True,
                    torch.where(rpc < cfg.bit_sync_down, False, sync)),
        sync,
    )
    last_swap = torch.where(sign_flip, epoch, state.last_swap_epoch)

    # bit extraction: nav-bit majority vote (nav_data.c:223-253)
    remainder = torch.remainder(epoch - last_swap, cib).to(torch.int32)
    bit_boundary = sync_ok & (remainder < state.old_remainder)
    bit_value = (state.bit_pos_cnt > state.bit_neg_cnt).to(torch.int8)
    votes = state.bit_pos_cnt + state.bit_neg_cnt
    bit_ready = bit_boundary & (votes > 0)
    bit_epoch = epoch - votes  # epoch at which the completed bit started
    pos_cnt = torch.where(bit_boundary, 0, state.bit_pos_cnt)
    neg_cnt = torch.where(bit_boundary, 0, state.bit_neg_cnt)
    pos_cnt = torch.where(sync_ok & (ip > 0), pos_cnt + 1, pos_cnt)
    neg_cnt = torch.where(sync_ok & (ip <= 0), neg_cnt + 1, neg_cnt)
    ip_sum = torch.where(bit_boundary, zero, state.bit_ip_sum)
    ip_sum = torch.where(sync_ok, ip_sum + ip, ip_sum)
    qp_sum = torch.where(bit_boundary, zero, state.bit_qp_sum)
    qp_sum = torch.where(sync_ok, qp_sum + qp, qp_sum)

    new_state = TrackState(
        carrier_phase_cycles=carrier_phase,
        doppler_hz=new_doppler,
        code_phase_chips=wrapped_phase,
        dll_err_prev=code_err,
        pll_err_prev=phase_err,
        fll_theta_prev=theta,
        fll_err_prev=freq_diff,
        fll_primed=torch.ones_like(state.fll_primed),
        ip_sign_window=win,
        pll_bad_cnt=bad_cnt,
        pll_bad_master_cnt=master,
        acq_doppler_hz=state.acq_doppler_hz,
        snr_i_sum=snr_i,
        snr_q_sum=snr_q,
        snr_cnt=snr_cnt,
        snr_db=snr_db,
        prev_ip_sign=ip_sign,
        last_swap_epoch=last_swap,
        right_period_cnt=rpc.to(torch.int32),
        period_sync_ok=sync_ok,
        old_remainder=remainder,
        bit_pos_cnt=pos_cnt.to(torch.int32),
        bit_neg_cnt=neg_cnt.to(torch.int32),
        bit_ip_sum=ip_sum,
        bit_qp_sum=qp_sum,
        epoch_idx=epoch + 1,
        code_wraps=state.code_wraps + code_wrapped.to(torch.int32),
        ext_ip_sum=state.ext_ip_sum,
        ext_qp_sum=state.ext_qp_sum,
        ext_bit_cnt=state.ext_bit_cnt,
    )
    if cfg.emit_correlators:
        diag = dict(ie=ie, qe=qe, il=il, ql=ql)
    else:
        z = torch.zeros((0,), dtype=f32, device=ip.device)
        diag = dict(ie=z, qe=z, il=z, ql=z)
    outputs = TrackOutputs(
        ip=ip, qp=qp, **diag,
        code_phase_chips=state.code_phase_chips,
        doppler_hz=new_doppler,
        snr_db=snr_db,
        bit_ready=bit_ready,
        bit_value=bit_value,
        bit_epoch=bit_epoch,
        period_sync_ok=sync_ok,
        code_wrapped=code_wrapped,
    )
    return new_state, outputs


def _stack_outputs(steps) -> TrackOutputs:
    """Stack per-epoch TrackOutputs into (T, C) leaves (zero-size
    diagnostics placeholders stay zero-size)."""
    fields = []
    for leaves in zip(*steps):
        if leaves[0].numel() == 0:
            fields.append(leaves[0])
        else:
            fields.append(torch.stack(leaves))
    return TrackOutputs(*fields)


def track_block(
    state: TrackState,
    epochs: torch.Tensor,          # (T, S) complex64
    code_table: torch.Tensor,      # (C, 1023), or (C, U2P) doubled
    plan: SignalPlan,
    cfg: TrackConfig,
) -> tuple:
    """Scan ``T`` epochs of signal through all channels.

    Returns ``(final_state, TrackOutputs with (T, C) leaves)``.

    When ``cfg.in_kernel_scan`` resolves to True for the device of
    ``epochs`` the whole loop runs as the tracking-scan kernel
    (ops.track_scan.track_block_kernel); the ``code_table`` must then be
    the doubled upsampled table, as for ``cfg.use_pallas``.
    """
    check_supported(cfg)
    if resolve_in_kernel_scan(cfg, epochs.device):
        from ..ops.track_scan import track_block_kernel

        return track_block_kernel(state, epochs, code_table, plan, cfg)
    steps = []
    for t in range(epochs.shape[0]):
        state, out = track_epoch_step(state, epochs[t], code_table, plan, cfg)
        steps.append(out)
    return state, _stack_outputs(steps)
