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

:func:`track_block` is ``lax.scan`` of :func:`track_epoch_step` (the
per-epoch reference scan) in step form (utils.graphs.scan): on the card
one captured graph of the step, replayed once an epoch, as the JAX
package's ``jax.jit`` of the scan is one program; on the CPU the same
step form eagerly.  When ``cfg.in_kernel_scan`` resolves to True the
whole block runs as the tracking-scan kernel (ops.track_scan), one
launch.  In half-chip mode (``cfg.use_pallas``) each epoch's E/P/L goes
through ops.epl.epl_correlate, which launches the per-epoch kernel
(csrc/epl.cu) for CUDA tensors and runs its plain torch version for CPU
tensors; that scan is also the spec the tracking-scan kernel is held to.
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
from ..utils import graphs
from .state import TrackOutputs, TrackState

_U32 = 0xFFFFFFFF


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
        # made on the device (no host copy inside a captured step): the
        # float32 values of (-spacing, 0, +spacing)
        lags = cfg.epl_spacing_chips * torch.arange(
            -1, 2, dtype=f32, device=code_table.device)
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

    # ---- 20 ms coherent PLL (coherent_pll) -------------------------------
    # Once synced, close the Costas loop on the coherent prompt sums of
    # each completed bit instead of per-epoch prompts: the grid is frozen
    # (sign_flip masked below), so the bit boundary is derivable from the
    # un-rebased swap epoch.
    phase_err_store = phase_err
    ext_ip = state.ext_ip_sum
    ext_qp = state.ext_qp_sum
    ext_cnt = state.ext_bit_cnt
    if cfg.coherent_pll:
        in_sync = state.period_sync_ok
        bit_done = in_sync & (rem_pred < state.old_remainder)
        if cfg.pll_ext_bits > 1:
            # extended K-bit data-wipeoff PLL: each completed bit's
            # coherent prompt vector is sign-decided (the nav-bit decision
            # removes the data modulation) and accumulated; the Costas
            # loop closes on the K-bit coherent sum every K bits
            d = torch.where(state.bit_ip_sum >= 0, 1.0, -1.0)
            ext_ip = ext_ip + torch.where(bit_done, d * state.bit_ip_sum,
                                          zero)
            ext_qp = ext_qp + torch.where(bit_done, d * state.bit_qp_sum,
                                          zero)
            ext_cnt = ext_cnt + bit_done.to(torch.int32)
            ext_done = bit_done & (ext_cnt >= cfg.pll_ext_bits)
            perr_ext = _costas_phase_err(ext_ip, ext_qp)
            dt_ext = cfg.pll_ext_bits * cfg.codes_in_bit * cfg.dt_s
            pll_delta_ext = (
                cfg.pll_ext_c1 * _wrap_half(perr_ext - state.pll_err_prev)
                + cfg.pll_ext_c2 * dt_ext * perr_ext
            ) * cfg.pll_ext_scale
            pll_delta = torch.where(
                in_sync, torch.where(ext_done, pll_delta_ext, zero),
                pll_delta)
            phase_err_store = torch.where(
                in_sync, torch.where(ext_done, perr_ext, state.pll_err_prev),
                phase_err)
            # reset the accumulator after each update; clear stale sums
            # whenever sync is lost
            clear = ext_done | ~in_sync
            ext_ip = torch.where(clear, zero, ext_ip)
            ext_qp = torch.where(clear, zero, ext_qp)
            ext_cnt = torch.where(clear, 0, ext_cnt).to(torch.int32)
        else:
            perr_bit = _costas_phase_err(state.bit_ip_sum, state.bit_qp_sum)
            dt_bit = cfg.codes_in_bit * cfg.dt_s
            pll_delta_bit = (
                cfg.pll_bit_c1 * _wrap_half(perr_bit - state.pll_err_prev)
                + cfg.pll_bit_c2 * dt_bit * perr_bit
            ) * cfg.pll_bit_scale
            pll_delta = torch.where(
                in_sync, torch.where(bit_done, pll_delta_bit, zero),
                pll_delta)
            phase_err_store = torch.where(
                in_sync, torch.where(bit_done, perr_bit, state.pll_err_prev),
                phase_err)
        fll_delta = torch.where(in_sync, zero, fll_delta)

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
    if cfg.coherent_pll:
        # the per-epoch sign-transition statistic is meaningless at the
        # C/N0 this mode targets: freeze the watchdog while synced
        hold = state.period_sync_ok
        win = torch.where(hold[:, None], state.ip_sign_window, win)
        bad_cnt = torch.where(hold, state.pll_bad_cnt, bad_cnt)
        master = torch.where(hold, state.pll_bad_master_cnt, master)
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
    if cfg.coherent_bit_vote or cfg.coherent_pll:
        # grid-locked mode: once synced, flips neither rebase the boundary
        # nor feed the sync counters
        sign_flip = sign_flip & ~state.period_sync_ok
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

    # bit extraction: nav-bit majority vote (nav_data.c:223-253), or the
    # sign of the coherent prompt-I sum over the bit (coherent_bit_vote:
    # the full bit-length integration gain reaches the decision)
    remainder = torch.remainder(epoch - last_swap, cib).to(torch.int32)
    bit_boundary = sync_ok & (remainder < state.old_remainder)
    if cfg.coherent_bit_vote or cfg.coherent_pll:
        bit_value = (state.bit_ip_sum > 0).to(torch.int8)
    else:
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
        pll_err_prev=phase_err_store,
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
        ext_ip_sum=ext_ip,
        ext_qp_sum=ext_qp,
        ext_bit_cnt=ext_cnt,
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


def track_block(
    state: TrackState,
    epochs: torch.Tensor,          # (T, S) complex64
    code_table: torch.Tensor,      # (C, 1023), or (C, U2P) doubled
    plan: SignalPlan,
    cfg: TrackConfig,
) -> tuple:
    """Scan ``T`` epochs of signal through all channels.

    Returns ``(final_state, TrackOutputs with (T, C) leaves)``; the E/L
    diagnostics stay zero-size placeholders unless cfg.emit_correlators.

    When ``cfg.in_kernel_scan`` resolves to True for the state's device
    the whole loop runs as the tracking-scan kernel
    (ops.track_scan.track_block_kernel); the ``code_table`` must then be
    the doubled upsampled table, as for ``cfg.use_pallas``.  On the card
    ``epochs`` may also be a host tensor: it is copied once, into the
    program's input.
    """
    if resolve_in_kernel_scan(cfg, state.doppler_hz.device):
        from ..ops.track_scan import track_block_kernel

        return track_block_kernel(state, epochs, code_table, plan, cfg)
    state, outs = graphs.scan(track_epoch_step, state, epochs,
                              (code_table,), (plan, cfg))
    return state, TrackOutputs(*(
        v.reshape(-1) if math.prod(v.shape[1:]) == 0 else v for v in outs))
