"""The tracking scan as one kernel: T epochs x C channels per launch.

Counterpart of the JAX package's ops/pallas_track_scan.py (its Pallas TPU
kernel K1).  ``track_block_kernel`` is the drop-in for
``track.scan.track_block`` that the Receiver dispatches when
``TrackConfig.in_kernel_scan`` resolves to True; it runs
:func:`track_scan`, which takes

* :func:`track_scan_cuda`, the hand-written Hopper kernel
  (``csrc/track_scan.cu``), for tensors on a CUDA device, and
* :func:`track_scan_reference`, its plain torch version, for tensors on
  the CPU.

There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.

Both compute, per epoch and channel, the half-chip E/P/L correlator of
ops.epl with the carrier rotated off exactly per sample, then the loop
update of K1's default path: DLL, the polynomial Costas discriminator of
K1 (kept so the port stays closest to the production kernel), FLL, the
false-lock watchdog with its integer LCG kick, the SNR window latch and
bit sync.  K1's carrier-ramp cache (and its ``ramp``/``dref`` state) is
not carried over: the exact per-sample carrier is what the reference
scan's half-chip mode computes, and sincospif is cheap on the card.

Kernel state (:class:`ScanState`): the f32 and i32 planes in
``_F32_FIELDS``/``_I32_FIELDS`` order as (16, C) and (14, C) tensors and
the watchdog sign window (W, C).  Output: a (T, 11, C) float32 slot
stream, layout at ``NOUT``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import CODE_LENGTH, FREQ_L1_HZ, SignalPlan, TrackConfig
from ..track.scan import _lcg_uniform, _wrap_half, check_supported
from ..track.state import TrackOutputs, TrackState
from .epl import S, U2P, epl_correlate_halfchip
from .wipeoff import _f32, fma

_F32_FIELDS = (
    "code_phase", "doppler", "carrier_phase",
    "dll_prev", "pll_prev", "fll_theta", "fll_err", "acq_doppler",
    "snr_i_sum", "snr_q_sum", "snr_li", "snr_lq", "bit_ip_sum",
    "bit_qp_sum", "ext_ip_sum", "ext_qp_sum",
)
_I32_FIELDS = (
    "fll_primed", "prev_sign", "last_swap", "rpc", "sync",
    "old_rem", "pos_cnt", "neg_cnt", "bad_cnt", "master_cnt",
    "snr_cnt", "epoch", "code_wraps", "ext_cnt",
)
NF32 = len(_F32_FIELDS)
NI32 = len(_I32_FIELDS)
# per-epoch output slots: 0 ip, 1 qp, 2 code_phase (epoch start),
# 3 doppler (updated), 4 bit_ready, 5 bit_value, 6 bit_epoch,
# 7 period_sync_ok, 8 snr_li (latched |I| window sum), 9 code_wrapped,
# 10 snr_lq (latched |Q| window sum; snr_db = 10*log10(li/lq) is taken
# outside the kernel, in outputs_from_raw)
NOUT = 11
MAX_WIN = 32       # csrc/track_epoch.cuh MAX_WIN


class ScanState(NamedTuple):
    """Kernel state: f32 (NF32, C), i32 (NI32, C) int32 planes and the
    watchdog sign window (W, C) int32 (row W-1 newest)."""

    f32: torch.Tensor
    i32: torch.Tensor
    win: torch.Tensor


def state_from_track_state(ts: TrackState) -> ScanState:
    """Pack a TrackState into the kernel planes.  The kernel carries the
    latched SNR window sums (snr_li, snr_lq), not the dB value; entering
    from a TrackState rebuilds an equivalent pair, 10^(db/10) against
    1.0 — exact for db = 0 and within ~1e-6 dB otherwise."""
    snr_li = torch.exp(ts.snr_db.to(torch.float32)
                       * (math.log(10.0) / 10.0))
    f32 = torch.stack([
        ts.code_phase_chips, ts.doppler_hz, ts.carrier_phase_cycles,
        ts.dll_err_prev, ts.pll_err_prev, ts.fll_theta_prev,
        ts.fll_err_prev, ts.acq_doppler_hz,
        ts.snr_i_sum, ts.snr_q_sum, snr_li, torch.ones_like(snr_li),
        ts.bit_ip_sum, ts.bit_qp_sum, ts.ext_ip_sum, ts.ext_qp_sum,
    ]).to(torch.float32)
    i32 = torch.stack([
        ts.fll_primed, ts.prev_ip_sign, ts.last_swap_epoch,
        ts.right_period_cnt, ts.period_sync_ok, ts.old_remainder,
        ts.bit_pos_cnt, ts.bit_neg_cnt, ts.pll_bad_cnt,
        ts.pll_bad_master_cnt, ts.snr_cnt, ts.epoch_idx, ts.code_wraps,
        ts.ext_bit_cnt,
    ]).to(torch.int32)
    win = ts.ip_sign_window.to(torch.int32).T.contiguous()
    return ScanState(f32=f32, i32=i32, win=win)


def _snr_db_from_sums(li: torch.Tensor, lq: torch.Tensor) -> torch.Tensor:
    """10*log10(|I|sum / |Q|sum) from the latched window sums
    (tracking.c:147-169).  Latched zeros (no window completed yet) map to
    0 dB exactly, the reference scan's initial snr_db."""
    return 10.0 * torch.log10(torch.clamp(li, min=1e-9)
                              / torch.clamp(lq, min=1e-9))


def state_to_track_state(ps: ScanState) -> TrackState:
    """Unpack the kernel planes into a TrackState."""
    f, i = ps.f32, ps.i32
    return TrackState(
        carrier_phase_cycles=f[2],
        doppler_hz=f[1],
        code_phase_chips=f[0],
        dll_err_prev=f[3],
        pll_err_prev=f[4],
        fll_theta_prev=f[5],
        fll_err_prev=f[6],
        fll_primed=i[0].to(torch.bool),
        ip_sign_window=ps.win.T.to(torch.int8),
        pll_bad_cnt=i[8],
        pll_bad_master_cnt=i[9],
        acq_doppler_hz=f[7],
        snr_i_sum=f[8],
        snr_q_sum=f[9],
        snr_cnt=i[10],
        snr_db=_snr_db_from_sums(f[10], f[11]),
        prev_ip_sign=i[1].to(torch.int8),
        last_swap_epoch=i[2],
        right_period_cnt=i[3],
        period_sync_ok=i[4].to(torch.bool),
        old_remainder=i[5],
        bit_pos_cnt=i[6],
        bit_neg_cnt=i[7],
        bit_ip_sum=f[12],
        bit_qp_sum=f[13],
        epoch_idx=i[11],
        code_wraps=i[12],
        ext_ip_sum=f[14],
        ext_qp_sum=f[15],
        ext_bit_cnt=i[13],
    )


def outputs_from_raw(out: torch.Tensor) -> TrackOutputs:
    """Unpack the (T, NOUT, C) slot stream into TrackOutputs."""
    z = torch.zeros((0,), dtype=torch.float32, device=out.device)
    return TrackOutputs(
        ip=out[:, 0],
        qp=out[:, 1],
        ie=z, qe=z, il=z, ql=z,
        code_phase_chips=out[:, 2],
        doppler_hz=out[:, 3],
        snr_db=_snr_db_from_sums(out[:, 8], out[:, 10]),
        bit_ready=out[:, 4] > 0.5,
        bit_value=out[:, 5].to(torch.int8),
        bit_epoch=out[:, 6].to(torch.int32),
        period_sync_ok=out[:, 7] > 0.5,
        code_wrapped=out[:, 9] > 0.5,
    )


def _check(state: ScanState, epochs: torch.Tensor, u2: torch.Tensor,
           plan: SignalPlan, cfg: TrackConfig) -> None:
    """Raise on what the kernel and its plain version do not take."""
    check_supported(cfg)
    if cfg.emit_correlators:
        raise NotImplementedError(
            "emit_correlators is not ported to the tracking-scan kernel: "
            "ROADMAP Queue 1 (coherent modes in K1)")
    if plan.samples_per_epoch != S or plan.chips_per_sample != 0.5:
        raise ValueError("the tracking scan needs the 2.046 MHz baseband "
                         "plan (2046 samples per epoch)")
    c = u2.shape[0]
    w = cfg.pll_check_window
    if not 2 <= w <= MAX_WIN:
        raise ValueError(f"pll_check_window must be in [2, {MAX_WIN}]")
    want = {
        "f32": (state.f32, (NF32, c), torch.float32),
        "i32": (state.i32, (NI32, c), torch.int32),
        "win": (state.win, (w, c), torch.int32),
        "u2": (u2, (c, U2P), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != epochs.device:
            raise ValueError(f"{name} is on {t.device}, epochs on "
                             f"{epochs.device}")
    if epochs.dim() != 2 or epochs.shape[1] != S or \
            epochs.dtype != torch.complex64:
        raise ValueError(f"epochs: want (T, {S}) complex64, got "
                         f"{tuple(epochs.shape)} {epochs.dtype}")


def _costas_err_poly(ip: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """atan2(qp*sign(ip), |ip|)/pi without atan2: octant fold and a
    9th-order polynomial (the JAX kernel's discriminator,
    pallas_track_scan.py:238-254), ~1e-5 rad from atan2."""
    y = qp * torch.sign(ip)
    ax = torch.abs(ip)
    ay = torch.abs(y)
    z = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    z2 = z * z
    p = 0.0208351 * z2
    p = p - 0.0851330
    p = p * z2 + 0.1801410
    p = p * z2 - 0.3302995
    p = p * z2 + 0.9998660
    a = z * p
    a = torch.where(ay > ax, math.pi / 2 - a, a)
    return torch.sign(y) * a / math.pi


def track_scan_reference(state: ScanState, epochs: torch.Tensor,
                         u2: torch.Tensor, plan: SignalPlan,
                         cfg: TrackConfig) -> tuple:
    """Plain torch version of the tracking-scan kernel: a Python loop over
    epochs, vectorized over channels.  Returns ``(new_state, out)`` with
    out (T, NOUT, C) float32.  The CPU tests and chip_smoke.py hold the
    kernel to it; ``track_scan_reference.calls`` counts its runs."""
    _check(state, epochs, u2, plan, cfg)
    track_scan_reference.calls += 1
    fs = plan.sample_rate_hz
    cps = float(plan.chips_per_sample)
    cib = cfg.codes_in_bit
    w_len = cfg.pll_check_window
    (cp, dop, ph, dll_prev, pll_prev, fll_theta, fll_err, acq_dop, snr_i,
     snr_q, snr_li, snr_lq, bit_ip, bit_qp, ext_ip, ext_qp) = state.f32
    (fll_primed, prev_sign, last_swap, rpc, sync, old_rem, pos_cnt,
     neg_cnt, bad_cnt, master, snr_cnt, epoch, wraps, ext_cnt) = state.i32
    win = state.win
    rem = torch.remainder(epoch - last_swap, cib)
    wcnt = torch.remainder(epoch, w_len)
    chan = torch.arange(u2.shape[0], dtype=torch.int64, device=u2.device)
    zero = torch.zeros_like(cp)
    one = torch.ones_like(epoch)
    outs = []
    for t in range(epochs.shape[0]):
        epl = epl_correlate_halfchip(epochs[t], u2, cp, dop, ph, fs)
        ie, ip, il = epl[:, 0].real, epl[:, 1].real, epl[:, 2].real
        qe, qp, ql = epl[:, 0].imag, epl[:, 1].imag, epl[:, 2].imag
        in_sync = sync == 1

        edge = in_sync & ((rem == 0) | (rem == cib - 1))

        # DLL (tracking.c:333-393)
        e2 = ie * ie + qe * qe
        l2 = il * il + ql * ql
        cerr_raw = -(e2 - l2) / torch.clamp(e2 + l2, min=1e-12)
        cerr = torch.where(edge, dll_prev, cerr_raw)
        ddelta = torch.where(
            edge, zero,
            cfg.dll_c1 * (cerr - dll_prev) + cfg.dll_c2 * cfg.dt_s * cerr,
        ) / cfg.fine_ratio
        code_freq = cps * (1.0 + dop / FREQ_L1_HZ)
        unwrapped = fma(code_freq, float(S), cp) + ddelta
        new_cp = torch.remainder(unwrapped, float(CODE_LENGTH))
        nominal = cp + cps * S
        wrapped = torch.abs(unwrapped - nominal) > (CODE_LENGTH / 2)

        # Costas PLL (tracking.c:175-209)
        perr = _costas_err_poly(ip, qp)
        c1 = torch.where(in_sync, cfg.pll_narrow_c1,
                         cfg.pll_wide_c1).to(torch.float32)
        c2 = torch.where(in_sync, cfg.pll_narrow_c2,
                         cfg.pll_wide_c2).to(torch.float32)
        pll_delta = (
            c1 * _wrap_half(perr - pll_prev) + c2 * cfg.dt_s * perr
        ) * cfg.pll_scale

        # FLL (tracking.c:214-256)
        fdiff = _wrap_half(perr - fll_theta)
        odiff = _wrap_half(fdiff - fll_err)
        fll_delta = torch.where(
            (fll_primed == 1) & ~edge,
            (cfg.fll_c1 * cfg.dt_s * odiff + cfg.fll_c2 * cfg.dt_s * fdiff)
            * cfg.fll_scale,
            zero,
        )
        new_dop = dop + pll_delta + fll_delta
        new_ph = fma(dop, _f32(S / fs), ph)
        new_ph = new_ph - torch.floor(new_ph)

        # false-lock watchdog (tracking.c:261-327): transitions of the
        # window after this epoch's sign shifts in
        sgn = torch.where(ip > 0, 1, -1).to(torch.int32)
        trans = (sgn != win[w_len - 1]).to(torch.int32)
        for k in range(2, w_len):
            trans = trans + (win[k] != win[k - 1]).to(torch.int32)
        win = torch.cat([win[1:], sgn[None]], dim=0)
        wend = wcnt == w_len - 1
        bad2 = torch.where(
            wend,
            torch.where(trans > 1, torch.clamp(bad_cnt + 1, max=10),
                        torch.clamp(bad_cnt - 1, min=0)),
            bad_cnt,
        )
        master2 = torch.where(
            wend & (bad2 > 9), master + 1,
            torch.where(wend & (bad2 == 0), 0, master))
        kick = master2 > cfg.pll_bad_state_threshold
        u = _lcg_uniform(epoch.to(torch.int64) * 37 + chan)
        new_dop = torch.where(kick, acq_dop + (u - 0.5) * 500.0, new_dop)
        bad2 = torch.where(kick, 0, bad2).to(torch.int32)
        master2 = torch.where(kick, 0, master2).to(torch.int32)

        # SNR window (tracking.c:147-169): latch the completed sums
        snr_i2 = snr_i + torch.abs(ip)
        snr_q2 = snr_q + torch.abs(qp)
        cnt2 = snr_cnt + 1
        done = cnt2 >= cfg.snr_window_epochs
        snr_li = torch.where(done, snr_i2, snr_li)
        snr_lq = torch.where(done, snr_q2, snr_lq)
        snr_i = torch.where(done, zero, snr_i2)
        snr_q = torch.where(done, zero, snr_q2)
        snr_cnt = torch.where(done, 0, cnt2).to(torch.int32)

        # bit sync (nav_data.c:46-138)
        flip = sgn != prev_sign
        on_grid = (rem <= 1) | (rem == cib - 1)
        rpc = torch.where(
            flip & on_grid, torch.clamp(rpc + 1, max=10),
            torch.where(flip, torch.clamp(rpc - 1, min=0), rpc))
        sync2 = torch.where(
            flip,
            torch.where(rpc > cfg.bit_sync_up, 1,
                        torch.where(rpc < cfg.bit_sync_down, 0, sync)),
            sync).to(torch.int32)
        last_swap = torch.where(flip, epoch, last_swap)
        rem2 = torch.where(flip, 0, rem).to(torch.int32)
        boundary = (sync2 == 1) & (rem2 < old_rem)
        votes = pos_cnt + neg_cnt
        bit_val = (pos_cnt > neg_cnt).to(torch.int32)
        bit_ready = boundary & (votes > 0)
        bit_epoch = epoch - votes
        p2 = torch.where(boundary, 0, pos_cnt)
        n2 = torch.where(boundary, 0, neg_cnt)
        pos_cnt = torch.where((sync2 == 1) & (ip > 0), p2 + 1, p2)
        neg_cnt = torch.where((sync2 == 1) & (ip <= 0), n2 + 1, n2)
        ip_sum2 = torch.where(boundary, zero, bit_ip)
        bit_ip = torch.where(sync2 == 1, ip_sum2 + ip, ip_sum2)
        qp_sum2 = torch.where(boundary, zero, bit_qp)
        bit_qp = torch.where(sync2 == 1, qp_sum2 + qp, qp_sum2)

        # carried remainders
        rem = torch.where(rem2 + 1 == cib, 0, rem2 + 1)
        wcnt = torch.where(wcnt + 1 == w_len, 0, wcnt + 1)

        outs.append(torch.stack([
            ip, qp, cp, new_dop, bit_ready.to(torch.float32),
            bit_val.to(torch.float32), bit_epoch.to(torch.float32),
            sync2.to(torch.float32), snr_li, wrapped.to(torch.float32),
            snr_lq,
        ]))
        cp, dop, ph = new_cp, new_dop, new_ph
        dll_prev, pll_prev, fll_theta, fll_err = cerr, perr, perr, fdiff
        fll_primed, prev_sign, sync, old_rem = one, sgn, sync2, rem2
        bad_cnt, master = bad2, master2
        epoch = epoch + 1
        wraps = wraps + wrapped.to(torch.int32)
    f32 = torch.stack([
        cp, dop, ph, dll_prev, pll_prev, fll_theta, fll_err, acq_dop, snr_i,
        snr_q, snr_li, snr_lq, bit_ip, bit_qp, ext_ip, ext_qp])
    i32 = torch.stack([
        fll_primed, prev_sign, last_swap, rpc, sync, old_rem, pos_cnt,
        neg_cnt, bad_cnt, master, snr_cnt, epoch, wraps,
        ext_cnt]).to(torch.int32)
    if outs:
        out = torch.stack(outs)
    else:
        out = torch.zeros((0, NOUT, u2.shape[0]), dtype=torch.float32,
                          device=u2.device)
    return ScanState(f32=f32, i32=i32, win=win), out


track_scan_reference.calls = 0


def kernel_params(plan: SignalPlan, cfg: TrackConfig) -> tuple:
    """(float32[16], int32[6]) loop constants in the order of
    csrc/track_epoch.cuh params_from_arrays, each rounded to float32 as
    the plain version's torch ops round the same Python constants."""
    fs = plan.sample_rate_hz
    fp = np.array([
        fs, plan.chips_per_sample, FREQ_L1_HZ, S / fs,
        cfg.dll_c1, cfg.dll_c2 * cfg.dt_s, cfg.fine_ratio,
        cfg.pll_wide_c1, cfg.pll_wide_c2, cfg.pll_narrow_c1,
        cfg.pll_narrow_c2, cfg.dt_s, cfg.pll_scale,
        cfg.fll_c1 * cfg.dt_s, cfg.fll_c2 * cfg.dt_s, cfg.fll_scale,
    ], dtype=np.float32)
    ip = np.array([
        cfg.codes_in_bit, cfg.pll_check_window, cfg.snr_window_epochs,
        min(cfg.pll_bad_state_threshold, np.iinfo(np.int32).max),
        cfg.bit_sync_up, cfg.bit_sync_down,
    ], dtype=np.int32)
    return fp, ip


def track_scan_cuda(state: ScanState, epochs: torch.Tensor,
                    u2: torch.Tensor, plan: SignalPlan,
                    cfg: TrackConfig) -> tuple:
    """Launch the tracking-scan kernel (csrc/track_scan.cu) on the card.

    Same contract as :func:`track_scan_reference`.  The input state is
    left as it is: the kernel updates fresh copies of the planes in
    place.  ``track_scan_cuda.launches`` counts kernel launches."""
    from .kernel_lib import cuda_lib

    if not epochs.is_cuda:
        raise ValueError("track_scan_cuda needs CUDA tensors")
    _check(state, epochs, u2, plan, cfg)
    for name, t in (("epochs", epochs), ("u2", u2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t_cnt, c = epochs.shape[0], u2.shape[0]
    f32, i32, win = (t.clone(memory_format=torch.contiguous_format)
                     for t in state)
    out = torch.empty((t_cnt, NOUT, c), dtype=torch.float32,
                      device=epochs.device)
    if t_cnt == 0 or c == 0:
        return ScanState(f32=f32, i32=i32, win=win), out
    fp, ip = kernel_params(plan, cfg)
    x = torch.view_as_real(epochs)
    lib = cuda_lib()
    with torch.cuda.device(epochs.device):
        stream = torch.cuda.current_stream(epochs.device).cuda_stream
        rc = lib.track_scan_launch(
            x.data_ptr(), u2.data_ptr(), f32.data_ptr(), i32.data_ptr(),
            win.data_ptr(), out.data_ptr(), t_cnt, c,
            fp.ctypes.data, ip.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"track_scan kernel launch failed: CUDA error {rc}")
    track_scan_cuda.launches += 1
    return ScanState(f32=f32, i32=i32, win=win), out


track_scan_cuda.launches = 0


def track_scan_host(state: ScanState, epochs: torch.Tensor,
                    u2: torch.Tensor, plan: SignalPlan,
                    cfg: TrackConfig) -> tuple:
    """The kernel's arithmetic built for the host with g++
    (csrc/track_scan_host.cpp) on CPU tensors: the check of the CUDA
    source on a machine without a GPU.  Same contract as
    :func:`track_scan_reference`."""
    from .kernel_lib import host_lib

    _check(state, epochs, u2, plan, cfg)
    t_cnt, c = epochs.shape[0], u2.shape[0]
    x = torch.view_as_real(epochs.contiguous())
    u2 = u2.contiguous()
    f32, i32, win = (t.clone(memory_format=torch.contiguous_format)
                     for t in state)
    out = torch.empty((t_cnt, NOUT, c), dtype=torch.float32)
    fp, ip = kernel_params(plan, cfg)
    rc = host_lib().track_scan_host(
        x.data_ptr(), u2.data_ptr(), f32.data_ptr(), i32.data_ptr(),
        win.data_ptr(), out.data_ptr(), t_cnt, c, fp.ctypes.data,
        ip.ctypes.data)
    if rc != 0:
        raise RuntimeError("track_scan_host: half-chip shift out of range")
    return ScanState(f32=f32, i32=i32, win=win), out


def track_scan(state: ScanState, epochs: torch.Tensor, u2: torch.Tensor,
               plan: SignalPlan, cfg: TrackConfig) -> tuple:
    """Run T epochs through the tracking scan: the kernel for CUDA
    tensors, its plain version for CPU tensors."""
    if epochs.is_cuda:
        return track_scan_cuda(state, epochs, u2, plan, cfg)
    if epochs.device.type == "cpu":
        return track_scan_reference(state, epochs, u2, plan, cfg)
    raise ValueError(f"no tracking scan for device {epochs.device}")


def track_block_kernel(state: TrackState, epochs: torch.Tensor,
                       u2: torch.Tensor, plan: SignalPlan,
                       cfg: TrackConfig) -> tuple:
    """Drop-in for track.scan.track_block running the tracking-scan
    kernel: ``(final TrackState, TrackOutputs with (T, C) leaves)``.  The
    ScanState is rebuilt from the TrackState on every call; the Receiver
    carries the ScanState itself between blocks
    (runtime.receiver._track_and_digest_carried)."""
    ps, raw = track_scan(state_from_track_state(state), epochs, u2, plan,
                         cfg)
    return state_to_track_state(ps), outputs_from_raw(raw)
