"""Device-side block digest: shrink per-block host readback to events
(torch port of the JAX package's runtime/digest.py).

The host consumes ~50 bps/channel of a block's (T, C) tracking outputs:
nav-bit events, the last-epoch loop state, and a few windowed
statistics.  :func:`digest_block` reduces the whole block ON THE DEVICE
to a fixed-shape digest, so the raw outputs never leave it:

* nav-bit events, compacted to a static capacity of T//codes_in_bit + 8
  per channel;
* last-epoch code phase / Doppler / SNR / sync flags;
* the drift-detrended code-phase filter (gps_master_filter_code_phase
  capability, gps_master.c:332-388);
* M2M4 C/N0 moments over bit-edge-clean epochs;
* the block's Doppler integral (carrier-phase observable increment);
* the prompt sign-flip histogram and block-edge state that the aided
  bit sync reads (runtime.receiver.Receiver._aided_sync_from_digest).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CODE_LENGTH, FREQ_L1_HZ, TrackConfig
from ..utils import graphs


class BlockDigest(NamedTuple):
    """Fixed-shape per-block summary (leaves sized (K, C) or (C,))."""

    bit_count: torch.Tensor       # (C,) i32 — events this block
    bit_value: torch.Tensor       # (K, C) i8, valid rows < bit_count
    bit_epoch: torch.Tensor       # (K, C) i32
    code_phase_chips: torch.Tensor  # (C,) f32 — last epoch
    code_phase_filtered: torch.Tensor  # (C,) f32 — detrended mean
    doppler_hz: torch.Tensor      # (C,) f32 — last epoch
    doppler_sum: torch.Tensor     # (C,) f32 — sum over the block
    snr_db: torch.Tensor          # (C,) f32 — last epoch
    period_sync_ok: torch.Tensor  # (C,) bool — last epoch
    sync_any_loss: torch.Tensor   # (C,) bool — any un-synced epoch
    last_unsync_epoch: torch.Tensor  # (C,) i32 — block-relative, -1 if none
    cn0_m2: torch.Tensor          # (C,) f32 — mean prompt power (clean)
    cn0_m4: torch.Tensor          # (C,) f32 — mean squared power (clean)
    cn0_n: torch.Tensor           # (C,) i32 — clean epochs used
    flip_hist: torch.Tensor       # (cib, C) i32 — prompt-I sign flips by
    #                               GLOBAL epoch residue mod codes_in_bit
    first_ip_sign: torch.Tensor   # (C,) i8 — prompt-I sign, first epoch
    last_ip_sign: torch.Tensor    # (C,) i8 — prompt-I sign, last epoch
    code_phase_first: torch.Tensor  # (C,) f32 — code phase at block start
    swap_residue: torch.Tensor    # (C,) i32 — last_swap_epoch % cib at end


def digest_block(outs, final_state, cfg: TrackConfig, code_filter_len: int,
                 enable_code_filter: bool) -> BlockDigest:
    """Reduce TrackOutputs (T, C) to a BlockDigest with torch ops on the
    outputs' device.  ``final_state`` is the TrackState the scan returned
    (its epoch ledger dates the block and its swap ledger locates the
    current bit grid)."""
    ready = outs.bit_ready
    t_cnt, c_cnt = ready.shape
    dev = ready.device
    # Capacity: one bit per codes_in_bit epochs once synced, plus slack
    # for pre-sync flip re-basing, which can complete spurious short
    # "bits" faster than the bit cadence.  bit_count is clamped to cap so
    # a pathological block drops the LATEST events.
    cap = t_cnt // max(cfg.codes_in_bit, 1) + 8
    bit_count = torch.clamp(ready.sum(0), max=cap).to(torch.int32)
    # compact ragged bit events to (cap, C): the k-th ready epoch (in time
    # order) lands in row k; epochs without an event, and events past cap,
    # scatter into a spill row that is dropped
    row = torch.cumsum(ready.to(torch.int64), dim=0) - 1          # (T, C)
    dest = torch.where(ready & (row < cap), row, torch.full_like(row, cap))

    def compact(a):
        buf = torch.zeros((cap + 1, c_cnt), dtype=torch.int32, device=dev)
        return buf.scatter_(0, dest, a.to(torch.int32))[:cap]

    # rows >= bit_count[c] are zero; consumers only read k < bit_count
    bit_value = compact(outs.bit_value).to(torch.int8)
    bit_epoch = compact(outs.bit_epoch)

    # M2M4 C/N0 moments over bit-edge-clean epochs (the edge epoch and its
    # predecessor carry attenuated prompts)
    nxt = torch.cat([ready[1:], torch.zeros_like(ready[:1])], dim=0)
    clean = ~(ready | nxt)
    p = outs.ip * outs.ip + outs.qp * outs.qp
    zero = torch.zeros_like(p)
    n_clean = clean.sum(0).to(torch.int32)
    denom = torch.clamp(n_clean.to(torch.float32), min=1.0)
    m2 = torch.where(clean, p, zero).sum(0) / denom
    # scale p by 1/m2 before squaring so the f32 fourth moment keeps
    # relative precision independent of signal level
    m2s = torch.clamp(m2, min=1e-20)
    pn = p / m2s[None, :]
    m4 = torch.where(clean, pn * pn, zero).sum(0) / denom

    # drift-detrended code filter (receiver._filtered_code_phase math)
    cp = outs.code_phase_chips
    dop_last = outs.doppler_hz[-1]
    if enable_code_filter:
        k = min(code_filter_len, t_cnt)
        seg = cp[-k:]
        drift = CODE_LENGTH * dop_last / FREQ_L1_HZ
        expected = drift[None, :] * (
            torch.arange(k, dtype=torch.float32, device=dev)[:, None]
            - (k - 1))
        resid = seg - seg[-1][None, :] - expected
        resid = torch.remainder(resid + CODE_LENGTH / 2,
                                float(CODE_LENGTH)) - CODE_LENGTH / 2
        cp_filt = torch.remainder(seg[-1] + resid.mean(0),
                                  float(CODE_LENGTH))
    else:
        cp_filt = cp[-1]

    sync = outs.period_sync_ok
    unsync = ~sync
    any_loss = unsync.any(0)
    last_unsync = torch.where(
        any_loss,
        (t_cnt - 1) - torch.argmax(unsync.flip(0).to(torch.int32), dim=0),
        -1,
    ).to(torch.int32)

    # sign-flip histogram by GLOBAL epoch residue mod codes_in_bit: the
    # flip entering epoch t lands in bin (epoch0 + t) % cib
    cib = max(cfg.codes_in_bit, 1)
    epoch0 = final_state.epoch_idx.to(torch.int64) - t_cnt    # (C,)
    signs = outs.ip > 0
    flips = signs[1:] != signs[:-1]                           # (T-1, C)
    res = torch.remainder(
        epoch0[None, :]
        + torch.arange(1, t_cnt, dtype=torch.int64, device=dev)[:, None],
        cib)
    flip_hist = torch.zeros((cib, c_cnt), dtype=torch.int32, device=dev)
    flip_hist.scatter_add_(0, res, flips.to(torch.int32))

    def sgn(v):
        return torch.where(v > 0, 1, -1).to(torch.int8)

    return BlockDigest(
        bit_count=bit_count,
        bit_value=bit_value,
        bit_epoch=bit_epoch,
        code_phase_chips=cp[-1],
        code_phase_filtered=cp_filt,
        doppler_hz=dop_last,
        doppler_sum=outs.doppler_hz.sum(0),
        snr_db=outs.snr_db[-1],
        period_sync_ok=sync[-1],
        sync_any_loss=any_loss,
        last_unsync_epoch=last_unsync,
        cn0_m2=m2,
        cn0_m4=m4 * m2s * m2s,
        cn0_n=n_clean,
        flip_hist=flip_hist,
        first_ip_sign=sgn(outs.ip[0]),
        last_ip_sign=sgn(outs.ip[-1]),
        code_phase_first=cp[0],
        swap_residue=torch.remainder(final_state.last_swap_epoch, cib)
        .to(torch.int32),
    )


def digest_to_host(d: BlockDigest) -> BlockDigest:
    """The digest's leaves as numpy arrays, each of its leaf's dtype and
    shape: the block's only readback, one packed buffer
    (utils.graphs.pack) copied to the host at once."""
    specs = [(v.dtype, tuple(v.shape)) for v in d]
    host = graphs.pack(list(d)).cpu()
    return BlockDigest(*(v.numpy() for v in graphs.unpack(host, specs)))


def cn0_from_moments(m2: float, m4: float, n: int,
                     epoch_s: float = 1e-3) -> float:
    """M2M4 C/N0 (dB-Hz) from the digest's moments."""
    if n < 16:
        return 0.0
    pd = np.sqrt(max(2.0 * m2 * m2 - m4, 0.0))
    pn = m2 - pd
    if pd <= 0.0 or pn <= 0.0:
        return 0.0
    return float(10.0 * np.log10(pd / pn / epoch_s))
