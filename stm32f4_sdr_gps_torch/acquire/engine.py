"""FFT-parallel acquisition engine (torch port of the JAX package's
acquire/engine.py, FFT path).

Replaces the firmware's serial search (``acquisition.c``: frequency scan
29 bins x 10 epochs with sort-chain voting, then three shrinking
code-phase searches) with one tensor program: the whole
(PRN x Doppler x code-lag) cube is evaluated by FFT circular correlation
with non-coherent accumulation over epochs, then peak / second-peak
detection runs on the device and only (P,)-vectors come back.

Not ported yet (ROADMAP Queue 1): the matmul-DFT path
(``AcqConfig.use_matmul_dft``), bit-edge hypotheses
(``AcqConfig.edge_hypotheses > 1``), the epoch-voting detector and the
per-channel host ``refine_doppler``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import AcqConfig, SignalPlan, BASEBAND_PLAN, FREQ_L1_HZ
from ..ops.correlate import (
    code_fft_conj,
    fft_circular_correlate,
    lag_to_code_phase,
    noncoherent_power,
)
from ..ops.wipeoff import doppler_rotations
from ..utils.device import card_or_cpu


@dataclass
class AcqResult:
    """Acquisition verdict for one PRN (cf. gps_acq_t, gps_misc.h:43-60)."""

    prn: int
    detected: bool
    doppler_hz: float           # found_freq_offset_hz equivalent
    code_phase_chips: float     # found_code_phase equivalent (fractional)
    peak_power: float
    peak_ratio: float           # peak / second peak (hist_ratio equivalent)
    peak_to_mean: float


def acquisition_power(
    epochs: torch.Tensor,       # (E, S) complex epochs
    cfc: torch.Tensor,          # (P, S) conj code FFTs
    rot: torch.Tensor,          # (D, S) Doppler rotations
    coherent: int = 1,
) -> torch.Tensor:
    """Non-coherently accumulated correlation power, shape (P, D, S).

    Loops over epoch blocks so peak memory stays at one (co, D, P, S)
    complex cube; with ``coherent > 1`` the complex correlations of that
    many consecutive epochs are summed before squaring.  The coherent sum
    applies the inter-epoch carrier phasor of each Doppler bin (each
    epoch's rotation restarts at phase 0, so epoch k of bin d carries an
    extra e^{-j*2pi*f_d*k*T} that must be compensated or the coherent
    gain cancels itself).  Coherent spans must stay within a nav bit.
    """
    e, s = epochs.shape
    blocks = epochs[: (e // coherent) * coherent].reshape(-1, coherent, s)
    if coherent > 1:
        # rot[d, 1] is the per-sample step e^{-j*2pi*f_d/fs}; raising to
        # S gives the per-epoch advance
        ang1 = torch.angle(rot[:, 1])                      # -2*pi*f_d/fs
        k = torch.arange(coherent, dtype=torch.float32, device=rot.device)
        arg = ang1[None, :] * (s * k[:, None])
        phasor = torch.complex(torch.cos(arg), torch.sin(arg))   # (co, D)
    else:
        phasor = torch.ones((1, rot.shape[0]), dtype=rot.dtype,
                            device=rot.device)
    p, d = cfc.shape[0], rot.shape[0]
    acc = torch.zeros((p, d, s), dtype=torch.float32, device=epochs.device)
    for block in blocks:
        xd = block[:, None, :] * rot[None, :, :]          # (co, D, S)
        corr = fft_circular_correlate(xd, cfc)             # (co, D, P, S)
        csum = (corr * phasor[:, :, None, None]).sum(0)
        acc = acc + noncoherent_power(csum).permute(1, 0, 2)
    return acc


def _parabolic_offset(ym1, y0, yp1):
    denom = ym1 - 2.0 * y0 + yp1
    safe = torch.where(torch.abs(denom) > 1e-12, denom,
                       torch.ones_like(denom))
    return torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / safe,
                       torch.zeros_like(denom))


def exclusion_lags(cfg: AcqConfig, plan: SignalPlan) -> int:
    """Second-peak exclusion half-width in lag samples."""
    return max(1, int(round(cfg.exclude_chips * plan.samples_per_chip)))


def analyze_power_device(
    power: torch.Tensor,            # (P, D, S) non-coherent power cube
    doppler_bins_hz: torch.Tensor,  # (D,)
    excl: int,                      # exclusion half-width, lag samples
):
    """Peak detection + sub-bin interpolation on the cube's device.

    Returns (P,)-vectors (peak, fractional lag, interpolated Doppler,
    second peak outside the wraparound exclusion zone, cube mean); the
    cube itself never leaves the device."""
    p_cnt, d_cnt, s = power.shape
    dev = power.device
    pidx = torch.arange(p_cnt, device=dev)
    flat = torch.argmax(power.reshape(p_cnt, d_cnt * s), dim=1)
    di = flat // s
    si = flat % s
    rows = power[pidx, di]                              # (P, S) best bin
    peak = rows[pidx, si]

    # fractional code lag along the lag axis at the best Doppler row
    frac = _parabolic_offset(
        rows[pidx, (si - 1) % s], peak, rows[pidx, (si + 1) % s])
    lag = si.to(torch.float32) + torch.clamp(frac, -0.5, 0.5)

    # fractional Doppler across bins at the peak lag (interior bins only)
    cols = torch.gather(power, 2,
                        si[:, None, None].expand(-1, d_cnt, 1))[..., 0]
    dm1 = cols[pidx, torch.clamp(di - 1, min=0)]
    dp1 = cols[pidx, torch.clamp(di + 1, max=d_cnt - 1)]
    interior = (di > 0) & (di < d_cnt - 1)
    dfrac = torch.where(
        interior, torch.clamp(_parabolic_offset(dm1, peak, dp1), -0.5, 0.5),
        torch.zeros_like(peak))
    step = (doppler_bins_hz[1] - doppler_bins_hz[0]) if d_cnt > 1 else 0.0
    doppler = doppler_bins_hz[di] + dfrac * step

    # second peak outside the (wraparound) exclusion zone -> detect ratio
    lag_idx = torch.arange(s, device=dev)
    dist = torch.minimum((lag_idx[None, :] - si[:, None]) % s,
                         (si[:, None] - lag_idx[None, :]) % s)
    masked = torch.where(dist[:, None, :] > excl, power,
                         torch.zeros_like(power))
    second = masked.amax(dim=(1, 2))
    mean = power.mean(dim=(1, 2))
    return peak, lag, doppler, second, mean


def _results_from_vectors(vecs, prns, plan: SignalPlan,
                          cfg: AcqConfig) -> list:
    """(peak, lag, doppler, second, mean) host vectors -> AcqResults."""
    peak, lag, doppler, second, mean = vecs
    code_phase = lag_to_code_phase(lag, plan) % 1023.0
    results = []
    for pi in range(len(prns)):
        ratio = float(peak[pi]) / max(float(second[pi]), 1e-20)
        results.append(
            AcqResult(
                prn=int(prns[pi]),
                detected=bool(ratio >= cfg.detect_ratio),
                doppler_hz=float(doppler[pi]),
                code_phase_chips=float(code_phase[pi]),
                peak_power=float(peak[pi]),
                peak_ratio=ratio,
                peak_to_mean=float(peak[pi]) / max(float(mean[pi]), 1e-20),
            )
        )
    return results


def _hint_mask(prns, bins, doppler_hints_hz, cfg: AcqConfig):
    """(P, D) keep-mask confining hinted PRNs to hint +/- one bin, or
    None when no hints apply (main.c:59-73, acquisition.c:72-79)."""
    if not doppler_hints_hz:
        return None
    keep = np.ones((len(prns), len(bins)), dtype=np.float32)
    for pi, prn in enumerate(prns):
        hint = doppler_hints_hz.get(int(prn))
        if hint is not None:
            keep[pi] = np.abs(bins - hint) <= cfg.doppler_step_hz * 1.01
    return keep


def _check_supported(cfg: AcqConfig) -> None:
    if cfg.use_matmul_dft:
        raise NotImplementedError(
            "AcqConfig.use_matmul_dft is not ported yet: ROADMAP Queue 1, "
            "'the matmul-DFT path'")
    if cfg.edge_hypotheses > 1:
        raise NotImplementedError(
            "AcqConfig.edge_hypotheses > 1 is not ported yet: ROADMAP "
            "Queue 1, 'acquisition_power_hypotheses'")


def acquire(
    samples: np.ndarray,
    prns,
    plan: SignalPlan = BASEBAND_PLAN,
    cfg: AcqConfig = AcqConfig(),
    num_epochs: int | None = None,
    doppler_hints_hz: dict | None = None,
    device="cuda",
) -> list:
    """Cold-start acquisition of ``prns`` from a capture, on ``device``:
    the card unless the caller asks for the CPU (``device="cpu"``); raises
    without a card.

    Uses ``cfg.noncoherent_epochs`` 1 ms epochs (the firmware integrates
    10 epochs per Doppler bin, acquisition.c:18).  ``doppler_hints_hz``
    maps PRN -> expected Doppler; a hinted channel's search is confined to
    hint +/- one bin (main.c:59-73, acquisition.c:72-79).
    """
    device = card_or_cpu(device, "acquire")
    _check_supported(cfg)
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    if len(samples) < e * s:
        raise ValueError(f"need at least {e} epochs of samples")
    epochs = torch.as_tensor(
        np.ascontiguousarray(samples[: e * s].reshape(e, s),
                             dtype=np.complex64), device=device)
    bins = np.asarray(cfg.doppler_bins_hz, dtype=np.float32)
    bins_d = torch.as_tensor(bins, device=device)
    rot = doppler_rotations(bins_d, s, plan.sample_rate_hz)
    cfc = code_fft_conj(prns, plan, device=device)
    keep = _hint_mask(prns, bins, doppler_hints_hz, cfg)
    keep_d = None if keep is None else torch.as_tensor(keep, device=device)
    out = _acquire_fused(epochs, cfc, rot, bins_d, keep_d,
                         coherent=cfg.coherent_epochs,
                         excl=exclusion_lags(cfg, plan))
    return _results_from_vectors(
        [v.cpu().numpy() for v in out], prns, plan, cfg)


def _acquire_fused(epochs, cfc, rot, bins, keep, coherent: int, excl: int):
    """Cube -> hint mask -> peak analysis, all on the epochs' device;
    returns only (P,) vectors."""
    power = acquisition_power(epochs, cfc, rot, coherent=coherent)
    if keep is not None:
        power = power * keep[:, :, None]
    return analyze_power_device(power, bins, excl)


def refine_doppler_device(
    epochs: torch.Tensor,            # (E, S) complex epochs, on the device
    code_table: torch.Tensor,        # (C, 1023) bipolar codes
    code_phase_chips: torch.Tensor,  # (C,) code phase at epochs[0]
    doppler_hz: torch.Tensor,        # (C,) coarse Doppler
    plan: SignalPlan = BASEBAND_PLAN,
) -> torch.Tensor:
    """Fine Doppler for every channel at once, on the device.

    Per epoch, the prompt correlation at the acquired code phase (code
    rate carrier-aided so the replica does not walk off the signal); then
    the FFT of the squared prompts (squaring strips the BPSK nav bits, so
    the tone sits at 2*df), zero-padded 8x, and its argmax.  The coarse
    grid leaves tens of Hz of error; this resolves it to ~1 Hz.  Only the
    (C,) refined-Doppler vector need come back.
    """
    from ..ops.replica import sample_replicas
    from ..ops.wipeoff import carrier_wipeoff

    e, s = epochs.shape
    doppler_hz = doppler_hz.to(torch.float32)
    code_rate = (
        float(plan.chips_per_sample) * (1.0 + doppler_hz / FREQ_L1_HZ)
    )                                               # (C,)
    chips_per_epoch = code_rate * s
    phase = torch.zeros_like(doppler_hz)
    cp = code_phase_chips.to(torch.float32)
    prompts = []
    for t in range(e):
        reps = sample_replicas(code_table, cp, code_rate, s, (0.0,))[:, 0]
        y, phase = carrier_wipeoff(epochs[t], doppler_hz, phase,
                                   plan.sample_rate_hz)
        prompts.append((y * reps).sum(-1))          # (C,)
        cp = torch.remainder(cp + chips_per_epoch, 1023.0)
    prompts = torch.stack(prompts)                  # (E, C)
    pad = 8 * e
    spec = torch.abs(torch.fft.fft(prompts * prompts, n=pad, dim=0))
    freqs = torch.fft.fftfreq(pad, d=s / plan.sample_rate_hz,
                              device=epochs.device)
    k = torch.argmax(spec, dim=0)
    return doppler_hz + freqs[k].to(torch.float32) / 2.0
