"""FFT-parallel acquisition engine (torch port of the JAX package's
acquire/engine.py).

Replaces the firmware's serial search (``acquisition.c``: frequency scan
29 bins x 10 epochs with sort-chain voting, then three shrinking
code-phase searches) with one tensor program: the whole
(PRN x Doppler x code-lag) cube is evaluated by FFT circular correlation
(or matmul DFTs, ``AcqConfig.use_matmul_dft``) with coherent and
non-coherent accumulation over epochs and, for long coherent spans,
max-combined bit-edge hypotheses; peak / second-peak detection runs on
the device and only (P,)-vectors come back.  An epoch-voting detector
compatible with the firmware's histogram acceptance thresholds
(acquisition.c:249-274) and the per-channel host fine-Doppler search are
also here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..config import AcqConfig, SignalPlan, BASEBAND_PLAN, FREQ_L1_HZ
from ..ops.correlate import (
    check_float32_matmuls,
    code_fft_conj,
    code_spectrum_conj_matmul,
    dft_tables_device,
    fft_circular_correlate,
    lag_to_code_phase,
    matmul_circular_correlate,
    noncoherent_power,
    pack_code_bits,
    unpack_code_table,
)
from ..ops.wipeoff import doppler_rotations
from ..utils import graphs
from ..utils.device import card_or_cpu, readback, upload, upload_window
from ..utils.profiling import count, span


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
    dft: tuple | None = None,   # (wc, ws) from ops.correlate.dft_tables
    dft_precision: str = "highest",
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
        if dft is not None:                                # matmul DFT
            corr = matmul_circular_correlate(xd, cfc, *dft,
                                             precision=dft_precision)
        else:
            corr = fft_circular_correlate(xd, cfc)         # (co, D, P, S)
        csum = (corr * phasor[:, :, None, None]).sum(0)
        acc = acc + noncoherent_power(csum).permute(1, 0, 2)
    return acc


def acquisition_power_hypotheses(
    epochs: torch.Tensor,       # (E, S) complex epochs
    cfc: torch.Tensor,          # (P, S) conj code FFTs
    rot: torch.Tensor,          # (D, S) Doppler rotations
    coherent: int,
    n_hyp: int,
    dft: tuple | None = None,
    dft_precision: str = "highest",
) -> torch.Tensor:
    """All bit-edge hypotheses in one call, shape (P, D, S).

    The coherent block grid is tried at ``n_hyp`` offsets across one
    block and the per-block-normalized powers are max-combined on the
    device.  Hypotheses are steps of the call, not a batch axis, so peak
    memory stays at one (coherent, D, P, S) correlation cube, as for a
    single hypothesis.
    """
    e = epochs.shape[0]
    power = None
    for j in range(n_hyp):
        o = (j * coherent) // n_hyp
        n_blocks = (e - o) // coherent
        if n_blocks < 1:
            continue
        pw = acquisition_power(
            epochs[o: o + n_blocks * coherent], cfc, rot, coherent=coherent,
            dft=dft, dft_precision=dft_precision,
        ) / float(n_blocks)
        power = pw if power is None else torch.maximum(power, pw)
    return power


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


def _analyze_power_host(power: np.ndarray, doppler_bins_hz: np.ndarray,
                        excl: int):
    """Pure-numpy mirror of analyze_power_device (same argmax tie-break,
    parabolic interpolation, wraparound exclusion)."""
    p_cnt, d_cnt, s = power.shape
    pidx = np.arange(p_cnt)
    flat = power.reshape(p_cnt, -1).argmax(axis=1)
    di = flat // s
    si = flat % s
    rows = power[pidx, di]
    peak = rows[pidx, si]

    def parab(ym1, y0, yp1):
        den = ym1 - 2.0 * y0 + yp1
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(np.abs(den) > 1e-12, 0.5 * (ym1 - yp1) / den, 0.0)
        return out

    frac = parab(rows[pidx, (si - 1) % s], peak, rows[pidx, (si + 1) % s])
    lag = si.astype(np.float32) + np.clip(frac, -0.5, 0.5)
    cols = np.take_along_axis(power, si[:, None, None], axis=2)[..., 0]
    dm1 = cols[pidx, np.maximum(di - 1, 0)]
    dp1 = cols[pidx, np.minimum(di + 1, d_cnt - 1)]
    interior = (di > 0) & (di < d_cnt - 1)
    dfrac = np.where(interior, np.clip(parab(dm1, peak, dp1), -0.5, 0.5),
                     0.0)
    step = (doppler_bins_hz[1] - doppler_bins_hz[0]) if d_cnt > 1 else 0.0
    doppler = doppler_bins_hz[di] + dfrac * step
    lag_idx = np.arange(s)
    dist = np.minimum((lag_idx[None, :] - si[:, None]) % s,
                      (si[:, None] - lag_idx[None, :]) % s)
    masked = np.where(dist[:, None, :] > excl, power, 0.0)
    second = masked.max(axis=(1, 2))
    mean = power.mean(axis=(1, 2))
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


def analyze_power(
    power,                      # (P, D, S) tensor or numpy array
    prns,
    doppler_bins_hz: np.ndarray,
    plan: SignalPlan,
    cfg: AcqConfig,
) -> list:
    """Peak detection + sub-bin interpolation -> AcqResults.

    A tensor cube is analyzed on its own device (analyze_power_device)
    and only the per-PRN vectors come back, stacked into one (5, P)
    readback; a numpy cube is analyzed on the host
    (_analyze_power_host)."""
    excl = exclusion_lags(cfg, plan)
    bins_np = np.asarray(doppler_bins_hz, dtype=np.float32)
    if isinstance(power, np.ndarray):
        vecs = _analyze_power_host(power, bins_np, excl)
    else:
        bins = torch.as_tensor(bins_np, device=power.device)
        vecs = readback(torch.stack(analyze_power_device(power, bins, excl)))
    return _results_from_vectors(vecs, prns, plan, cfg)


def apply_doppler_hints(power, prns, bins, doppler_hints_hz, cfg):
    """Confine hinted PRNs' power cubes to hint +/- one Doppler bin (the
    firmware's user-supplied hints, main.c:59-73, acquisition.c:72-79).
    The (P, D) keep-mask is built on the host and applied as one multiply
    on the cube's side, so a device cube stays on the device."""
    keep = _hint_mask(prns, bins, doppler_hints_hz, cfg)
    if keep is None:
        return power
    if isinstance(power, np.ndarray):
        return power * keep[:, :, None]
    return power * torch.as_tensor(keep, device=power.device)[:, :, None]


def epochs_on(samples, e: int, s: int, device) -> torch.Tensor:
    """The first ``e`` epochs of ``samples`` as an (e, S) complex64 tensor
    on ``device``.

    ``samples`` is a flat numpy array or a flat ``torch.Tensor``.  A numpy
    array takes one host-to-device copy in the span ``samples``, counted
    as an ``upload``, an ``upload.samples`` and its bytes in
    ``samples.bytes`` (``utils.profiling.count``); a complex64 view into
    a recording held whole crosses by DMA from its page-locked owner
    (``utils.device.upload_window``).  A
    complex64 tensor already on ``device`` is used in place: the result
    is a view of it, with no copy.  Any other tensor is cast to complex64
    and moved to ``device`` explicitly, as the numpy path casts."""
    if isinstance(samples, torch.Tensor):
        return samples[: e * s].reshape(e, s).to(device=device,
                                                 dtype=torch.complex64)
    window = np.ascontiguousarray(samples[: e * s].reshape(e, s),
                                  dtype=np.complex64)
    with span("samples"):
        count("upload.samples")
        count("samples.bytes", window.nbytes)
        return upload_window(window, device)


@functools.lru_cache(maxsize=graphs.MAX_ENTRIES)
def _doppler_grid(bins: tuple, plan: SignalPlan, device: str) -> tuple:
    """(the Doppler bins, their (D, S) rotations) on ``device``, made
    once a process for each grid: constants of the configuration."""
    bins_d = upload(np.asarray(bins, dtype=np.float32), device)
    return bins_d, doppler_rotations(bins_d, plan.samples_per_epoch,
                                     plan.sample_rate_hz)


@functools.lru_cache(maxsize=2)
def _dft_tables(s: int, device: str) -> tuple:
    """The matmul DFT's (S, S) twiddle tables on ``device``, made once a
    process."""
    return dft_tables_device(s, device=device)


@functools.lru_cache(maxsize=graphs.MAX_ENTRIES)
def _code_spectra(prns: tuple, plan: SignalPlan, use_dft: bool,
                  device: str) -> torch.Tensor:
    """The sampled codes' conjugate spectra (P, S) on ``device``, made
    once a process for each PRN tuple: by FFT, or for the matmul DFT from
    the codes shipped bit-packed and their spectrum taken as a product."""
    if use_dft:
        s = plan.samples_per_epoch
        packed = upload(pack_code_bits(prns, plan), device)
        return code_spectrum_conj_matmul(unpack_code_table(packed, s),
                                         *_dft_tables(s, device))
    return code_fft_conj(prns, plan, device=device)


def acquire(
    samples,
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

    The code spectra, the Doppler bins and rotations and the DFT tables
    are made once a process (``_code_spectra``, ``_doppler_grid``,
    ``_dft_tables``; shared, so read only); the cube and its analysis run
    as one captured program (``_acquire_fused``), whose (5, P) result
    comes back in one ``readback``.  Counted in the innermost span:
    ``acquire.capture`` where the call captured the program,
    ``acquire.replay`` where it replayed one (a capturing call replays
    too).
    """
    device = card_or_cpu(device, "acquire")
    args, static = fused_args(samples, prns, plan, cfg, num_epochs,
                              doppler_hints_hz, device)
    captures, replays = graphs.stats["captures"], graphs.stats["replays"]
    out = _acquire_fused(*args, **static)
    if graphs.stats["captures"] != captures:
        count("acquire.capture")
    if graphs.stats["replays"] != replays:
        count("acquire.replay")
    return _results_from_vectors(readback(out), prns, plan, cfg)


def fused_args(samples, prns, plan: SignalPlan, cfg: AcqConfig,
               num_epochs: int | None, doppler_hints_hz: dict | None,
               device: torch.device) -> tuple:
    """(tensor arguments, static arguments) of :func:`_acquire_fused` for
    :func:`acquire`'s call: the epochs on ``device``, the tables of the
    configuration (made once a process) and the hint mask."""
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    if len(samples) < e * s:
        raise ValueError(f"need at least {e} epochs of samples")
    if cfg.use_matmul_dft:
        # the code spectra are float32 products: refuse TF32 on every
        # call, as a replay runs no Python of the product's own guard
        check_float32_matmuls(device)
    epochs = epochs_on(samples, e, s, device)
    key = str(device)
    bins_d, rot = _doppler_grid(tuple(cfg.doppler_bins_hz), plan, key)
    dft = _dft_tables(s, key) if cfg.use_matmul_dft else None
    cfc = _code_spectra(tuple(int(p) for p in prns), plan,
                        cfg.use_matmul_dft, key)
    keep = _hint_mask(prns, np.asarray(cfg.doppler_bins_hz, np.float32),
                      doppler_hints_hz, cfg)
    keep_d = None if keep is None else upload(keep, device)
    return ((epochs, cfc, rot, bins_d, keep_d, dft),
            dict(coherent=cfg.coherent_epochs,
                 n_hyp=max(1, int(cfg.edge_hypotheses)),
                 dft_precision=cfg.dft_precision,
                 excl=exclusion_lags(cfg, plan)))


@graphs.captured(static_argnames=("coherent", "n_hyp", "dft_precision",
                                  "excl"))
def _acquire_fused(epochs, cfc, rot, bins, keep, dft, coherent: int,
                   n_hyp: int, dft_precision: str, excl: int):
    """Cube -> hypothesis max-combine -> hint mask -> peak analysis, all
    on the epochs' device; returns only the (5, P) stack of the peak,
    lag, Doppler, second-peak and mean vectors.  Bit-edge hypotheses
    shift the coherent block grid and max-combine per-block-normalized
    powers, so one hypothesis has every block free of a nav-bit sign
    flip.  On the card a captured CUDA graph (``utils.graphs``: the key
    holds the static arguments, whether ``keep`` and ``dft`` are given,
    and the tensors' shapes), so PRN sets of one size share a program."""
    if n_hyp == 1:
        power = acquisition_power(epochs, cfc, rot, coherent=coherent,
                                  dft=dft, dft_precision=dft_precision)
    else:
        power = acquisition_power_hypotheses(
            epochs, cfc, rot, coherent=coherent, n_hyp=n_hyp, dft=dft,
            dft_precision=dft_precision)
    if keep is not None:
        power = power * keep[:, :, None]
    return torch.stack(analyze_power_device(power, bins, excl))


def refine_doppler(
    samples,
    prn: int,
    code_phase_chips: float,
    coarse_doppler_hz: float,
    plan: SignalPlan = BASEBAND_PLAN,
    num_epochs: int = 32,
    device="cuda",
) -> float:
    """Fine Doppler of one channel: :func:`refine_doppler_device`'s search
    on the first ``num_epochs`` epochs of ``samples``, on ``device`` (the
    card unless the caller asks for the CPU; raises without a card), with
    the found bin's frequency added to the coarse Doppler in float64 on
    the host.  The coarse grid leaves tens of Hz of error; this resolves
    the residual to ~1000/num_epochs Hz (zero-padded 8x)."""
    from ..signal.ca_code import ca_table_bipolar

    device = card_or_cpu(device, "refine_doppler")
    s = plan.samples_per_epoch
    e = min(num_epochs, len(samples) // s)
    k = int(_squared_prompt_bins(
        epochs_on(samples, e, s, device),
        torch.as_tensor(ca_table_bipolar([prn]), device=device),
        torch.tensor([code_phase_chips], dtype=torch.float32, device=device),
        torch.tensor([coarse_doppler_hz], dtype=torch.float32,
                     device=device), plan)[0])
    freqs = np.fft.fftfreq(8 * e, d=s / plan.sample_rate_hz)
    return float(coarse_doppler_hz + freqs[k] / 2.0)


def _code_rate(doppler_hz: torch.Tensor, plan: SignalPlan) -> torch.Tensor:
    """(C,) code rate in chips a sample, carrier-aided so the replica does
    not walk off the signal."""
    return float(plan.chips_per_sample) * (1.0 + doppler_hz / FREQ_L1_HZ)


def squared_prompts_plain(
    epochs: torch.Tensor,            # (E, S) complex epochs
    code_table: torch.Tensor,        # (C, 1023) bipolar codes
    code_phase_chips: torch.Tensor,  # (C,) code phase at epochs[0]
    doppler_hz: torch.Tensor,        # (C,) coarse Doppler
    plan: SignalPlan,
) -> torch.Tensor:
    """(E, C) complex64 prompt of each epoch at the acquired code phase,
    advanced by the carrier-aided code rate from epoch to epoch, with the
    carrier rotated off at the coarse Doppler: the plain version of
    :func:`squared_prompts_cuda`, a Python loop over the epochs."""
    from ..ops.replica import sample_replicas
    from ..ops.wipeoff import carrier_wipeoff

    e, s = epochs.shape
    code_rate = _code_rate(doppler_hz, plan)
    chips_per_epoch = code_rate * s
    phase = torch.zeros_like(doppler_hz)
    cp = code_phase_chips
    prompts = []
    for t in range(e):
        reps = sample_replicas(code_table, cp, code_rate, s, (0.0,))[:, 0]
        y, phase = carrier_wipeoff(epochs[t], doppler_hz, phase,
                                   plan.sample_rate_hz)
        prompts.append((y * reps).sum(-1))          # (C,)
        cp = torch.remainder(cp + chips_per_epoch, 1023.0)
    squared_prompts_plain.calls += 1
    return torch.stack(prompts)


squared_prompts_plain.calls = 0


#: samples an epoch the handoff search kernels take at most (256 threads
#: of 8 samples, csrc/pretrack.cuh)
HANDOFF_MAX_SAMPLES = 2048


def check_handoff_inputs(epochs, code_table, code_phase_chips, doppler_hz):
    """Raise on what the handoff search kernels (csrc/pretrack.cu) and
    their host build do not take: (E, S) complex64 epochs with E >= 1 and
    1 <= S <= HANDOFF_MAX_SAMPLES, a (C, 1023) float32 code table and (C,)
    float32 code phases and Dopplers, all contiguous on one device."""
    if (epochs.dim() != 2 or epochs.dtype != torch.complex64
            or epochs.shape[0] < 1
            or not 1 <= epochs.shape[1] <= HANDOFF_MAX_SAMPLES):
        raise ValueError(f"epochs: want (E, S) complex64 with E >= 1 and "
                         f"1 <= S <= {HANDOFF_MAX_SAMPLES}, got "
                         f"{tuple(epochs.shape)} {epochs.dtype}")
    if (code_table.dim() != 2 or code_table.shape[1] != 1023
            or code_table.dtype != torch.float32):
        raise ValueError(f"code_table: want (C, 1023) float32, got "
                         f"{tuple(code_table.shape)} {code_table.dtype}")
    c = code_table.shape[0]
    for name, t in (("code_phase_chips", code_phase_chips),
                    ("doppler_hz", doppler_hz)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want ({c},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("code_table", code_table),
                    ("code_phase_chips", code_phase_chips),
                    ("doppler_hz", doppler_hz)):
        if t.device != epochs.device:
            raise ValueError(f"{name} is on {t.device}, epochs on "
                             f"{epochs.device}")
    for name, t in (("epochs", epochs), ("code_table", code_table),
                    ("code_phase_chips", code_phase_chips),
                    ("doppler_hz", doppler_hz)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _s_over_fs(s: int, plan: SignalPlan) -> float:
    """The epoch's duration as the carrier NCO steps it, rounded to
    float32 (ops.wipeoff.carrier_wipeoff)."""
    return float(np.float32(s / plan.sample_rate_hz))


def squared_prompts_cuda(epochs, code_table, code_phase_chips, doppler_hz,
                         plan: SignalPlan):
    """:func:`squared_prompts_plain` on the card: every epoch of every
    channel in one launch of the squared-prompt kernel (csrc/pretrack.cu),
    with no host synchronisation.  ``squared_prompts_cuda.launches``
    counts kernel launches (a replayed graph adds those its capture holds,
    utils.graphs)."""
    from ..ops.kernel_lib import pretrack_lib

    if not epochs.is_cuda:
        raise ValueError("squared_prompts_cuda needs CUDA tensors")
    check_handoff_inputs(epochs, code_table, code_phase_chips, doppler_hz)
    e, s = epochs.shape
    c = code_table.shape[0]
    out = torch.empty((e, c), dtype=torch.complex64, device=epochs.device)
    if c == 0:
        return out
    rate = _code_rate(doppler_hz, plan)
    lib = pretrack_lib()
    with torch.cuda.device(epochs.device):
        stream = torch.cuda.current_stream(epochs.device).cuda_stream
        rc = lib.sq_prompts_launch(
            epochs.data_ptr(), code_table.data_ptr(),
            code_phase_chips.data_ptr(), rate.data_ptr(),
            doppler_hz.data_ptr(), out.data_ptr(), e, c, s,
            _s_over_fs(s, plan), plan.sample_rate_hz, stream)
    if rc != 0:
        raise RuntimeError(f"squared-prompt kernel launch failed: CUDA "
                           f"error {rc}")
    squared_prompts_cuda.launches += 1
    return out


squared_prompts_cuda.launches = 0
graphs.count_launches(squared_prompts_cuda)


def squared_prompts_host(epochs, code_table, code_phase_chips, doppler_hz,
                         plan: SignalPlan):
    """The squared-prompt kernel's arithmetic built for the host with g++
    (csrc/pretrack_host.cpp) on CPU tensors, summed in the kernel's order:
    the check of the CUDA source on a machine without a GPU."""
    from ..ops.kernel_lib import host_lib

    if epochs.device.type != "cpu":
        raise ValueError("squared_prompts_host needs CPU tensors")
    check_handoff_inputs(epochs, code_table, code_phase_chips, doppler_hz)
    e, s = epochs.shape
    c = code_table.shape[0]
    out = torch.empty((e, c), dtype=torch.complex64)
    rate = _code_rate(doppler_hz, plan)
    host_lib().sq_prompts_host(
        epochs.data_ptr(), code_table.data_ptr(),
        code_phase_chips.data_ptr(), rate.data_ptr(), doppler_hz.data_ptr(),
        out.data_ptr(), e, c, s, _s_over_fs(s, plan), plan.sample_rate_hz)
    return out


def squared_prompts(epochs, code_table, code_phase_chips, doppler_hz,
                    plan: SignalPlan):
    """(E, C) complex64 prompts of the squared-prompt Doppler search: the
    kernel for CUDA tensors, its plain version for CPU tensors."""
    if epochs.is_cuda:
        return squared_prompts_cuda(epochs, code_table, code_phase_chips,
                                    doppler_hz, plan)
    if epochs.device.type == "cpu":
        return squared_prompts_plain(epochs, code_table, code_phase_chips,
                                     doppler_hz, plan)
    raise ValueError(f"no squared-prompt search for device {epochs.device}")


def _squared_prompt_bins(
    epochs: torch.Tensor,            # (E, S) complex epochs, on the device
    code_table: torch.Tensor,        # (C, 1023) bipolar codes
    code_phase_chips: torch.Tensor,  # (C,) code phase at epochs[0]
    doppler_hz: torch.Tensor,        # (C,) coarse Doppler
    plan: SignalPlan,
) -> torch.Tensor:
    """(C,) argmax bin of each channel's squared-prompt spectrum, over
    8 * E bins.

    Per epoch, the prompt correlation at the acquired code phase (code
    rate carrier-aided so the replica does not walk off the signal,
    :func:`squared_prompts`); then the FFT of the squared prompts
    (squaring strips the BPSK nav bits, so the tone sits at 2*df),
    zero-padded 8x, and its argmax, all on the epochs' device."""
    e = epochs.shape[0]
    prompts = squared_prompts(epochs, code_table.to(torch.float32),
                              code_phase_chips.to(torch.float32),
                              doppler_hz.to(torch.float32), plan)  # (E, C)
    spec = torch.abs(torch.fft.fft(prompts * prompts, n=8 * e, dim=0))
    return torch.argmax(spec, dim=0)


def refine_doppler_device(
    epochs: torch.Tensor,            # (E, S) complex epochs, on the device
    code_table: torch.Tensor,        # (C, 1023) bipolar codes
    code_phase_chips: torch.Tensor,  # (C,) code phase at epochs[0]
    doppler_hz: torch.Tensor,        # (C,) coarse Doppler
    plan: SignalPlan = BASEBAND_PLAN,
) -> torch.Tensor:
    """Fine Doppler for every channel at once, on the device: the coarse
    Doppler plus half the frequency of the squared-prompt spectrum's peak
    (:func:`_squared_prompt_bins`).  The coarse grid leaves tens of Hz of
    error; this resolves it to ~1 Hz.  Only the (C,) refined-Doppler
    vector need come back."""
    e, s = epochs.shape
    k = _squared_prompt_bins(epochs, code_table, code_phase_chips,
                             doppler_hz, plan)
    freqs = torch.fft.fftfreq(8 * e, d=s / plan.sample_rate_hz,
                              device=epochs.device)
    return doppler_hz.to(torch.float32) + freqs[k].to(torch.float32) / 2.0


def acquire_epoch_vote(
    samples,
    prns,
    plan: SignalPlan = BASEBAND_PLAN,
    cfg: AcqConfig = AcqConfig(),
    num_epochs: int | None = None,
    device="cuda",
) -> list:
    """Firmware-compatible epoch-voting detector, on ``device``: the card
    unless the caller asks for the CPU; raises without a card.

    Per epoch, the argmax lag of each (PRN, Doppler) row of the FFT cube
    votes into a histogram over (Doppler bin, half-chip lag cell); a PRN
    is accepted when max/avg over the non-zero cells exceeds
    ``cfg.hist_ratio``, the acceptance rule of acquisition.c:249-274.
    Only the (E, P, D) argmax / max planes come back to the host.
    """
    device = card_or_cpu(device, "acquire_epoch_vote")
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    epochs = epochs_on(samples, e, s, device)
    cfc = code_fft_conj(prns, plan, device=device)
    bins = np.asarray(cfg.doppler_bins_hz, dtype=np.float32)
    rot = doppler_rotations(torch.as_tensor(bins, device=device), s,
                            plan.sample_rate_hz)
    arg_rows, max_rows = [], []
    for x in epochs:
        pw = noncoherent_power(fft_circular_correlate(x[None, :] * rot, cfc))
        mx, am = pw.max(dim=2)                          # (D, P)
        arg_rows.append(am.T)
        max_rows.append(mx.T)
    argmaxes = torch.stack(arg_rows).cpu().numpy()      # (E, P, D)
    maxes = torch.stack(max_rows).cpu().numpy()         # (E, P, D)

    results = []
    hist_step = max(1, int(round(plan.samples_per_chip * 0.5)))  # half chip
    for pi, prn in enumerate(prns):
        votes: dict = {}
        for ei in range(argmaxes.shape[0]):
            di = int(np.argmax(maxes[ei, pi]))
            cell = int(argmaxes[ei, pi, di]) // hist_step
            votes[(di, cell)] = votes.get((di, cell), 0) + 1
        (best_key, best_votes) = max(votes.items(), key=lambda kv: kv[1])
        nz = list(votes.values())
        avg = float(np.mean(nz))
        ratio = best_votes / max(avg, 1e-9)
        detected = (ratio > cfg.hist_ratio) or (
            len(nz) == 1 and best_votes > cfg.freq_hist_min_votes
        )
        di, cell = best_key
        lag = cell * hist_step
        results.append(
            AcqResult(
                prn=int(prn),
                detected=bool(detected),
                doppler_hz=float(bins[di]),
                code_phase_chips=float(lag_to_code_phase(lag, plan) % 1023.0),
                peak_power=float(maxes[:, pi, di].mean()),
                peak_ratio=float(ratio),
                peak_to_mean=float(ratio),
            )
        )
    return results
