"""GPS L1 C/A signal simulator.

Supersedes the reference's single-satellite square-wave fixture
(``Firmware/project_single_sat/GPS/simulator.c:88-146``,
noise knob ``:40-58``) with a proper multi-satellite IQ synthesizer:

* carrier at arbitrary Doppler with continuous phase,
* code NCO with carrier-coherent code Doppler,
* 50 bps nav-bit modulation (real LNAV subframes via
  :mod:`stm32f4_sdr_gps_torch.signal.nav_message`),
* calibrated C/N0 with complex AWGN,
* complex-baseband output (default plan) or 1-bit real IF output matching the
  reference front-end format (config.h:23-26).

Ground truth (code phase / Doppler / bit stream per satellite) is returned
alongside the samples so tests can assert acquisition/tracking/decode
parity (SURVEY.md §4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..config import (
    CODE_LENGTH,
    CODE_RATE_HZ,
    CODES_IN_BIT,
    FREQ_L1_HZ,
    SignalPlan,
    BASEBAND_PLAN,
)
from .ca_code import ca_code_bits


@dataclass
class SimSat:
    """One simulated satellite signal."""

    prn: int
    doppler_hz: float = 0.0
    code_phase_chips: float = 0.0      # code phase at sample 0
    carrier_phase_cycles: float = 0.0
    cn0_dbhz: float = 45.0
    nav_bits: Optional[np.ndarray] = None   # 0/1 bits at 50 bps; None => all 0
    nav_epoch_offset: int = 0          # code periods until first bit boundary shift
    code_doppler: bool = True          # scale code rate by (1 + fd/fL1)
    codes_in_bit: int = CODES_IN_BIT   # compressed-time tests may lower this
    # Exact signal delay: when set, overrides code_phase_chips /
    # nav_epoch_offset so that bit k of nav_bits starts arriving at
    # t = delay_ms + k*codes_in_bit ms — a physically consistent TOF for
    # pseudorange tests.  Bits "before" t=0 wrap to the stream end.
    delay_ms: Optional[float] = None
    # Satellite dynamics: Doppler ramp (Hz/s).  The carrier phase uses
    # the chirp integral and the code rate follows coherently, like a
    # real accelerating line-of-sight (GPS satellites: up to ~0.9 Hz/s).
    doppler_rate_hz_s: float = 0.0
    # Two-ray multipath: a reflected copy of this satellite's signal at
    # +delay chips, relative amplitude and relative carrier phase
    # (specular reflection class; 0 amp = off).  Biases the half-chip
    # E/L discriminator like the real environment the reference's
    # analog front-end lives in (RF_Frontend/, signal_capture.c:9-11).
    multipath_delay_chips: float = 0.0
    multipath_amp: float = 0.0
    multipath_phase_cycles: float = 0.0


@dataclass
class Impairments:
    """Receiver-side RF impairments (VERDICT r2 §missing-3): what the
    MAX2769 front-end + TCXO inflict on the real firmware
    (RF_Frontend/, signal_capture.c:9-11) and the idealized simulator
    previously omitted.  All effects are common-mode across satellites
    (they live in the receiver, not the channel).

    * TCXO fractional frequency error delta(t) = (offset_ppm +
      drift_ppm_s * t) * 1e-6: shifts every carrier by -delta*fL1
      (~1575 Hz/ppm — the dominant cold-start unknown) and scales the
      apparent code rate by the same fraction, exactly as a shared
      receiver clock does.
    * Oscillator phase noise: Wiener random walk added to the common
      carrier phase, variance phase_noise_rad2_s * dt per step.
    * Front-end band-limiting: windowed-sinc FIR on signal+noise before
      quantization — low-pass (two-sided bw) for complex plans,
      IF-centered band-pass for real-IF plans (MAX2769 ~2.5 MHz).
    * DC offset (in noise-sigma units) before the 1-bit quantizer: a
      sign-density bias the AGC of a real front-end leaves behind.
    """

    tcxo_offset_ppm: float = 0.0
    tcxo_drift_ppm_s: float = 0.0
    phase_noise_rad2_s: float = 0.0
    frontend_bw_hz: float = 0.0        # 0 = no band-limiting
    frontend_taps: int = 129
    dc_offset_sigma: float = 0.0


@dataclass
class SimTruth:
    """Per-satellite ground truth of a simulated capture."""

    sats: Sequence[SimSat]
    plan: SignalPlan
    noise_sigma: float
    amplitudes: np.ndarray = field(default_factory=lambda: np.zeros(0))
    impairments: Optional["Impairments"] = None

    def _tcxo_int_s(self, t: float) -> float:
        imp = self.impairments
        if imp is None:
            return 0.0
        return (imp.tcxo_offset_ppm * t
                + 0.5 * imp.tcxo_drift_ppm_s * t * t) * 1e-6

    def apparent_doppler_hz(self, sat_idx: int, t: float = 0.0) -> float:
        """Doppler the RECEIVER sees at time t (satellite Doppler minus
        the TCXO's fL1-scaled fractional error)."""
        sat = self.sats[sat_idx]
        imp = self.impairments
        tc = 0.0 if imp is None else (
            imp.tcxo_offset_ppm + imp.tcxo_drift_ppm_s * t) * 1e-6
        return sat.doppler_hz + sat.doppler_rate_hz_s * t - tc * FREQ_L1_HZ

    def code_phase_at_epoch(self, sat_idx: int, epoch: int) -> float:
        """True code phase (chips, mod 1023) at the start of ``epoch``."""
        sat = self.sats[sat_idx]
        t = epoch * self.plan.samples_per_epoch / self.plan.sample_rate_hz
        dop_int = sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_s * t**2
        code_time = t + (dop_int / FREQ_L1_HZ if sat.code_doppler else 0.0)
        code_time -= self._tcxo_int_s(t)
        if sat.delay_ms is not None:
            chips = CODE_RATE_HZ * (code_time - sat.delay_ms * 1e-3)
        else:
            chips = sat.code_phase_chips + CODE_RATE_HZ * code_time
        return float(chips % CODE_LENGTH)


def inject_fault(
    samples: np.ndarray,
    start_ms: float,
    duration_ms: float,
    mode: str = "dropout",
    sample_rate_hz: float = 2.046e6,
    seed: int = 0,
) -> np.ndarray:
    """Fault injection (the role of the firmware fixture's noise knob,
    simulator.c:40-58, but time-targeted): corrupt a span of a capture.

    ``mode``: 'dropout' zeroes the span (signal blockage); 'noise'
    replaces it with unit AWGN (jamming/interference burst).
    """
    out = samples.copy()
    a = int(start_ms * 1e-3 * sample_rate_hz)
    b = a + int(duration_ms * 1e-3 * sample_rate_hz)
    b = min(b, len(out))
    if mode == "dropout":
        out[a:b] = 0
    elif mode == "noise":
        rng = np.random.default_rng(seed)
        n = b - a
        if np.iscomplexobj(out):
            out[a:b] = (rng.standard_normal(n)
                        + 1j * rng.standard_normal(n)) / np.sqrt(2)
        else:
            out[a:b] = rng.standard_normal(n)
    else:
        raise ValueError(f"unknown fault mode {mode!r}")
    return out


def _amplitude_for_cn0(cn0_dbhz: float, fs: float, noise_sigma: float) -> float:
    """Signal amplitude giving the requested C/N0 against complex noise of
    per-sample variance ``noise_sigma**2`` (N0 = sigma^2 / fs)."""
    return float(np.sqrt(10.0 ** (cn0_dbhz / 10.0) * noise_sigma**2 / fs))


def simulate_capture(
    sats: Sequence[SimSat],
    num_epochs: int,
    plan: SignalPlan = BASEBAND_PLAN,
    noise_sigma: float = 1.0,
    seed: int = 0,
    chunk_epochs: int = 2000,
    impairments: Optional[Impairments] = None,
) -> tuple:
    """Synthesize ``num_epochs`` ms of signal.

    Returns ``(samples, truth)``.  ``samples`` is complex64 of shape
    ``(num_epochs * samples_per_epoch,)`` for a complex plan, or float32
    (+/-1 if plan.quantize_bits == 1) for a real-IF plan.  Generation is
    chunked so float64 intermediates stay bounded on long captures.
    ``impairments`` adds receiver-side RF effects (TCXO error, phase
    noise, band-limiting, DC) before the quantizer.
    """
    spe = plan.samples_per_epoch
    out = []
    amps_out = None
    rng = np.random.default_rng(seed)
    pn_state = {"phi": 0.0}
    for start in range(0, num_epochs, chunk_epochs):
        n_ep = min(chunk_epochs, num_epochs - start)
        chunk, amps = _simulate_chunk(
            sats, start * spe, n_ep * spe, plan, noise_sigma, rng,
            impairments, pn_state
        )
        out.append(chunk)
        amps_out = amps
    samples = np.concatenate(out)
    imp = impairments
    if imp is not None and (imp.frontend_bw_hz > 0 or imp.dc_offset_sigma):
        if imp.frontend_bw_hz > 0:
            samples = _frontend_filter(samples, plan, imp)
        if imp.dc_offset_sigma:
            samples = samples + imp.dc_offset_sigma * noise_sigma
    if not plan.complex_input and plan.quantize_bits == 1:
        samples = np.where(samples >= 0, 1.0, -1.0).astype(np.float32)
    elif not plan.complex_input:
        samples = samples.astype(np.float32)
    else:
        samples = samples.astype(np.complex64)
    truth = SimTruth(
        sats=list(sats),
        plan=plan,
        noise_sigma=noise_sigma,
        amplitudes=np.asarray(amps_out),
        impairments=impairments,
    )
    return samples, truth


def _frontend_filter(samples: np.ndarray, plan: SignalPlan,
                     imp: Impairments) -> np.ndarray:
    """Windowed-sinc FIR band-limiting of signal+noise (the MAX2769's
    analog IF filter role).  Low-pass of two-sided ``frontend_bw_hz``
    for complex baseband; band-pass centered on the IF for real plans.
    FFT overlap-add keeps long captures cheap (pure numpy)."""
    fs = plan.sample_rate_hz
    n_taps = imp.frontend_taps | 1                      # odd
    k = np.arange(n_taps) - (n_taps - 1) / 2
    h = (imp.frontend_bw_hz / fs) * np.sinc(k * imp.frontend_bw_hz / fs)
    h *= np.hamming(n_taps)
    if not plan.complex_input and plan.if_freq_hz:
        c_if = np.cos(2 * np.pi * plan.if_freq_hz / fs * k)
        h = 2.0 * h * c_if
        h /= np.sum(h * c_if)            # unit gain at the IF
    else:
        h /= np.sum(h)                   # unit gain at DC
    # overlap-add FFT convolution, 'same' alignment (group delay removed)
    blk = 1 << 18
    nfft = 1 << int(np.ceil(np.log2(blk + n_taps - 1)))
    H = np.fft.fft(h, nfft)
    out = np.zeros(len(samples) + n_taps - 1, dtype=np.complex128)
    for a in range(0, len(samples), blk):
        seg = samples[a: a + blk]
        conv = np.fft.ifft(np.fft.fft(seg, nfft) * H)[: len(seg) + n_taps - 1]
        out[a: a + len(seg) + n_taps - 1] += conv
    out = out[(n_taps - 1) // 2: (n_taps - 1) // 2 + len(samples)]
    return out if plan.complex_input else out.real


def _simulate_chunk(sats, sample0: int, n: int, plan: SignalPlan,
                    noise_sigma: float, rng,
                    imp: Optional[Impairments] = None,
                    pn_state: Optional[dict] = None) -> tuple:
    fs = plan.sample_rate_hz
    t = (sample0 + np.arange(n, dtype=np.float64)) / fs

    total = np.zeros(n, dtype=np.complex128 if plan.complex_input else np.float64)
    amps = []

    # receiver TCXO: integrated fractional clock error (seconds); shifts
    # every carrier by -delta*fL1 and slows/speeds the apparent code
    tcxo_int = np.zeros(1)
    if imp is not None and (imp.tcxo_offset_ppm or imp.tcxo_drift_ppm_s):
        tcxo_int = (imp.tcxo_offset_ppm * t
                    + 0.5 * imp.tcxo_drift_ppm_s * t * t) * 1e-6
    # common oscillator phase noise: Wiener walk carried across chunks
    pn = 0.0
    if imp is not None and imp.phase_noise_rad2_s > 0:
        sigma_step = np.sqrt(imp.phase_noise_rad2_s / fs)
        steps = rng.standard_normal(n) * sigma_step
        phi0 = pn_state["phi"] if pn_state else 0.0
        pn_rad = phi0 + np.cumsum(steps)
        if pn_state is not None:
            pn_state["phi"] = float(pn_rad[-1])
        pn = pn_rad / (2 * np.pi)                    # cycles

    for sat in sats:
        code = ca_code_bits(sat.prn)
        bipolar_code = (1 - 2 * code.astype(np.int8)).astype(np.float64)

        # Doppler chirp integral: f(t) = fd + rate*t  =>
        # carrier phase term fd*t + rate*t^2/2; the code rate follows
        # coherently via the same integral scaled by 1/fL1.
        dop_int = sat.doppler_hz * t + 0.5 * sat.doppler_rate_hz_s * t**2

        rays = [(1.0, 0.0, 0.0)]
        if sat.multipath_amp:
            rays.append((sat.multipath_amp,
                         sat.multipath_delay_chips / CODE_RATE_HZ,
                         sat.multipath_phase_cycles))
        amp = _amplitude_for_cn0(sat.cn0_dbhz, fs, noise_sigma)
        amps.append(amp)

        for ray_amp, ray_tau, ray_ph in rays:
            if sat.code_doppler:
                code_time = t + dop_int / FREQ_L1_HZ
            else:
                code_time = t.copy()
            code_time = code_time - tcxo_int - ray_tau
            if sat.delay_ms is not None:
                chip_total = CODE_RATE_HZ * (code_time - sat.delay_ms * 1e-3)
                epoch_offset = 0
            else:
                chip_total = sat.code_phase_chips + CODE_RATE_HZ * code_time
                epoch_offset = sat.nav_epoch_offset
            chip_idx = np.floor(chip_total).astype(np.int64)
            c = bipolar_code[chip_idx % CODE_LENGTH]

            # Nav-bit modulation: bit boundaries land on code-period
            # boundaries of the *transmitted* code (nav_data.c:15).
            period_idx = (
                np.floor_divide(chip_idx, CODE_LENGTH) + epoch_offset
            )
            if sat.nav_bits is not None:
                bits = np.asarray(sat.nav_bits, dtype=np.int64)
                bit_idx = np.floor_divide(
                    period_idx, sat.codes_in_bit) % len(bits)
                d = (1 - 2 * bits[bit_idx]).astype(np.float64)
            else:
                d = 1.0

            phase = (sat.carrier_phase_cycles + plan.if_freq_hz * t
                     + dop_int - FREQ_L1_HZ * tcxo_int + pn + ray_ph)
            a = amp * ray_amp
            if plan.complex_input:
                total += a * d * c * np.exp(2j * np.pi * phase)
            else:
                # Real IF signal; same C/N0 definition against real noise
                # of variance sigma^2 needs sqrt(2) amplitude scaling.
                total += a * np.sqrt(2.0) * d * c * np.cos(2 * np.pi * phase)

    if plan.complex_input:
        noise = noise_sigma * (
            rng.standard_normal(n) + 1j * rng.standard_normal(n)
        ) / np.sqrt(2.0)
        samples = total + noise
        if imp is None or (imp.frontend_bw_hz == 0
                           and not imp.dc_offset_sigma):
            samples = samples.astype(np.complex64)
    else:
        noise = noise_sigma * rng.standard_normal(n)
        samples = total + noise
        if imp is None or (imp.frontend_bw_hz == 0
                           and not imp.dc_offset_sigma):
            samples = samples.astype(np.float32)
            if plan.quantize_bits == 1:
                samples = np.where(samples >= 0, 1.0, -1.0).astype(
                    np.float32)

    return samples, amps
