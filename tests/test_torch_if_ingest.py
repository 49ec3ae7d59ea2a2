"""The real-IF ingest (signal/capture.py if_to_baseband_device): int8 real
samples at 38.192 MHz, IF 9.548 MHz = Fs/4 (SoftGNSS's recorded data), to
complex64 baseband at 2.046 MHz.

Its plain version (torch ops) and the g++ build of the kernel's arithmetic
(csrc/if_resample_host.cpp, the CUDA source's check without a GPU) are held
to the float64 reference (signal/if_reference.py) on seeded int8 windows,
at 1e-5 of the output's RMS: float32 accumulation of 128 taps sits near
1e-7 there, and half-precision taps miss by about 1e-3 (checked below).
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.signal import capture as cap
from stm32f4_sdr_gps_torch.signal.if_reference import (
    if_to_baseband_reference)
from stm32f4_sdr_gps_torch.utils import profiling

FS = 38192000.0
IF = 9548000.0
#: input samples a millisecond
SPE = 38192
TOL = 1e-5


def _window(seed, epochs=3, sigma=8.0):
    """Seeded int8 noise as the front end quantises it (sigma LSB,
    rounded, saturated at +/-127)."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(epochs * SPE) * sigma)
    return np.clip(x, -127, 127).astype(np.int8)


def _rel_err(got, ref):
    rms = ref.abs().pow(2).mean().sqrt()
    return float((got.to(torch.complex128) - ref).abs().max() / rms)


def test_plan_is_3_over_56_with_384_symmetric_taps():
    plan = cap.if_resample_plan(FS)
    assert (plan.L, plan.M, plan.P) == (3, 56, 128)
    assert plan.branches == (0, 2, 1)
    assert plan.offsets == (0, 18, 37)
    assert (plan.off_max, plan.D) == (37, 166)
    h = plan.taps
    assert h.shape == (384,)
    np.testing.assert_allclose(h, h[::-1], rtol=0, atol=1e-15)
    assert h.sum() == pytest.approx(6.0, abs=1e-12)
    # the shifted layout holds each output's branch, and zeros elsewhere
    for b in range(3):
        d0 = plan.off_max - plan.offsets[b]
        np.testing.assert_array_equal(
            plan.shifted[b, d0: d0 + 128],
            h[plan.branches[b]::3].astype(np.float32))
        assert not plan.shifted[b, :d0].any()
        assert not plan.shifted[b, d0 + 128:].any()
    assert plan.lag_s == pytest.approx(-383 / 2 / (3 * FS), rel=1e-15)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_version_matches_the_float64_reference(seed):
    x = _window(seed)
    got = cap.if_to_baseband_device(x, FS, IF, device="cpu")
    ref = if_to_baseband_reference(x, FS, IF)
    assert got.dtype == torch.complex64
    assert got.shape == (3 * 2046,)
    assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("seed", [4, 5])
def test_host_build_matches_the_reference_and_the_plain_version(seed):
    x = _window(seed, epochs=2, sigma=30.0)
    plan = cap.if_resample_plan(FS)
    host = cap.if_resample_host(torch.as_tensor(x), plan)
    ref = if_to_baseband_reference(x, FS, IF)
    assert _rel_err(host, ref) <= TOL
    plain = cap.if_to_baseband_plain(torch.as_tensor(x), plan)
    assert _rel_err(host, plain.to(torch.complex128)) <= TOL


@pytest.mark.parametrize("rate_hz", [16368000.0, 4092000.0])
def test_host_build_at_one_output_a_frame(rate_hz):
    """The kernel's other build, L = 1: the MAX2769's 16.368 MHz (and
    4.092 MHz), 8 (2) inputs an output, IF at a quarter of the rate."""
    plan = cap.if_resample_plan(rate_hz)
    assert (plan.L, plan.M) == (1, int(rate_hz) // 2046000)
    rng = np.random.default_rng(10)
    n = 2 * int(rate_hz) // 1000
    x = np.clip(np.round(rng.standard_normal(n) * 30.0), -127,
                127).astype(np.int8)
    host = cap.if_resample_host(torch.as_tensor(x), plan)
    ref = if_to_baseband_reference(x, rate_hz, rate_hz / 4)
    assert host.shape == (2 * 2046,)
    assert _rel_err(host, ref) <= TOL
    plain = cap.if_to_baseband_plain(torch.as_tensor(x), plan)
    assert _rel_err(host, plain.to(torch.complex128)) <= TOL


@pytest.mark.parametrize("rate_hz", [2046000.0 * 3 / 2, 2046000.0 * 5 / 4,
                                     2046000.0 * 56 / 5])
def test_rates_the_kernel_is_not_built_for_are_refused(rate_hz):
    """M odd, or L other than 1 and 3."""
    with pytest.raises(ValueError):
        cap.if_resample_ratio(rate_hz)


def test_half_precision_taps_fail_the_tolerance():
    """The tolerance tells a float32 filter from a half-precision one."""
    x = _window(6)
    plan = cap.if_resample_plan(FS)
    half = cap.IfResamplePlan(**{
        **plan.__dict__,
        "taps": plan.taps.astype(np.float16).astype(np.float64)})
    got = cap.if_to_baseband_plain(torch.as_tensor(x), half)
    err = _rel_err(got, if_to_baseband_reference(x, FS, IF))
    assert err > 30 * TOL


def test_unit_tone_at_the_if_is_a_unit_phasor():
    """A cosine 1 kHz above the IF comes out at +1 kHz with its amplitude
    (the sign of Doppler the receiver expects), past the filter's start."""
    n = 2 * SPE
    t = np.arange(n) / FS
    x = np.round(100.0 * np.cos(2 * np.pi * (IF + 1000.0) * t + 0.3))
    y = cap.if_to_baseband_device(x.astype(np.int8), FS, IF,
                                  device="cpu").numpy()[100:]
    assert np.abs(y).mean() == pytest.approx(100.0, rel=0.01)
    step = np.angle(y[1:] * np.conj(y[:-1])).mean()
    assert step == pytest.approx(2 * np.pi * 1000.0 / 2.046e6, rel=0.01)


def test_zeros_before_the_window_and_windows_cut_at_frames():
    """Each window starts from zero history: a window cut at an epoch
    boundary gives the outputs of the longer window it was cut from once
    the filter's reach (384 taps: 128 input samples, 7 outputs, back)
    lies inside it, and differs from them before."""
    x = _window(7, epochs=4)
    long = cap.if_to_baseband_device(x, FS, IF, device="cpu")
    short = cap.if_to_baseband_device(x[SPE:], FS, IF, device="cpu")
    assert torch.equal(long[2046 + 50:], short[50:])
    assert not torch.equal(long[2046:2046 + 3], short[:3])


def test_device_call_counts_one_upload_and_its_bytes():
    x = _window(8, epochs=1)
    before = dict(profiling.counters)
    cap.if_to_baseband_device(x, FS, IF, device="cpu")
    cap.if_to_baseband_device(torch.as_tensor(x), FS, IF, device="cpu")
    moved = {k: profiling.counters.get(k, 0) - before.get(k, 0)
             for k in ("upload", "condition.bytes")}
    # a tensor in host memory crosses to the card as the array does
    assert moved == {"upload": 2, "condition.bytes": 2 * SPE}
    assert [s.name for s in profiling.spans][-2:] == ["condition"] * 2


@pytest.mark.parametrize("bad", ["if", "frames", "rate", "dtype"])
def test_refuses_what_it_cannot_condition(bad):
    x = _window(9, epochs=1)
    with pytest.raises(ValueError):
        if bad == "if":
            cap.if_to_baseband_device(x, FS, 9.5e6, device="cpu")
        elif bad == "frames":
            cap.if_to_baseband_device(x[:1000], FS, IF, device="cpu")
        elif bad == "rate":
            cap.if_to_baseband_device(x, 10e6, 2.5e6, device="cpu")
        else:
            cap.if_to_baseband_plain(torch.as_tensor(x, dtype=torch.int16),
                                     cap.if_resample_plan(FS))


def _prompt_snr_loss_db(frac):
    """Prompt SNR of a noiseless satellite through the ingest, over
    C/N0 T of the same satellite at complex baseband (where the
    generator's rectangular chips reach the replica whole), in dB: one
    epoch of the code, its chip edges ``frac`` of a chip after the
    window's start, the replica's phase the best on the receiver's
    grid; the noise's share from the filter's adjoint on the replica."""
    plan = cap.if_resample_plan(FS)
    rng = np.random.default_rng(11)
    code = np.sign(rng.standard_normal(1023))
    n = 3 * SPE
    t = np.arange(n) / FS
    a = 100.0                                  # LSB, far above rounding
    chips = code[np.floor(t * 1.023e6 + frac).astype(int) % 1023]
    x = np.round(a * chips * np.cos(2 * np.pi * IF * t)).astype(np.int8)
    y = cap.if_to_baseband_device(x, FS, IF, device="cpu").numpy()
    m = np.arange(2046, 4092)                  # the second epoch
    tm = m / 2.046e6 + plan.lag_s
    best, rep = 0.0, None
    for d in np.linspace(-0.5, 0.5, 41):
        r = code[np.floor(tm * 1.023e6 + frac + d).astype(int) % 1023]
        p = abs(np.sum(y[m] * r))
        if p > best:
            best, rep = p, r
    # prompt noise: input noise of unit variance through the adjoint,
    # g[i] = sum_m r[m] h[M m - L i]
    up = np.zeros(plan.M * 4092)
    up[plan.M * m] = rep
    z = np.correlate(up, plan.taps, mode="full")
    g = z[plan.taps.size - 1::plan.L]
    snr = best ** 2 / np.sum(g ** 2)
    ideal = a ** 2 * FS / 4.0 * 1e-3           # C/N0 T at unit noise
    return 10.0 * np.log10(snr / ideal)


def test_prompt_snr_loss_against_complex_baseband():
    """At 2 samples a chip a band-limited signal loses prompt power where
    the output samples straddle the chip edges: over 16 alignments -0.42
    dB where they sit mid-chip, -1.60 dB where they straddle, -0.87 dB on
    the mean; a near brick wall at 1.023 MHz (768 taps a branch) reads
    -0.49, -1.62 and -0.94 dB on the same code."""
    loss = [_prompt_snr_loss_db(f) for f in np.arange(16) / 16.0]
    assert max(loss) >= -0.5
    assert np.mean(loss) >= -0.95
    assert min(loss) >= -1.7
