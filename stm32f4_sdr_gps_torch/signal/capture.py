"""IQ capture ingest: file formats + reference front-end conditioner
(torch port of the JAX package's signal/capture.py).

The reference receives a 1-bit real sign stream at 16.368 MHz (IF
4.092 MHz ~= Fs/4) over SPI as 16-bit LSB-first words
(``signal_capture.c:9-11, 143-177``) and wipes the carrier off with a
binary Fs/4 NCO (``gps_misc.c:211-240``).  The receiver works on complex
baseband at 2.046 MHz; this module converts the reference's wire format
into that plan so recorded firmware captures remain usable:

    1-bit words --unpack--> +/-1 @16.368MHz --mix e^{-j2pi*IF*t}-->
    complex @16.368MHz --boxcar-8 decimate--> complex64 @2.046MHz

Packing helpers mirror the SPI bit order so synthetic captures can be
round-tripped.  :func:`reference_to_baseband` is the host conditioner;
:func:`reference_to_baseband_device` does the whole conversion on the
card from the packed words.

Multi-bit real IF at a rate that is no integer multiple of 2.046 MHz
(SoftGNSS's int8 samples at 38.192 MHz, IF 9.548 MHz = Fs/4) takes
:func:`if_to_baseband_device`:

    int8 @38.192MHz --mix [1, -j, -1, j]--> complex --up 3, low-pass,
    down 56--> complex64 @2.046MHz

one launch of the hand-written kernel ``csrc/if_resample.cu`` a window on
the card, its plain version :func:`if_to_baseband_plain` (torch ops) on
the CPU, and the float64 reference in ``signal/if_reference.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction

import numpy as np
import torch

from ..config import REFERENCE_PLAN, SignalPlan
from ..utils import graphs
from ..utils.device import card_or_cpu, upload, upload_window
from ..utils.profiling import count, span

REF_DECIMATION = 8  # 16.368 MHz -> 2.046 MHz

#: the receiver's baseband rate, 2 samples a chip
BASEBAND_HZ = 2046000
#: the real-IF ingest's low-pass filter, designed at L times the input rate
#: (114.576 MHz for 38.192 MHz): a Kaiser-windowed sinc of L * 128 taps
#: (384 at L = 3), -6 dB at 1.023 MHz (the C/A main lobe's first null,
#: where the 2-samples-a-chip replica has its own null, so what the
#: transition band folds in costs the prompt nearly nothing), beta 8
#: (side lobes near -80 dB, so the 18.7-fold fold-down of the input band
#: adds no noise worth counting).  Prompt SNR against the same satellite
#: at complex baseband (tests/test_torch_if_ingest.py): -0.42 dB where
#: the output samples sit mid-chip, -1.60 dB where they straddle the chip
#: edges, -0.87 dB over every alignment; a near brick wall (768 taps a
#: branch) reads -0.49 / -1.62 / -0.94 dB: the loss is the band limit's at
#: 2 samples a chip, not the filter's.
IF_TAPS_PER_PHASE = 128
IF_CUTOFF_HZ = 1.023e6
IF_KAISER_BETA = 8.0


def pack_bits_lsb16(signs: np.ndarray) -> np.ndarray:
    """Pack a +/-1 (or 0/1) sample stream into uint16 words, LSB-first —
    the SPI wire format (signal_capture.c:143-177: 16-bit words, LSB
    first; bit=1 encodes a positive sign sample)."""
    bits = (np.asarray(signs).reshape(-1) > 0).astype(np.uint8)
    if bits.size % 16:
        raise ValueError("sample count must be a multiple of 16")
    bits = bits.reshape(-1, 16)
    weights = (1 << np.arange(16, dtype=np.uint32))
    return (bits.astype(np.uint32) @ weights).astype(np.uint16)


def unpack_bits_lsb16(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_bits_lsb16`; returns float32 +/-1."""
    words = np.asarray(words, dtype=np.uint16)
    bits = (words[:, None] >> np.arange(16, dtype=np.uint16)) & 1
    return (bits.astype(np.float32) * 2.0 - 1.0).reshape(-1)


def reference_to_baseband(
    signs: np.ndarray,
    plan: SignalPlan = REFERENCE_PLAN,
    decimation: int = REF_DECIMATION,
) -> np.ndarray:
    """Convert +/-1 real samples at the reference plan to complex baseband,
    on the host.

    Exact complex mix at ``plan.if_freq_hz`` followed by a boxcar-``decimation``
    integrate-and-dump.  Output rate = plan.sample_rate_hz / decimation
    (2.046 MHz for the reference plan).  Magnitude is normalized so a unit
    input tone at IF yields ~unit output amplitude.  The general mix runs
    as torch ops on CPU tensors.
    """
    n = (len(signs) // decimation) * decimation
    x = np.asarray(signs[:n], dtype=np.float32)
    fs = plan.sample_rate_hz
    # IF/fs = 1/4 for the reference plan => the mix sequence is exactly
    # 4-periodic [1, -j, -1, j] (the firmware's binary quarter-rate
    # trick, gps_misc.c:216-217).  With the default boxcar-8 this
    # reduces to pure strided float32 adds — no complex multiply, no
    # exp().
    if (abs(plan.if_freq_hz * 4.0 - fs) < 1e-6 and decimation == 8
            and n % 8 == 0):
        x8 = x.reshape(-1, 8)
        re = (x8[:, 0] - x8[:, 2]) + (x8[:, 4] - x8[:, 6])
        im = (x8[:, 3] - x8[:, 1]) + (x8[:, 7] - x8[:, 5])
        out = np.empty(len(x8), np.complex64)
        out.real = re * np.float32(2.0 / decimation)
        out.imag = im * np.float32(2.0 / decimation)
        return out
    t = np.arange(n, dtype=np.float64) / fs
    mix = np.exp(-2j * np.pi * plan.if_freq_hz * t).astype(np.complex64)
    y = torch.as_tensor(x) * torch.as_tensor(mix)
    y = y.reshape(-1, decimation).sum(dim=1) * (2.0 / decimation)
    return y.numpy().astype(np.complex64)


def reference_to_baseband_device(words, decimation: int = REF_DECIMATION,
                                 device="cuda") -> torch.Tensor:
    """The wire-format conditioner on ``device``: the card unless the
    caller asks for the CPU; raises without a card.

    Takes the packed uint16 SPI words exactly as they arrive off the wire
    (signal_capture.c:143-177; a numpy array or a tensor) and produces
    complex64 baseband at sample_rate/decimation on the device:
    LSB-first unpack to +/-1, exact Fs/4 complex mix (the IF/fs = 1/4
    sequence [1, -j, -1, j], gps_misc.c:216-217), boxcar
    integrate-and-dump.  Matches :func:`reference_to_baseband` to f32
    rounding (the host's general mix evaluates exp() in f64; this one
    uses the exact quarter-rate values).  Chunked use must cut at whole
    epochs (16368 samples = 1023 words) so the mix phase stays aligned.
    Only the packed words cross to the device: 2 046 bytes a millisecond
    instead of the 16x larger complex stream.

    The call is the span ``condition`` (``utils.profiling``), which
    holds host time only: the upload and the launches.  The kernels run
    on after it returns, and finish inside the next readback.
    """
    device = card_or_cpu(device, "reference_to_baseband_device")
    with span("condition"):
        if isinstance(words, torch.Tensor):
            w = words.to(device=device, dtype=torch.int32)
        else:
            w = upload(np.asarray(words, np.uint16), device).to(torch.int32)
        shifts = torch.arange(16, dtype=torch.int32, device=device)
        bits = (w[:, None] >> shifts) & 1
        signs = bits.to(torch.float32).reshape(-1) * 2.0 - 1.0
        n = (signs.shape[0] // decimation) * decimation
        signs = signs[:n]
        # e^{-j*2*pi*(fs/4)*t} at t = k/fs is exactly (-j)^k
        mix = upload([1, -1j, -1, 1j], device, torch.complex64)
        y = signs.to(torch.complex64) * mix.repeat(n // 4)
        return y.reshape(-1, decimation).sum(dim=1) * (2.0 / decimation)


def if_resample_ratio(sample_rate_hz: float) -> tuple:
    """``(L, M)``: ``sample_rate_hz`` is ``M / L`` times 2.046 MHz in
    lowest terms ((3, 56) at 38.192 MHz, (1, 8) at 16.368 MHz).  Raises
    for a rate that is not a whole number of Hz, whose M is odd (the
    kernel walks its samples two at a time) or whose L is neither 1 nor
    3, the two the kernel is built for (with M even, L is odd)."""
    fs = float(sample_rate_hz)
    if fs <= 0 or fs != round(fs):
        raise ValueError(f"sample rate {fs!r} Hz: want a whole number of Hz")
    ratio = Fraction(int(round(fs)), BASEBAND_HZ)
    if (ratio.denominator not in (1, 3) or ratio <= 1
            or ratio.numerator % 2):
        raise ValueError(f"sample rate {fs:.0f} Hz is {ratio} of 2.046 MHz: "
                         "the ingest takes M / L with L 1 or 3, M > L and "
                         "M even")
    return ratio.denominator, ratio.numerator


def if_resample_taps(sample_rate_hz: float) -> np.ndarray:
    """The real-IF ingest's low-pass taps ``h[k]``, k < L * 128, in
    float64, at L times ``sample_rate_hz`` (``IF_CUTOFF_HZ``,
    ``IF_KAISER_BETA``), summing to 2 L: the zeros put in between the
    samples and the mix's halving of a real tone undone, so a unit cosine
    at the IF comes out as a unit phasor."""
    up, _ = if_resample_ratio(sample_rate_hz)
    n = up * IF_TAPS_PER_PHASE
    wc = 2.0 * IF_CUTOFF_HZ / (up * float(sample_rate_hz))
    k = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = wc * np.sinc(wc * k) * np.kaiser(n, IF_KAISER_BETA)
    return h * (2.0 * up / h.sum())


@dataclasses.dataclass(frozen=True)
class IfResamplePlan:
    """How a window of ``M * frames`` input samples becomes ``L * frames``
    outputs.  Output ``m = L a + b`` (frame a) is the FIR's output at the
    up-sampled instant ``M m``: sum over j < P of ``h[r_b + L j]`` times
    mixed sample ``i_max - j``, with ``r_b = M b mod L`` its branch and
    ``i_max = M a + offsets[b]`` its newest sample (samples before the
    window are zeros).  Its centre lies ``(L P - 1) / 2`` up-sampled
    samples before ``M m``: ``lag_s`` after its own instant, negative.
    ``shifted`` lays each output's taps out against the frame's newest
    sample ``M a + off_max``: ``shifted[b, d]`` multiplies sample
    ``M a + off_max - d``, zero outside output b's P taps (the kernel's
    layout, ``csrc/if_resample.cuh``)."""
    L: int
    M: int
    P: int
    offsets: tuple
    branches: tuple
    off_max: int
    D: int
    lag_s: float
    taps: np.ndarray
    shifted: np.ndarray


@functools.cache
def if_resample_plan(sample_rate_hz: float) -> IfResamplePlan:
    """The plan for int8 real samples at ``sample_rate_hz``, made once a
    rate."""
    L, M = if_resample_ratio(sample_rate_hz)
    P = IF_TAPS_PER_PHASE
    h = if_resample_taps(sample_rate_hz)
    branches = tuple((M * b) % L for b in range(L))
    offsets = tuple((M * b - r) // L for b, r in enumerate(branches))
    off_max = max(offsets)
    D = P + off_max + ((P + off_max) & 1)
    shifted = np.zeros((L, D), np.float32)
    for b in range(L):
        d0 = off_max - offsets[b]
        shifted[b, d0: d0 + P] = h[branches[b]::L][:P]
    return IfResamplePlan(
        L=L, M=M, P=P, offsets=offsets, branches=branches, off_max=off_max,
        D=D,
        lag_s=-(L * P - 1) / 2.0 / (L * float(sample_rate_hz)),
        taps=h, shifted=shifted)


def _quarter_rate_signed(x: torch.Tensor) -> torch.Tensor:
    """The samples as float32, each times its quarter-rate mix sign
    (``csrc/if_resample.cuh`` ``mix_sign``): even samples are the mixed
    sample's real part, odd ones its imaginary part."""
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float32,
                        device=x.device)
    i = torch.arange(x.numel(), device=x.device)
    return x.to(torch.float32) * sign[i % 4]


def _check_samples(x: torch.Tensor, plan: IfResamplePlan) -> None:
    if (x.dtype != torch.int8 or x.dim() != 1 or x.numel() % plan.M
            or not x.is_contiguous()):
        raise ValueError(f"want a contiguous 1-D int8 tensor of whole frames "
                         f"of {plan.M} samples, got {tuple(x.shape)} "
                         f"{x.dtype}")


def if_to_baseband_plain(x: torch.Tensor,
                         plan: IfResamplePlan) -> torch.Tensor:
    """The plain version of the ingest kernel, in torch ops on ``x``'s
    device: int8 samples ``x`` (M * frames of them) to L * frames
    complex64 outputs, each the float32 sum over its P taps of the
    signed samples (the kernel's plan, another order of addition), 65,536
    outputs at a time."""
    _check_samples(x, plan)
    dev = x.device
    L, M, P = plan.L, plan.M, plan.P
    s = _quarter_rate_signed(x)
    by_branch = torch.as_tensor(
        np.stack([plan.taps[r::L][:P] for r in range(L)]),
        dtype=torch.float32, device=dev)                       # (L, P)
    n_out = x.numel() // M * L
    j = torch.arange(P, device=dev)
    zero = torch.zeros((), device=dev)
    out = torch.empty(n_out, dtype=torch.complex64, device=dev)
    for m0 in range(0, n_out, 1 << 16):
        m = torch.arange(m0, min(m0 + (1 << 16), n_out), device=dev)
        u = M * m
        r = u % L
        idx = ((u - r) // L)[:, None] - j[None, :]             # (C, P)
        prod = torch.where(idx >= 0, s[idx.clamp(min=0)], zero) * \
            by_branch[r]
        odd = (idx % 2).to(torch.bool)
        out[m0: m0 + len(m)] = torch.complex(
            torch.where(odd, zero, prod).sum(dim=1),
            torch.where(odd, prod, zero).sum(dim=1))
    return out


def _resample_args(x, plan, taps):
    """The output and the argument list both builds of the kernel take,
    after the checks they share."""
    _check_samples(x, plan)
    if (taps.dtype != torch.float32 or taps.shape != (plan.L, plan.D)
            or not taps.is_contiguous() or taps.device != x.device):
        raise ValueError(f"taps: want ({plan.L}, {plan.D}) float32 on "
                         f"{x.device}, got {tuple(taps.shape)} {taps.dtype} "
                         f"on {taps.device}")
    # the kernel's shared memory: the taps and a block's 128 frames
    count_ = plan.M * 127 + plan.D
    smem = 4 * (plan.L * plan.D + count_ + count_ // plan.M + 1)
    if smem > 48 * 1024:
        raise ValueError(f"M = {plan.M}: the kernel's shared tile would "
                         f"take {smem} bytes, over 48 KB")
    frames = x.numel() // plan.M
    out = torch.empty(plan.L * frames, dtype=torch.complex64,
                      device=x.device)
    return out, [x.data_ptr(), taps.data_ptr(), out.data_ptr(), x.numel(),
                 frames, plan.L, plan.M, plan.D, plan.off_max]


def if_resample_cuda(x: torch.Tensor, plan: IfResamplePlan,
                     taps: torch.Tensor) -> torch.Tensor:
    """:func:`if_to_baseband_plain` on the card: one launch of
    ``csrc/if_resample.cu`` over the window, with no host
    synchronisation.  ``taps`` is ``plan.shifted`` on the card.
    ``if_resample_cuda.launches`` counts kernel launches."""
    from ..ops.kernel_lib import if_resample_lib

    if not x.is_cuda:
        raise ValueError("if_resample_cuda needs CUDA tensors")
    out, args = _resample_args(x, plan, taps)
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel's "
                         "16-byte loads)")
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = if_resample_lib().if_resample_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"if_resample kernel launch failed: CUDA error "
                           f"{rc}")
    if_resample_cuda.launches += 1
    return out


if_resample_cuda.launches = 0
graphs.count_launches(if_resample_cuda)


def if_resample_host(x: torch.Tensor, plan: IfResamplePlan) -> torch.Tensor:
    """The kernel's arithmetic built for the host with g++
    (``csrc/if_resample_host.cpp``) on a CPU tensor: the kernel's output
    bit for bit, the check of the CUDA source on a machine without a
    GPU."""
    from ..ops.kernel_lib import host_lib

    if x.device.type != "cpu":
        raise ValueError("if_resample_host needs a CPU tensor")
    out, args = _resample_args(x, plan, torch.as_tensor(plan.shifted))
    if host_lib().if_resample_host(*args) != 0:
        raise ValueError(f"if_resample_host: no build for L = {plan.L}")
    return out


@functools.cache
def _device_taps(sample_rate_hz: float, device: str) -> torch.Tensor:
    """The plan's shifted taps on ``device``, uploaded once a rate."""
    return upload(if_resample_plan(sample_rate_hz).shifted, device)


def if_to_baseband_device(samples, sample_rate_hz: float, if_hz: float,
                          device="cuda") -> torch.Tensor:
    """The real-IF conditioner on ``device``: the card unless the caller
    asks for the CPU; raises without a card.

    Takes int8 real samples (a numpy array, or a tensor, which is used
    where it lies unless that is host memory) at a rate that is
    M / L of 2.046 MHz, with the IF at a quarter of it (SoftGNSS's
    38.192 MHz / 9.548 MHz: L = 3, M = 56), a whole number of M-sample
    frames that starts at an epoch boundary, and returns complex64
    baseband at 2.046 MHz on the device, L outputs a frame (2,046 a
    millisecond): the int8 samples uploaded (one ``upload``; the
    counter ``condition.bytes`` adds their bytes; a window of a larger
    host buffer, or a pinned tensor, crosses by DMA from page-locked
    memory, ``utils.device.upload_window``), mixed by the exact
    quarter-rate sequence [1, -j, -1, j] and resampled by the polyphase
    low-pass of :func:`if_resample_taps` (up L, down M; zeros before the
    window's first sample), in one launch of ``csrc/if_resample.cu`` on
    the card and :func:`if_to_baseband_plain` on the CPU.  Output sample
    0 is centred ``if_resample_plan(rate).lag_s`` after the window's
    start (before it: the filter's delay).  The taps go to each device
    once a rate.

    The call is the span ``condition`` (``utils.profiling``), which
    holds host time only: the upload and the launch."""
    device = card_or_cpu(device, "if_to_baseband_device")
    plan = if_resample_plan(float(sample_rate_hz))
    if abs(4.0 * float(if_hz) - float(sample_rate_hz)) > 1e-6:
        raise ValueError(f"IF {if_hz} Hz is not a quarter of the sample "
                         f"rate {sample_rate_hz} Hz")
    with span("condition"):
        if isinstance(samples, torch.Tensor) and samples.device.type != "cpu":
            # already on a device: nothing crosses from the host
            x = samples.to(device=device, dtype=torch.int8)
            if not x.is_contiguous() or x.data_ptr() % 16:
                x = x.clone(memory_format=torch.contiguous_format)
        else:
            host = samples
            if not (isinstance(samples, torch.Tensor) and samples.is_pinned()
                    and samples.dtype == torch.int8
                    and samples.is_contiguous()):
                host = np.ascontiguousarray(samples, dtype=np.int8)
            count("condition.bytes", host.nbytes)
            x = upload_window(host, device)
        if device.type == "cuda":
            return if_resample_cuda(
                x, plan, _device_taps(float(sample_rate_hz), str(device)))
        return if_to_baseband_plain(x, plan)


def read_capture(path: str, fmt: str = "auto") -> np.ndarray:
    """Read an IQ capture file into complex64.

    Formats:
      * ``npy``   — .npy holding complex64/complex128
      * ``cf32``  — interleaved float32 I,Q
      * ``ci8``   — interleaved int8 I,Q (normalized to [-1, 1])
      * ``bits16``— reference packed 1-bit words (converted to baseband)
    """
    if fmt == "auto":
        fmt = "npy" if path.endswith(".npy") else "cf32"
    if fmt == "npy":
        arr = np.load(path)
        return np.asarray(arr, dtype=np.complex64)
    if fmt == "cf32":
        raw = np.fromfile(path, dtype=np.float32)
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "ci8":
        raw = np.fromfile(path, dtype=np.int8).astype(np.float32) / 127.0
        return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
    if fmt == "bits16":
        words = np.fromfile(path, dtype=np.uint16)
        return reference_to_baseband(unpack_bits_lsb16(words))
    raise ValueError(f"unknown capture format {fmt!r}")
