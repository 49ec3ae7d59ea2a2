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
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import REFERENCE_PLAN, SignalPlan
from ..utils.device import card_or_cpu, upload
from ..utils.profiling import span

REF_DECIMATION = 8  # 16.368 MHz -> 2.046 MHz


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
