"""The work of the real-IF ingest kernel (the program's
``csrc/if_resample.cu``), counted from the window alone, the same
whatever implements it: each int8 input sample read once and each
complex64 output (L of every M input samples) written once.  Its
operations (L * 128 multiply-adds an output's worth of taps, 2.7 us a
266 ms window at the FP32 peak) stay under the bytes' time, so the
bytes bound it."""

from __future__ import annotations

from .roofline import PEAK_HBM_BYTES_S


def if_resample_bytes(samples_in: int, up: int = 3, down: int = 56) -> int:
    """Bytes a window of ``samples_in`` int8 samples must move: 3/56 of
    them come out as complex64 at 38.192 MHz."""
    return samples_in + samples_in * up // down * 8


def if_resample_bound_s(samples_in: int, up: int = 3,
                        down: int = 56) -> float:
    """The least time the card could take for one window."""
    return if_resample_bytes(samples_in, up, down) / PEAK_HBM_BYTES_S
