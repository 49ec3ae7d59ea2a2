"""The card's peaks and the work of the kernels the benchmark prices.

K1 is the tracking scan (``csrc/track_scan.cu``): T epochs of S samples
through C channels in one launch.  Its work is counted from the shapes
alone, the same whatever implements it:

* operations: 25 per sample and channel, the basis of PERF.md's kernel
  table: the carrier NCO step and the complex wipe-off of the sample
  (10), the early, prompt and late sums of a complex sample against a
  real code chip (12), and the code NCO's step and half-chip index (3);
* bytes: the complex64 samples read once, each channel's doubled
  upsampled code row (U2P floats) read once, the 11 float32 outputs an
  epoch and channel written once, and the carried state (30 words and
  the watchdog's window a channel) read and written.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12

K1_OPS_PER_SAMPLE_CHANNEL = 25
U2P = 4352
K1_OUTPUTS = 11
K1_STATE_WORDS = 16 + 14 + 4


def k1_ops(t: int, c: int, s: int = 2046) -> float:
    return float(K1_OPS_PER_SAMPLE_CHANNEL) * t * s * c


def k1_bytes(t: int, c: int, s: int = 2046) -> float:
    return float(t * s * 8 + c * U2P * 4 + t * c * K1_OUTPUTS * 4
                 + 2 * c * K1_STATE_WORDS * 4)


def k1_bound_s(t: int, c: int, s: int = 2046) -> float:
    """The least time the card could take for one launch."""
    return max(k1_ops(t, c, s) / PEAK_FP32_FLOPS,
               k1_bytes(t, c, s) / PEAK_HBM_BYTES_S)
