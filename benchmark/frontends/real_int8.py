"""SoftGNSS's front end (Borre et al. 2007, ``initSettings.m``): int8 real
samples at 38.192 MHz with the IF at 9.548 MHz, a quarter of the rate,
as the book's recorded data holds them.  The generator's noise is
quantised at 8 LSB, rounded and saturated at +-127.  The program
conditions the samples on the card (``signal/capture.py``
``if_to_baseband_device``: the exact quarter-rate mix and a 3/56
polyphase resampler to 2.046 MHz baseband, one kernel launch a window);
``ref_real_int8`` is the plain reference of that ingest."""

import numpy as np
import torch

from benchmark import gen, ref_real_int8

HOST_DTYPE = np.int8
#: the source's rates, the only ones this front end takes
SAMPLE_RATE_HZ = 38192000.0
IF_HZ = 9548000.0
#: the quantiser: the unit-variance noise at 8 LSB, int8's full scale
SIGMA_LSB = 8.0
FULL_SCALE = 127


def _check(fe: dict) -> None:
    if (fe["sample_rate_hz"], fe.get("if_hz")) != (SAMPLE_RATE_HZ, IF_HZ):
        raise ValueError(f"real_int8 takes {SAMPLE_RATE_HZ} Hz with the IF "
                         f"at {IF_HZ} Hz, not {fe['sample_rate_hz']} / "
                         f"{fe.get('if_hz')}")


def units_per_epoch(fe: dict) -> int:
    _check(fe)
    return gen.samples_per_epoch(fe)


def to_host(x: torch.Tensor, fe: dict) -> torch.Tensor:
    """The noisy real samples ``x`` quantised to int8."""
    return torch.clamp(torch.round(x * SIGMA_LSB), -FULL_SCALE,
                       FULL_SCALE).to(torch.int8)


def lag_s(fe: dict) -> float:
    """The resampler's delay: from an epoch's start to the centre of its
    first baseband sample, negative (``ref_real_int8.lag_s``)."""
    _check(fe)
    return ref_real_int8.lag_s(fe["sample_rate_hz"])


def to_baseband(samples: np.ndarray, device) -> torch.Tensor:
    from stm32f4_sdr_gps_torch.signal.capture import if_to_baseband_device

    return if_to_baseband_device(samples, SAMPLE_RATE_HZ, IF_HZ,
                                 device=device)
