"""The firmware's front end: MAX2769 1-bit real IF at 16.368 MHz, each
sample's sign packed 16 to a uint16 SPI word, LSB first
(``native/capture_gen.cpp``).  The program conditions the words on the
card (``signal/capture.py`` ``reference_to_baseband_device``: unpack,
Fs/4 mix, 8-sample integrate-and-dump to 2.046 MHz baseband)."""

import numpy as np
import torch

from benchmark import gen

#: SPI words a millisecond: 16,368 samples, 16 a word
WORDS_PER_EPOCH = 1023
HOST_DTYPE = np.uint16
#: the receiver's baseband rate: 2 samples a chip
BASEBAND_HZ = 2.046e6


def units_per_epoch(fe: dict) -> int:
    return WORDS_PER_EPOCH


def to_host(x: torch.Tensor, fe: dict) -> torch.Tensor:
    """The signs of the noisy real samples ``x`` as words: the uint16
    values' bit patterns as int16 (torch copies no uint16)."""
    w = gen.pack_words(x)
    return (w - (w >= 32768).to(torch.int32) * 65536).to(torch.int16)


def lag_s(fe: dict) -> float:
    """Time from an epoch's start to the centre of its first baseband
    sample: the wire's samples reach baseband summed ``fs / 2.046 MHz``
    at a time (the firmware's integrate-and-dump), so each baseband
    sample stands for the middle of its run."""
    d = int(round(fe["sample_rate_hz"] / BASEBAND_HZ))
    return (d - 1) / 2.0 / fe["sample_rate_hz"]


def to_baseband(words: np.ndarray, device) -> torch.Tensor:
    from stm32f4_sdr_gps_torch.signal.capture import (
        reference_to_baseband_device)

    return reference_to_baseband_device(words, device=device)
