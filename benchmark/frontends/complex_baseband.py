"""Complex baseband at the receiver's own 2.046 MHz, as complex64
samples: a replayed IQ file, handed to the receiver as it is."""

import numpy as np
import torch

from benchmark import gen

HOST_DTYPE = np.complex64
#: the host form is the receiver's input: no ingest on the card
to_baseband = None


def units_per_epoch(fe: dict) -> int:
    return gen.samples_per_epoch(fe)


def to_host(x: torch.Tensor, fe: dict) -> torch.Tensor:
    """The noisy samples ``x``, already complex64."""
    return x


def lag_s(fe: dict) -> float:
    """Each sample is taken at its own instant."""
    return 0.0
