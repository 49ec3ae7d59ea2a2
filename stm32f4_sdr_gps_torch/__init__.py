"""GPS L1 C/A software-defined receiver in PyTorch, with its tracking loop
as a hand-written CUDA kernel for NVIDIA Hopper.

A port of ``stm32f4_sdr_gps_tpu`` (the JAX/Pallas reference package,
which stays beside it): FFT-parallel acquisition, batched multi-channel
DLL/PLL/FLL tracking, nav-message decode and least-squares PVT.  It
imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
