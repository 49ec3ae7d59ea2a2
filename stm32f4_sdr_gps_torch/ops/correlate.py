"""Correlation primitives: FFT circular correlation and the E/P/L bank
(torch port of the JAX package's ops/correlate.py, FFT path only).

* acquisition evaluates *all* code lags of an epoch at once via
  ``IFFT(FFT(x) . conj(FFT(c)))``; ``torch.fft`` takes the 2046-sample
  epoch length directly;
* tracking evaluates the three E/P/L lags for all channels as one fused
  multiply-reduce (gps_correlation_iq x3, tracking.c:136-138).

The matmul-DFT and bit-packed code-table variants of the JAX package are
not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CODE_LENGTH, CODE_RATE_HZ, SignalPlan
from ..signal.ca_code import ca_code_bits


def sampled_code_table(prns, plan: SignalPlan, dtype=np.float32) -> np.ndarray:
    """(P, S) bipolar codes sampled at the plan rate with zero code phase."""
    s = plan.samples_per_epoch
    idx = (
        np.floor(np.arange(s) * (CODE_RATE_HZ / plan.sample_rate_hz))
        .astype(np.int64) % CODE_LENGTH
    )
    rows = []
    for prn in prns:
        bits = ca_code_bits(prn)[idx]
        rows.append((1 - 2 * bits.astype(np.int32)).astype(dtype))
    return np.stack(rows)


def code_fft_conj(prns, plan: SignalPlan, device="cpu") -> torch.Tensor:
    """conj(FFT) of the sampled codes, precomputed once per PRN set."""
    table = torch.as_tensor(sampled_code_table(prns, plan), device=device)
    return torch.fft.fft(table, dim=-1).conj().resolve_conj()


def fft_circular_correlate(
    x: torch.Tensor,            # (..., S) complex epochs
    cfc: torch.Tensor,          # (P, S) conj code FFTs
) -> torch.Tensor:
    """Circular correlation of x against every PRN: (..., P, S) complex.

    Lag convention: ``corr[..., p, m] = sum_k x[k] * c[(k - m) % S]`` (c is
    real).  For a signal whose code phase at sample 0 is ``phi`` chips, the
    peak lands at ``m = (S - phi / chips_per_sample) % S``; use
    ``lag_to_code_phase`` to convert.
    """
    X = torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(X[..., None, :] * cfc, dim=-1)


def epl_correlate(
    y: torch.Tensor,            # (C, n) baseband (carrier-wiped) signal
    replicas: torch.Tensor,     # (C, L, n) sampled bipolar replicas
) -> torch.Tensor:
    """(C, L) complex correlator outputs: sum_k y[c,k] * r[c,l,k].

    The bipolar replica is real, so the sums are two real contractions on
    y's components."""
    reps = replicas.to(torch.float32)
    i_part = torch.einsum("cn,cln->cl", y.real.to(torch.float32), reps)
    q_part = torch.einsum("cn,cln->cl", y.imag.to(torch.float32), reps)
    return torch.complex(i_part, q_part)


def lag_to_code_phase(lag_samples, plan: SignalPlan):
    """Convert an FFT-correlation peak lag (samples, possibly fractional)
    to the signal's code phase at sample 0, in chips [0, 1023)."""
    s = plan.samples_per_epoch
    return ((s - np.asarray(lag_samples)) % s) * plan.chips_per_sample


def noncoherent_power(corr: torch.Tensor) -> torch.Tensor:
    """|corr|^2 as float32 (acquisition non-coherent accumulation unit)."""
    return (corr.real ** 2 + corr.imag ** 2).to(torch.float32)
