"""Correlation primitives: FFT circular correlation and the E/P/L bank
(torch port of the JAX package's ops/correlate.py).

* acquisition evaluates *all* code lags of an epoch at once via
  ``IFFT(FFT(x) . conj(FFT(c)))``; ``torch.fft`` takes the 2046-sample
  epoch length directly.  The matmul-DFT variant computes the same
  transforms as dense (S, S) products (``matmul_circular_correlate``),
  from a bit-packed code table (``pack_code_bits``);
* tracking evaluates the three E/P/L lags for all channels as one fused
  multiply-reduce (gps_correlation_iq x3, tracking.c:136-138).
"""

from __future__ import annotations


import numpy as np
import torch

from ..config import CODE_LENGTH, CODE_RATE_HZ, SignalPlan
from ..signal.ca_code import ca_code_bits
from ..utils.device import card_or_cpu, upload


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


def code_fft_conj(prns, plan: SignalPlan, device="cuda") -> torch.Tensor:
    """conj(FFT) of the sampled codes, precomputed once per PRN set, on
    ``device``: the card unless the caller asks for the CPU; raises
    without a card."""
    device = card_or_cpu(device, "code_fft_conj")
    table = upload(sampled_code_table(prns, plan), device)
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


def pack_code_bits(prns, plan: SignalPlan) -> np.ndarray:
    """(P, ceil(S/8)) uint8 — sampled C/A code chips, bit-packed
    MSB-first (np.packbits); ``unpack_code_table`` rebuilds the bipolar
    table on the device."""
    table = sampled_code_table(prns, plan)
    return np.packbits((table < 0).astype(np.uint8), axis=-1)


def unpack_code_table(packed: torch.Tensor, s: int) -> torch.Tensor:
    """(P, S) bipolar float32 code table from ``pack_code_bits``, on the
    packed tensor's device."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8)[..., None] >> shifts) & 1
    bits = bits.reshape(packed.shape[0], -1)[:, :s]
    return 1.0 - 2.0 * bits.to(torch.float32)


def tf32_matmul_on() -> bool:
    """Whether the process lets CUDA float32 matmuls round their inputs
    to TF32, set through either of torch's two switches
    (``torch.backends.cuda.matmul.allow_tf32``, or ``fp32_precision`` /
    ``torch.set_float32_matmul_precision``).  torch refuses to read the
    older switch once the newer one was set, so that case reads the newer."""
    try:
        return bool(torch.backends.cuda.matmul.allow_tf32)
    except RuntimeError:
        return torch.backends.cuda.matmul.fp32_precision == "tf32"


def check_float32_matmuls(device) -> None:
    """Raise RuntimeError where float32 matmuls on ``device`` would round
    their inputs to TF32 (a CUDA device, with TF32 turned on in this
    process): the "highest" DFT precision's guard."""
    if torch.device(device).type == "cuda" and tf32_matmul_on():
        raise RuntimeError(
            'the "highest" DFT precision needs float32 matmuls, but '
            "TF32 is on for CUDA matmuls in this process")


def dft_matmul(a: torch.Tensor, b: torch.Tensor,
               precision: str = "highest") -> torch.Tensor:
    """``a @ b`` over a's last axis for float32 ``a`` (..., K) and ``b``
    (K, N), float32 out.  On a CUDA device ``precision`` picks the
    product: "highest" a float32 product, "default" bfloat16 inputs with
    float32 accumulation and a float32 result (``torch.mm(...,
    out_dtype=torch.float32)``: a plain bf16 ``torch.matmul`` rounds its
    result to bf16).  On the CPU both are float32 products.

    "highest" needs torch's default of TF32 off for CUDA matmuls; it
    raises where the process turned TF32 on, and never changes that
    process-wide setting itself."""
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown DFT precision {precision!r}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.device.type != "cuda":
        out = a2 @ b
    elif precision == "highest":
        check_float32_matmuls(a.device)
        out = a2 @ b
    else:
        out = torch.mm(a2.to(torch.bfloat16), b.to(torch.bfloat16),
                       out_dtype=torch.float32)
    return out.reshape(*lead, b.shape[-1])


def code_spectrum_conj_matmul(table: torch.Tensor, wc: torch.Tensor,
                              ws: torch.Tensor) -> torch.Tensor:
    """conj(DFT(code)) built with the matmul DFT, in float32 products.

    For a real code row c: DFT(c) = c @ (wc - i*ws), so
    conj(DFT(c)) = c @ wc + i*(c @ ws)."""
    return torch.complex(dft_matmul(table, wc, "highest"),
                         dft_matmul(table, ws, "highest"))


def dft_tables(n: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of the length-n DFT twiddle matrix, as host arrays.

    ``W[j, k] = exp(-2i*pi*j*k/n) = cos - i*sin``.  W is symmetric and
    ``conj(W) = n * W^-1``, so one table pair serves both directions:
    forward ``X = x @ (cos - i*sin)``, inverse ``x = X @ (cos + i*sin)/n``.
    The phase index ``j*k`` is reduced mod n in exact integer arithmetic
    before the float conversion.
    """
    j = np.arange(n, dtype=np.int64)
    m = np.outer(j, j) % n
    ang = (2.0 * np.pi / n) * m.astype(np.float64)
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def dft_tables_device(n: int, device="cuda") -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``dft_tables`` computed on ``device`` (cos/sin of an integer outer
    product mod n, exact in int32 up to n = 46341, then a float32 angle:
    the JAX package's device tables); raises without a card unless
    ``device="cpu"``."""
    device = card_or_cpu(device, "dft_tables_device")
    j = torch.arange(n, dtype=torch.int32, device=device)
    m = (j[:, None] * j[None, :]) % n
    ang = m.to(torch.float32) * float(np.float32(2.0 * np.pi / n))
    return torch.cos(ang), torch.sin(ang)


def matmul_circular_correlate(
    x: torch.Tensor,            # (..., S) complex epochs
    cfc: torch.Tensor,          # (P, S) conj code FFTs
    wc: torch.Tensor,           # (S, S) DFT cos table (dft_tables)
    ws: torch.Tensor,           # (S, S) DFT sin table
    precision: str = "highest",
) -> torch.Tensor:
    """``fft_circular_correlate`` with matmul DFTs instead of FFTs.

    Same contract and lag convention as ``fft_circular_correlate``; the
    transforms run as (B, S) @ (S, S) real products (``dft_matmul`` at
    ``precision``).
    """
    def dot(a, b):
        return dft_matmul(a, b, precision)

    xr = x.real.to(torch.float32)
    xi = x.imag.to(torch.float32)
    # forward: X = x @ (wc - i*ws)
    x_re = dot(xr, wc) + dot(xi, ws)
    x_im = dot(xi, wc) - dot(xr, ws)
    # spectrum product with conj code FFTs, new PRN axis
    cr = cfc.real.to(torch.float32)
    ci = cfc.imag.to(torch.float32)
    z_re = x_re[..., None, :] * cr - x_im[..., None, :] * ci
    z_im = x_re[..., None, :] * ci + x_im[..., None, :] * cr
    # inverse: corr = Z @ (wc + i*ws) / S
    inv = float(np.float32(1.0 / x.shape[-1]))
    c_re = (dot(z_re, wc) - dot(z_im, ws)) * inv
    c_im = (dot(z_re, ws) + dot(z_im, wc)) * inv
    return torch.complex(c_re, c_im)


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
