"""The real-IF ingest kernel (csrc/if_resample.cu, R1) on the card against
its plain version and the float64 reference, with its times.

Input: the SoftGNSS cell's own windows, 266 epochs of int8 real samples
at 38.192 MHz (10,159,072 bytes), seeded noise quantised at 8 LSB
(``sigma_8_*``, as the benchmark's front end makes it) and at 40 LSB
(``sigma_40``, a fifth of the samples saturated at +-127).  Held
(:func:`check`): the kernel, the plain version (torch ops on the card)
and the host build of the kernel's arithmetic (csrc/if_resample_host.cpp)
each against the float64 reference (signal/if_reference.py, on the
CPU), max |error| within ``TOL`` = 1e-5 of the reference's RMS (float32
accumulation of the taps sits near 1e-7 of it; half-precision taps miss
by about 1e-3, and the plain version with them is the control that must
fail); the kernel equal to its host build bit for bit; one launch a
window.  Timed with CUDA events: the kernel's device time a window
(launches queued behind a device sleep), its bound (the bytes, read once
and written once, over 3.35 TB/s, the H100 SXM data sheet's at 700 W),
the plain version's time, and the whole ingest from host memory
(``if_to_baseband_device``: the upload and the launch) two ways: the
window standalone (``ingest_ms``: a pageable upload, which CUDA stages
through its own buffers) and the same bytes as the middle window of a
buffer three windows long (``ingest_registered_ms``: the buffer
page-locked once, ``utils.device.HostPages``, then a DMA from it), each
with its effective GB/s (the window's bytes over the whole ingest's
time; the window is warm in the host's caches after the first call).
The two give the same baseband bit for bit (checked).

    python -m stm32f4_sdr_gps_torch.probes.if_resample

prints a line per window and one JSON line; exit 0 when every check
holds, 3 when one fails, 1 without a card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..signal import capture as cap
from ..signal.if_reference import if_to_baseband_reference
from .common import event_ms, queued_ms, warm_up

FS = 38192000.0
IF = 9548000.0
EPOCHS = 266
TOL = 1e-5
PEAK_BYTES_PER_S = 3.35e12
#: seed, noise in LSB
WINDOWS = {"sigma_8_a": (2026, 8.0), "sigma_8_b": (2027, 8.0),
           "sigma_40": (2028, 40.0)}


class IfResampleCheckError(AssertionError):
    """The kernel departs from its plain version, host build or
    reference."""


def window(seed: int, sigma: float) -> np.ndarray:
    """One window of seeded int8 samples: noise at ``sigma`` LSB, rounded
    and saturated at +-127."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(EPOCHS * 38192) * sigma)
    return np.clip(x, -127, 127).astype(np.int8)


def bound_ms(n_in: int) -> float:
    """The window's bytes: each int8 sample read once, each complex64
    output written once, over the HBM rate."""
    plan = cap.if_resample_plan(FS)
    return (n_in + n_in // plan.M * plan.L * 8) / PEAK_BYTES_PER_S * 1e3


def _rel(got, ref, rms):
    return float((got.cpu().to(torch.complex128) - ref).abs().max() / rms)


def check(x: np.ndarray, device) -> dict:
    """The window through the kernel, the plain version on the card, the
    host build and the half-precision control, each against the float64
    reference; raises IfResampleCheckError where one is off."""
    plan = cap.if_resample_plan(FS)
    ref = if_to_baseband_reference(x, FS, IF)
    rms = float(ref.abs().pow(2).mean().sqrt())
    before = cap.if_resample_cuda.launches
    got = cap.if_to_baseband_device(x, FS, IF, device=device)
    launches = cap.if_resample_cuda.launches - before
    if launches != 1:
        raise IfResampleCheckError(f"{launches} launches for one window")
    xd = torch.as_tensor(x, device=device)
    plain = cap.if_to_baseband_plain(xd, plan)
    host = cap.if_resample_host(torch.as_tensor(x), plan)
    half = cap.IfResamplePlan(**{
        **plan.__dict__,
        "taps": plan.taps.astype(np.float16).astype(np.float64)})
    errs = {"kernel": _rel(got, ref, rms), "plain": _rel(plain, ref, rms),
            "host": _rel(host, ref, rms),
            "half_taps": _rel(cap.if_to_baseband_plain(xd, half), ref, rms)}
    for k in ("kernel", "plain", "host"):
        if not errs[k] <= TOL:
            raise IfResampleCheckError(f"{k}: max |error| {errs[k]:.3e} of "
                                       f"the reference's RMS, beyond {TOL}")
    if not errs["half_taps"] > TOL:
        raise IfResampleCheckError(f"the half-precision control reads "
                                   f"{errs['half_taps']:.3e}, within {TOL}")
    if not torch.equal(got.cpu(), host):
        diff = int((got.cpu() != host).sum())
        raise IfResampleCheckError(f"kernel != host build at {diff} outputs")
    return {"max_rel_err": errs["kernel"], "errors": errs, "rms": rms,
            "launches": launches}


def in_buffer(x: np.ndarray) -> np.ndarray:
    """``x``'s bytes as the middle window of a buffer three windows long
    (the rest zeros): a view, as a recording held whole hands it over."""
    buf = np.zeros(3 * x.size, np.int8)
    buf[x.size: 2 * x.size] = x
    return buf[x.size: 2 * x.size]


def ingest(x: np.ndarray, device) -> torch.Tensor:
    return cap.if_to_baseband_device(x, FS, IF, device=device)


def timed(x: np.ndarray, device) -> dict:
    """ms: the kernel a window (queued), the plain version, the whole
    ingest from host memory (standalone and registered, with their GB/s),
    an empty kernel queued the same way."""
    plan = cap.if_resample_plan(FS)
    xd = torch.as_tensor(x, device=device)
    taps = torch.as_tensor(plan.shifted, device=device)
    xr = in_buffer(x)
    if not torch.equal(ingest(xr, device), ingest(x, device)):
        raise IfResampleCheckError("the registered window's baseband "
                                   "differs from the pageable one's")

    def kernel():
        return cap.if_resample_cuda(xd, plan, taps)

    warm_up(kernel)
    rec = {"ms": queued_ms(kernel, 3, 100),
           "floor_ms": queued_ms(lambda: torch.cuda._sleep(1), 3, 100),
           "plain_ms": event_ms(lambda: cap.if_to_baseband_plain(xd, plan),
                                3),
           "ingest_ms": event_ms(lambda: ingest(x, device), 5),
           "ingest_registered_ms": event_ms(lambda: ingest(xr, device), 5)}
    for k in ("ingest", "ingest_registered"):
        rec[k + "_gbps"] = x.nbytes / rec[k + "_ms"] * 1e-6
    return rec


def run(device="cuda") -> dict:
    """Every window: its checks and times, printed and returned."""
    out = {}
    for name, (seed, sigma) in WINDOWS.items():
        x = window(seed, sigma)
        rec = {"sigma_lsb": sigma, **check(x, device), **timed(x, device),
               "bound_ms": bound_ms(x.size), "bound_by": "bytes"}
        rec["roofline_pct"] = 100.0 * rec["bound_ms"] / rec["ms"]
        out[name] = rec
        e = rec["errors"]
        print(f"[if_resample] {name}: kernel = host build bit for bit; max "
              f"|error| of the reference's RMS: kernel {e['kernel']:.2e}, "
              f"plain {e['plain']:.2e}, host {e['host']:.2e}, "
              f"half-precision taps {e['half_taps']:.2e} (tolerance {TOL}); "
              f"device time a window {rec['ms'] * 1e3:.2f} us (an empty "
              f"kernel {rec['floor_ms'] * 1e3:.2f} us), bound "
              f"{rec['bound_ms'] * 1e3:.3f} us (bytes), "
              f"{rec['roofline_pct']:.1f} % of it; plain "
              f"{rec['plain_ms']:.3f} ms, the whole ingest from host memory "
              f"{rec['ingest_ms']:.3f} ms standalone ("
              f"{rec['ingest_gbps']:.2f} GB/s, pageable), "
              f"{rec['ingest_registered_ms']:.3f} ms as a window of a "
              f"larger buffer ({rec['ingest_registered_gbps']:.2f} GB/s, "
              f"page-locked)", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("if_resample: needs a CUDA device", file=sys.stderr)
        return 1
    try:
        rec = run()
    except IfResampleCheckError as e:
        print(f"if_resample: FAIL: {e}", file=sys.stderr)
        return 3
    from ..ops import kernel_lib

    log = kernel_lib.build_info["if_resample_cuda"]["log"]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "ptxas": kernel_lib.ptxas_report(
                          log, "if_resample_kernel"), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
