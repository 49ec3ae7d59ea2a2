"""The handoff search kernels (csrc/pretrack.cu) on the card against the
plain loops they replace, with their times.

Cases (C channels, E epochs, K = 31 half-chip offsets):

* ``prompts_4x32``: ``squared_prompts_cuda`` at C = 4, E = 32, the cold
  start's Doppler search;
* ``power_4x20``: ``pretrack_power_cuda`` at C = 4, E = 20, the cold
  start's code search;
* ``prompts_32x256``: C = 32, E = 256, the Doppler search under
  ``coherent_pll``;
* ``prompts_32x512``: C = 32, E = 512, the aided sync's re-anchor;
* ``power_32x100``: C = 32, E = 100, the code search under
  ``coherent_pll``.

Input: a simulated capture of C satellites at 45 dBHz (PRNs 1 to C,
seeded Doppler and code phases), handed over with each code phase within
0.3 chip and each Doppler within 200 Hz of the planted one.  Held
(:func:`check`): the Doppler bins of the two sides' prompts (the same
torch tail on both) equal, the prompts and the power within ``RTOL`` of
the channel's largest (tests/test_torch_pretrack_kernels.py says why),
the code search's peaks equal, and one kernel launch a prompts call, two
a power call, with no plain-loop call.  Timed with CUDA events: the
kernels' device time a call (launches queued behind a device sleep), its
bound (the larger of the bytes over 3.35 TB/s and the float32 operations
over 67 TFLOP/s, the H100 SXM data sheet's at 700 W) and the plain loop's
time a call.

    python -m stm32f4_sdr_gps_torch.probes.pretrack_kernels

prints a line per case and one JSON line; exit 0 when every check holds,
3 when one fails, 1 without a card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..acquire import engine
from ..config import BASEBAND_PLAN as PLAN
from ..signal.ca_code import ca_table_bipolar
from ..signal.simulator import SimSat, simulate_capture
from ..track import pretrack
from .common import event_ms, queued_ms, warm_up

S = PLAN.samples_per_epoch
K = 31
RTOL = 1e-5
CASES = {"prompts_4x32": ("prompts", 4, 32),
         "power_4x20": ("power", 4, 20),
         "prompts_32x256": ("prompts", 32, 256),
         "prompts_32x512": ("prompts", 32, 512),
         "power_32x100": ("power", 32, 100)}

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12
# float32 operations a sample and channel: the carrier wipe-off (the
# sample time's division, the angle's multiply, add, floor and
# subtraction, its doubling, sincospif counted as 2, the rotation's four
# multiplies and two adds: 13), then per replica the chip's fused
# multiply-add (2) and two multiply-adds into the sums (4)
WIPE_OPS = 13
REPLICA_OPS = 6


class PretrackCheckError(AssertionError):
    """A kernel's result or launch count departs from the plain loop's."""


def inputs(c: int, e: int, device) -> tuple:
    """(epochs, code table, code phases, Dopplers) on ``device`` for C
    satellites over E epochs, seeded by (C, E)."""
    rng = np.random.default_rng(1000 * c + e)
    dop = rng.uniform(-4500, 4500, c)
    cp = rng.uniform(0, 1023, c)
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=q, cn0_dbhz=45.0)
            for p, d, q in zip(range(1, c + 1), dop, cp)]
    x, _ = simulate_capture(sats, e, PLAN, seed=c + e)
    return (torch.as_tensor(x.reshape(e, S), device=device),
            torch.as_tensor(ca_table_bipolar(list(range(1, c + 1))),
                            device=device),
            torch.as_tensor((cp + rng.uniform(-0.3, 0.3, c)) % 1023.0,
                            dtype=torch.float32, device=device),
            torch.as_tensor(dop + rng.uniform(-200, 200, c),
                            dtype=torch.float32, device=device))


def bound_ms(kind: str, c: int, e: int) -> tuple:
    """(bound_ms, bound_by) of one call: the epochs, the code rows and the
    (C,) inputs read once, the output written once."""
    nbytes = e * S * 8 + c * 1023 * 4 + 3 * c * 4
    if kind == "prompts":
        nbytes += e * c * 8
        ops = e * c * S * (WIPE_OPS + REPLICA_OPS)
    else:
        nbytes += c * K * 4
        ops = e * c * S * (WIPE_OPS + K * REPLICA_OPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bins(prompts):
    e = prompts.shape[0]
    return torch.argmax(torch.abs(torch.fft.fft(prompts * prompts, n=8 * e,
                                                dim=0)), dim=0)


def _counts():
    return (engine.squared_prompts_cuda.launches,
            pretrack.pretrack_power_cuda.launches,
            engine.squared_prompts_plain.calls, pretrack._pretrack_power.calls)


def check(kind: str, args: tuple) -> dict:
    """One kernel call against the plain loop on the same inputs; raises
    PretrackCheckError where they part.  Returns the largest difference
    over the channel's largest value and the kernel's launches."""
    epochs, table, cp, dop = args
    if kind == "power":
        dop = engine.refine_doppler_device(*args, PLAN)
    before = _counts()
    if kind == "prompts":
        got = engine.squared_prompts_cuda(epochs, table, cp, dop, PLAN)
    else:
        got = pretrack.pretrack_power_cuda(epochs, table, cp, dop, PLAN, K)
    after = _counts()
    launches = [a - b for a, b in zip(after, before)]
    if launches != ([1, 0, 0, 0] if kind == "prompts" else [0, 2, 0, 0]):
        raise PretrackCheckError(f"{kind}: launches and plain calls "
                                 f"{launches}")
    if kind == "prompts":
        want = engine.squared_prompts_plain(epochs, table, cp, dop, PLAN)
        scale = want.abs().amax(dim=0)
        same = torch.equal(_bins(got), _bins(want))
    else:
        want = pretrack._pretrack_power(epochs, table, cp, dop, PLAN, K)
        scale = want.amax(dim=1, keepdim=True)
        same = torch.equal(got.argmax(1), want.argmax(1))
    rel = float(((got - want).abs() / scale).max())
    if not same:
        raise PretrackCheckError(f"{kind}: the peaks differ from the plain "
                                 "loop's")
    if not rel <= RTOL:
        raise PretrackCheckError(f"{kind}: max |kernel - plain| {rel:.3e} of "
                                 f"the channel's largest, beyond {RTOL}")
    return {"max_rel_err": rel, "launches": sum(launches)}


def timed(kind: str, args: tuple) -> dict:
    """The kernels' device time a call (queued), the plain loop's time a
    call (CUDA events around one call), both in ms."""
    epochs, table, cp, dop = args
    if kind == "prompts":
        def kernel():
            return engine.squared_prompts_cuda(epochs, table, cp, dop, PLAN)

        def plain():
            return engine.squared_prompts_plain(epochs, table, cp, dop, PLAN)
    else:
        def kernel():
            return pretrack.pretrack_power_cuda(epochs, table, cp, dop, PLAN,
                                                K)

        def plain():
            return pretrack._pretrack_power(epochs, table, cp, dop, PLAN, K)

    warm_up(kernel)
    # a prompts call queues four launches (the code rate's three and the
    # kernel), a power call two: 100 calls keep under the launch queue
    ms = queued_ms(kernel, 3, 100)
    return {"ms": ms, "floor_ms": queued_ms(lambda: torch.cuda._sleep(1), 3,
                                            100),
            "plain_ms": event_ms(plain, 3)}


def run(device="cuda") -> dict:
    """Every case: its check, times and bound, printed and returned."""
    out = {}
    for name, (kind, c, e) in CASES.items():
        args = inputs(c, e, device)
        rec = {"kind": kind, "C": c, "E": e, **check(kind, args),
               **timed(kind, args)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(kind, c, e)
        out[name] = rec
        print(f"[pretrack] {name}: kernel = plain (peaks equal, max "
              f"|kernel - plain| {rec['max_rel_err']:.2e} of the channel's "
              f"largest), {rec['launches']} launch(es); device time a call "
              f"{rec['ms'] * 1e3:.2f} us (an empty kernel "
              f"{rec['floor_ms'] * 1e3:.2f} us), bound "
              f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}), plain "
              f"loop {rec['plain_ms']:.3f} ms a call", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pretrack_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    try:
        rec = run()
    except PretrackCheckError as e:
        print(f"pretrack_kernels: FAIL: {e}", file=sys.stderr)
        return 3
    print(json.dumps({"device": torch.cuda.get_device_name(0), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
