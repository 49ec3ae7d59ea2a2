"""The captured acquisition against its eager run on the card.

``acquire.engine.acquire`` runs the cube and its peak analysis as one
captured program (``_acquire_fused`` under ``utils.graphs.captured``) and
reads its (5, P) result back in one copy.  Cases:

* ``fft_4``: the FFT cube at 4 PRNs, the default AcqConfig (the wire
  cell's search);
* ``fft_32``: the same at 32 PRNs (the SoftGNSS cell's search);
* ``coherent2_hyp2_32``: 2-epoch coherent sums and 2 bit-edge hypotheses
  at 32 PRNs;
* ``hinted_4``: 4 PRNs, two of them hinted (a hint mask: its own key);
* ``dft_default_32``: the matmul DFT at its "default" (bf16) precision,
  32 PRNs.

Input: a 12-epoch capture of 8 satellites at 45 dBHz (seeded Doppler and
code phase), two windows of 10 epochs (from epoch 0 and from epoch 2).
Each case runs eagerly (``graphs.disable_capture()``) and captured, on
window A with PRN set A, then on window B with PRN set B, another set of
the same size (one program for both).  Held (:func:`check`): every field
of every AcqResult equal bit for bit, eager against captured; the first
captured call counts one ``acquire.capture`` and one ``acquire.replay``,
the second one replay and no capture; each captured call one
``readback``.  :func:`tf32_refused` holds that the "highest" DFT
precision still raises on a replayed key once TF32 is switched on.

Timed: the host time of a whole ``acquire`` call (median of 50, its
readback included), eager and replayed, and the device time a program
call (queued behind a device sleep, ``common.queued_ms``).

    python -m stm32f4_sdr_gps_torch.probes.acquire_replay

prints a line per case and one JSON line; exit 0 when every check holds,
3 when one fails, 1 without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..acquire import engine
from ..config import AcqConfig, BASEBAND_PLAN as PLAN
from ..signal.simulator import SimSat, simulate_capture
from ..utils import graphs, profiling
from .common import queued_ms, warm_up

S = PLAN.samples_per_epoch
SATS = (2, 5, 9, 13, 17, 22, 26, 31)
EPOCHS = 12
#: each window's first epoch
WINDOWS = (0, 2)
#: case: (PRN set A, PRN set B, AcqConfig, hinted)
CASES = {
    "fft_4": (SATS[:4], SATS[4:], AcqConfig(), False),
    "fft_32": (tuple(range(1, 33)), tuple(range(32, 0, -1)), AcqConfig(),
               False),
    "coherent2_hyp2_32": (tuple(range(1, 33)), tuple(range(32, 0, -1)),
                          AcqConfig(coherent_epochs=2, edge_hypotheses=2),
                          False),
    "hinted_4": (SATS[:4], SATS[4:], AcqConfig(), True),
    "dft_default_32": (tuple(range(1, 33)), tuple(range(32, 0, -1)),
                       AcqConfig(use_matmul_dft=True,
                                 dft_precision="default"), False),
}
HOST_CALLS = 50


class AcquireReplayCheckError(AssertionError):
    """The captured acquisition departs from its eager run, or its counts
    from one capture, one replay a call and one readback a call."""


def scenario() -> tuple:
    """(the capture, {PRN: planted Doppler}): 8 satellites at 45 dBHz."""
    rng = np.random.default_rng(30)
    dop = rng.uniform(-5000.0, 5000.0, len(SATS))
    sats = [SimSat(prn=p, doppler_hz=float(d),
                   code_phase_chips=float(rng.uniform(0, 1023)),
                   cn0_dbhz=45.0) for p, d in zip(SATS, dop)]
    x, _ = simulate_capture(sats, EPOCHS, PLAN, seed=30)
    return x, dict(zip(SATS, dop))


def _hints(prns, truth, hinted):
    """The first PRN hinted at its planted Doppler, the third 3 kHz off
    (its search confined away from the signal), or None."""
    if not hinted:
        return None
    return {prns[0]: float(truth.get(prns[0], 0.0)),
            prns[2]: float(truth.get(prns[2], 0.0)) + 3000.0}


def _window(x, w, device):
    return torch.as_tensor(x[WINDOWS[w] * S:], device=device)


def _fields(results):
    return [dataclasses.astuple(r) for r in results]


def _counted(run):
    """(run(), the acquisition's counters it moved)."""
    names = ("acquire.capture", "acquire.replay", "readback")
    before = [profiling.counters.get(k, 0) for k in names]
    out = run()
    return out, {k: profiling.counters.get(k, 0) - b
                 for k, b in zip(names, before)}


def check(case: str, data, device="cuda") -> dict:
    """One case, eager against captured (see the module docstring);
    raises AcquireReplayCheckError where they part.  Returns its counts."""
    x, truth = data
    sets = CASES[case][:2]
    cfg, hinted = CASES[case][2:]

    def call(w):
        prns = list(sets[w])
        return engine.acquire(_window(x, w, device), prns, PLAN, cfg,
                              doppler_hints_hz=_hints(prns, truth, hinted),
                              device=device)

    graphs.clear()
    with graphs.disable_capture():
        eager = [call(0), call(1)]
    got, counts = [], []
    for w in (0, 1):
        res, moved = _counted(lambda: call(w))
        got.append(res)
        counts.append(moved)
    want = [{"acquire.capture": 1, "acquire.replay": 1, "readback": 1},
            {"acquire.capture": 0, "acquire.replay": 1, "readback": 1}]
    if counts != want:
        raise AcquireReplayCheckError(f"{case}: counts {counts}, want "
                                      f"{want}")
    for w in (0, 1):
        if _fields(got[w]) != _fields(eager[w]):
            diff = [(a, b) for a, b in zip(_fields(got[w]),
                                           _fields(eager[w])) if a != b]
            raise AcquireReplayCheckError(
                f"{case}: window {w}: captured != eager: {diff[:3]}")
    if not any(r.detected for r in got[0]):
        raise AcquireReplayCheckError(f"{case}: nothing detected")
    return {"P": len(sets[0]), "counts": counts,
            "detected": [sum(r.detected for r in g) for g in got]}


def timed(case: str, data, device="cuda") -> dict:
    """Host ms a whole ``acquire`` call (median of ``HOST_CALLS``) and
    device ms a program call (queued), eager and replayed."""
    x, truth = data
    prns = list(CASES[case][0])
    cfg, hinted = CASES[case][2:]
    window = _window(x, 0, device)
    hints = _hints(prns, truth, hinted)

    def call():
        return engine.acquire(window, prns, PLAN, cfg,
                              doppler_hints_hz=hints, device=device)

    args, static = engine.fused_args(window, prns, PLAN, cfg, None, hints,
                                     torch.device(device))

    def program():
        return engine._acquire_fused(*args, **static)

    out = {}
    for label, eager in (("eager", True), ("replayed", False)):
        with (graphs.disable_capture() if eager
              else contextlib.nullcontext()):
            warm_up(call)
            host = []
            for _ in range(HOST_CALLS):
                t0 = time.perf_counter()
                call()
                host.append((time.perf_counter() - t0) * 1e3)
            # a call queues up to ~300 launches eagerly: 3 calls keep
            # under the launch queue
            out[label] = {"host_ms": statistics.median(host),
                          "device_ms": queued_ms(program, 3, 3)}
    return out


def tf32_refused(data, device="cuda") -> dict:
    """The "highest" DFT precision captured at 4 PRNs with TF32 off, then
    called again with TF32 on: the call must raise, with no capture."""
    x, _ = data
    cfg = AcqConfig(use_matmul_dft=True, dft_precision="highest")
    prns = list(SATS[:4])

    def call():
        return engine.acquire(_window(x, 0, device), prns, PLAN, cfg,
                              device=device)

    call()
    captures, keys = graphs.stats["captures"], len(graphs._cache)
    m = torch.backends.cuda.matmul
    prev = m.fp32_precision
    try:
        m.fp32_precision = "tf32"
        try:
            call()
        except RuntimeError as e:
            if "TF32" not in str(e):
                raise
        else:
            raise AcquireReplayCheckError(
                "the highest DFT precision ran on a replayed key with TF32 "
                "on")
    finally:
        m.fp32_precision = prev
    if (graphs.stats["captures"], len(graphs._cache)) != (captures, keys):
        raise AcquireReplayCheckError("the refused call captured a program")
    call()
    return {"refused": True}


def run(device="cuda") -> dict:
    """Every case: its check and times, printed and returned; then the
    TF32 refusal."""
    data = scenario()
    out = {}
    for case in CASES:
        rec = {**check(case, data, device), **timed(case, data, device)}
        out[case] = rec
        print(f"[acq_replay] {case}: captured = eager bit for bit on two "
              f"windows and two PRN sets of {rec['P']} (one capture, a "
              f"replay and a readback a call; detected {rec['detected']}); "
              f"host ms a call eager {rec['eager']['host_ms']:.3f}, "
              f"replayed {rec['replayed']['host_ms']:.3f}; device ms a "
              f"call eager {rec['eager']['device_ms']:.4f}, replayed "
              f"{rec['replayed']['device_ms']:.4f}", flush=True)
    out["tf32"] = tf32_refused(data, device)
    print("[acq_replay] the highest DFT precision raises on a replayed key "
          "with TF32 on", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("acquire_replay: needs a CUDA device", file=sys.stderr)
        return 1
    try:
        rec = run()
    except AcquireReplayCheckError as e:
        print(f"acquire_replay: FAIL: {e}", file=sys.stderr)
        return 3
    print(json.dumps({"device": torch.cuda.get_device_name(0), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
