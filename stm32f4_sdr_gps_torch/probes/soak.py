"""Sustained streaming soak: native SPSC ring -> Receiver at a set pace.

    python -m stm32f4_sdr_gps_torch.probes.soak [--capture-s 300]
        [--rate-x 1.0] [--cn0 48] [--seed 9] [--block-epochs 500]
        [--ring-ms 2000] [--device cuda|cpu] [--state-dir DIR]

The system-level analogue of the firmware's double-buffer staleness
guard (signal_capture.c:107-123 drops a block if the ISR copy is >900 us
stale), and the port's counterpart of the JAX package's tools/soak.py.
A paced producer thread unpacks the 1-bit wire capture
(``native/capture_gen``) and pushes 100-epoch chunks of float32 sign
samples into the native SPSC ring at ``--rate-x`` times real time; the
consumer pops whole blocks, conditions them to baseband on the host
(``signal.capture.reference_to_baseband``) and runs the Receiver on
``--device``.  A full ring means the consumer fell behind the pace: the
producer drops that chunk, counts its epochs and keeps pacing.

Cold start needs a contiguous prefix, so the head (acquisition epochs +
one block) is fed directly before pacing starts: ``acquire_all``,
``start_tracking`` and one ``process_block``, which also builds and warms
the block program (a first call mid-stream would overrun the ring
through no fault of the steady-state path).  The consumer then drains
full blocks only, and whatever is left once the producer is done.

Prints one JSON line (sustained x real time, pushed / dropped / consumed
epochs, ring high-water, consumer stall, fixes and the last fix's error
against the generator's truth, channels tracking, and what was decoded:
each PRN's subframe ledger, subframes and bits, each fix's position).
Success = zero dropped epochs and all but at most one second of the
capture consumed; exit 0 on success, 1 otherwise.  Runs on the card
unless given ``--device cpu``, and raises without one; the native
library and the generator must build (no fallback).  Without
``--state-dir`` the capture lives in a temporary directory removed at
the end; with it, a capture an earlier run left there is used again (as
the JAX tool does).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

WORDS_PER_EPOCH = 1023
SIGNS_PER_EPOCH = 16368
CHUNK_EPOCHS = 100                      # 100 ms producer granularity


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def capture(capture_s: int, cn0: float, seed: int,
            state_dir: str | None = None):
    """(SPI words, truth) of the soak's wire capture: read from
    ``state_dir`` where an earlier run left it there, else generated
    (into ``state_dir``, or a temporary directory)."""
    from ..runtime import native

    name = f"soak_{capture_s}s_{cn0:g}_{seed}"
    if state_dir and os.path.exists(os.path.join(state_dir,
                                                 name + ".truth.json")):
        with open(os.path.join(state_dir, name + ".truth.json")) as f:
            return (np.fromfile(os.path.join(state_dir, name + ".bin"),
                                dtype=np.uint16), json.load(f))
    if state_dir:
        os.makedirs(state_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        return native.capture_gen(
            state_dir or tmp, name, cib=20, duration_ms=capture_s * 1000,
            cn0=cn0, seed=seed, repeats=max(1, capture_s // 30))


def ledger(rx) -> dict:
    """What the Receiver decoded, per PRN: the subframe-time ledger (the
    last boundary and the residues behind it), subframes, bits and the
    tracked Doppler; and every fix's position."""
    return {"channels": {str(ch.prn): {
                "subframe_time_ms": ch.subframe_time_ms,
                "boundary_residues": list(ch.boundary_residues),
                "subframes": ch.subframe_count, "bits": ch.bit_count,
                "doppler_hz": ch.doppler_hz} for ch in rx.channels},
            "fixes_ecef_m": [s.rr.tolist() for s in rx.solutions]}


def run_soak(capture_s: int = 300, rate_x: float = 1.0, cn0: float = 48.0,
             seed: int = 9, block_epochs: int = 500, ring_ms: int = 2000,
             device="cuda", state_dir: str | None = None) -> dict:
    """One soak run (module docstring); returns its record, with ``ok``
    the success condition."""
    from ..config import ReceiverConfig
    from ..runtime import native
    from ..runtime.receiver import Receiver
    from ..signal.capture import reference_to_baseband
    from ..utils.device import card_or_cpu

    device = card_or_cpu(device, "run_soak")
    if native.get_lib() is None:
        raise RuntimeError("run_soak: the native library (native/"
                           "libsdr_native.so) is unavailable")
    words, truth = capture(capture_s, cn0, seed, state_dir)
    total_epochs = len(words) // WORDS_PER_EPOCH
    _log(f"capture: {total_epochs} epochs, pacing at {rate_x}x real time "
         f"on {device}")

    ring = native.NativeRing(ring_ms * SIGNS_PER_EPOCH)
    stats = {"pushed_epochs": 0, "dropped_epochs": 0, "ring_hw": 0,
             "producer_done": False}
    stop = threading.Event()
    chunk_period_s = CHUNK_EPOCHS * 1e-3 / rate_x

    def producer(start_epoch: int):
        try:
            t_next = time.perf_counter()
            for e0 in range(start_epoch, total_epochs, CHUNK_EPOCHS):
                if stop.is_set():
                    break
                n = min(CHUNK_EPOCHS, total_epochs - e0)
                signs = native.unpack_bits16(
                    words[e0 * WORDS_PER_EPOCH:(e0 + n) * WORDS_PER_EPOCH])
                # firmware staleness-guard semantics: a full ring means
                # the consumer is too far behind -- drop THIS chunk, keep
                # pacing
                if ring.push(signs):
                    stats["pushed_epochs"] += n
                else:
                    stats["dropped_epochs"] += n
                stats["ring_hw"] = max(stats["ring_hw"], ring.available)
                t_next += chunk_period_s
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
        except Exception as e:              # re-raised by the consumer
            stats["error"] = e
        finally:
            stats["producer_done"] = True

    prns = tuple(s["prn"] for s in truth["sats"])
    rx = Receiver(ReceiverConfig(prns=prns, track_block_epochs=block_epochs),
                  device=device)
    spe = rx.config.plan.samples_per_epoch
    acq_e = rx.config.acq.noncoherent_epochs
    head_e = acq_e + block_epochs
    head = reference_to_baseband(native.unpack_bits16(
        words[:head_e * WORDS_PER_EPOCH]))
    rx.acquire_all(head)
    rx.start_tracking(head[acq_e * spe:], start_epoch=acq_e)
    rx.epoch_cursor = acq_e
    rx.process_block(head[acq_e * spe:])      # builds / warms the program
    consumed = head_e

    th = threading.Thread(target=producer, args=(consumed,), daemon=True)
    stall_s = 0.0
    t0 = time.perf_counter()
    th.start()
    try:
        while consumed < total_epochs:
            need = min(block_epochs, total_epochs - consumed)
            t_wait = time.perf_counter()
            while (ring.available < need * SIGNS_PER_EPOCH
                   and not stats["producer_done"]):
                time.sleep(0.005)
            stall_s += time.perf_counter() - t_wait
            n = min(need, ring.available // SIGNS_PER_EPOCH)
            if n == 0:
                if stats["producer_done"]:
                    break
                continue
            signs = ring.pop(n * SIGNS_PER_EPOCH)
            if signs is None:
                continue
            rx.process_block(reference_to_baseband(signs))
            consumed += n
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    finally:
        stop.set()
        th.join()
    if "error" in stats:
        raise RuntimeError("run_soak: the producer thread failed") \
            from stats["error"]

    errs = []
    if rx.solutions:
        rr = np.asarray(truth["rr_ecef"])
        errs = [float(np.linalg.norm(s.rr - rr)) for s in rx.solutions]
    out = {
        "device": str(device),
        "capture_s": total_epochs / 1000.0,
        "rate_x": rate_x,
        "wall_s": wall,
        "sustained_rt_x": consumed * 1e-3 / wall,
        "total_epochs": total_epochs,
        "head_epochs": head_e,
        "pushed_epochs": stats["pushed_epochs"],
        "consumed_epochs": consumed,
        "dropped_epochs": stats["dropped_epochs"],
        "ring_high_water_ms": stats["ring_hw"] / SIGNS_PER_EPOCH,
        "ring_capacity_ms": ring_ms,
        "consumer_stall_s": stall_s,
        "fixes": len(rx.solutions),
        "fix_error_m_last": errs[-1] if errs else None,
        "fix_error_m_min": min(errs) if errs else None,
        "channels_tracking": sum(
            1 for ch in rx.channels if ch.state_name == "TRACKING"),
        "blocks": rx.profiler.stages["track"].calls,
        "track_ms_per_block": rx.profiler.stages["track"].mean_s * 1e3,
        **ledger(rx),
    }
    out["ok"] = (out["dropped_epochs"] == 0
                 and consumed >= total_epochs - 1000)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture-s", type=int, default=300)
    ap.add_argument("--rate-x", type=float, default=1.0)
    ap.add_argument("--cn0", type=float, default=48.0)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--block-epochs", type=int, default=500)
    ap.add_argument("--ring-ms", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--state-dir", default=None)
    args = ap.parse_args(argv)
    out = run_soak(args.capture_s, args.rate_x, args.cn0, args.seed,
                   args.block_epochs, args.ring_ms, args.device,
                   args.state_dir)
    print(json.dumps(out), flush=True)
    _log("SOAK " + ("PASS" if out["ok"] else "FAIL"))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
