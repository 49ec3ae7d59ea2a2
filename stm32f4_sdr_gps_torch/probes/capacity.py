"""The system ceiling on the card: the per-block program at C channels
beside the host decode of the same channels.

    python -m stm32f4_sdr_gps_torch.probes.capacity [--widths 32 ... 1024]
        [--blocks 20] [--host-blocks 30]

The per-block program is what the Receiver's kernel path runs for each
block (``runtime.receiver._track_and_digest_carried``, then
``runtime.digest.digest_to_host``), written out eagerly so that its parts
can be timed (the Receiver replays it as one captured graph,
utils.graphs; probes/graph_replay.py times that), here on
probes/scan_time.py's
32-channel, 1000-epoch K1 scenario tiled to C channels
(``scan_time.tiled``).  Each block is timed with CUDA events in three
parts: K1 (``track_scan``); the rest on the device (``outputs_from_raw``,
``state_to_track_state``, ``digest_block``); and the readback
(``digest_to_host``, one packed buffer copied at once).  The median over
``--blocks`` blocks gives k, the program's real-time multiple (1000 ms
of signal over its time).  probes/host_cost.py's ``measure`` at the same
C and block length gives h, the host decode's multiple; the two combine
as in the JAX package's docs/SCALING.md (system ceiling): serial
1/(1/k + 1/h), one after the other on one thread, and pipelined
min(k, h), the decode of one block beside the program of the next; and
the aggregate channels in real time, C times each.

The 32-channel digest must equal the Receiver's own block's, and every
width's the 32-channel digest tiled C/32 times (:func:`check_tiled`).
Prints one JSON line per width, the table, then the card's
``nvidia-smi`` name and power limit and the host CPU's model.  Exits 1
without a card, 3 if a digest differs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import BASEBAND_PLAN, ReceiverConfig, TrackConfig
from ..ops.track_scan import (outputs_from_raw, state_from_track_state,
                              state_to_track_state, track_scan)
from ..runtime.digest import digest_block, digest_to_host
from . import host_cost
from .scan_time import CIB, k1_scenario, tiled

WIDTHS = (32, 64, 128, 256, 512, 1024)
BLOCK_EPOCHS = 1000          # k1_scenario's block
RX = ReceiverConfig()        # the Receiver's code filter settings
PARTS = ("k1_ms", "rest_ms", "readback_ms")


class CapacityError(AssertionError):
    """A digest is not the Receiver's, or not the 32-channel one tiled."""


def scenario(device):
    """The K1 scenario as the per-block program takes it: the ScanState,
    the (1000, 2046) epochs, the code rows and the TrackConfig."""
    st, x, u2 = k1_scenario(torch.device(device))
    return state_from_track_state(st), x, u2, TrackConfig(codes_in_bit=CIB)


def program(ps, x, u2, cfg, mark=None):
    """One block of the Receiver's kernel path:
    ``_track_and_digest_carried`` and ``digest_to_host``, written out so
    that ``mark()`` (when given) runs after each of its three parts.
    Returns (the carried ScanState, the digest with numpy leaves)."""
    mark = mark or (lambda: None)
    ps2, raw = track_scan(ps, x, u2, BASEBAND_PLAN, cfg)
    mark()
    ts = state_to_track_state(ps2)
    d = digest_block(outputs_from_raw(raw), ts, cfg, RX.code_filter_len,
                     RX.enable_code_filter)
    mark()
    h = digest_to_host(d)
    mark()
    return ps2, h


def time_width(ps0, x, u2, cfg, c, blocks):
    """The per-block program at ``c`` channels on the card: 2 warm-up
    blocks, then ``blocks`` blocks from the same state, each timed with
    CUDA events in its three parts.  Returns (record of medians in ms,
    the first timed block's digest)."""
    ps, table = tiled(ps0, u2, c)
    for _ in range(2):
        program(ps, x, table, cfg)
    rows, walls, digest = [], [], None
    for _ in range(blocks):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        marks = iter(ev[1:])
        t0 = time.perf_counter()
        ev[0].record()
        _, d = program(ps, x, table, cfg, mark=lambda: next(marks).record())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        digest = digest if digest is not None else d
    rec = {p: statistics.median(r[i] for r in rows)
           for i, p in enumerate(PARTS)}
    rec["program_ms"] = statistics.median(sum(r) for r in rows)
    rec["host_wall_ms"] = statistics.median(walls)
    return rec, digest


def check_receivers(ps, x, u2, cfg, digest) -> None:
    """``digest`` (from :func:`program`) against one block of the
    Receiver's own ``_track_and_digest_carried`` and ``digest_to_host``
    on the same inputs, bit for bit; raises CapacityError."""
    from ..runtime.receiver import _track_and_digest_carried

    _, _, d = _track_and_digest_carried(ps, x, u2, BASEBAND_PLAN, cfg,
                                        RX.code_filter_len,
                                        RX.enable_code_filter)
    for name, a, b in zip(digest._fields, digest, digest_to_host(d)):
        if not np.array_equal(a, b):
            raise CapacityError(f"{name}: the timed program differs from "
                                "the Receiver's _track_and_digest_carried")


def check_tiled(d32, dc, c) -> dict:
    """Every leaf of ``dc`` (the digest at ``c`` channels) against the
    32-channel digest ``d32`` tiled c/32 times: integer and boolean leaves
    bit for bit, float leaves bit for bit or within 1e-6 relative.
    Returns {"exact": [leaves equal bit for bit], "rel": {float leaf: max
    relative difference}} for the leaves that are not; raises
    CapacityError otherwise."""
    exact, rel = [], {}
    for name, a, b in zip(d32._fields, d32, dc):
        want = np.tile(a, (1,) * (a.ndim - 1) + (c // a.shape[-1],))
        if b.shape != want.shape or b.dtype != want.dtype:
            raise CapacityError(f"{c} ch: {name} {b.shape} {b.dtype}, want "
                                f"{want.shape} {want.dtype}")
        if np.array_equal(b, want):
            exact.append(name)
            continue
        if not np.issubdtype(b.dtype, np.floating):
            raise CapacityError(f"{c} ch: {name} differs from the 32-channel "
                                "digest tiled")
        r = float(np.max(np.abs(b.astype(np.float64) - want)
                         / np.maximum(np.abs(want.astype(np.float64)),
                                      np.finfo(np.float32).tiny)))
        if not r <= 1e-6:
            raise CapacityError(f"{c} ch: {name} relative difference {r:.3e}"
                                " > 1e-6")
        rel[name] = r
    return {"exact": exact, "rel": rel}


def combine(k: float, h: float, c: int) -> dict:
    """The system's real-time multiple from the program's ``k`` and the
    host decode's ``h``: serial (one after the other) and pipelined (the
    decode of one block beside the program of the next), and the
    aggregate channels in real time at ``c`` channels."""
    serial = 1.0 / (1.0 / k + 1.0 / h)
    pipelined = min(k, h)
    return {"k": k, "h": h, "serial_x": serial, "pipelined_x": pipelined,
            "channels_rt_serial": c * serial,
            "channels_rt_pipelined": c * pipelined}


def measure(widths=WIDTHS, blocks=20, host_blocks=30) -> list:
    """One record per width: G, the program's three parts and total (ms,
    medians), the host decode (probes/host_cost.measure at the same C and
    block length) and :func:`combine`'s columns, on the card (raises
    without one).  The first width (32)
    is held to the Receiver's own block (:func:`check_receivers`), and
    each width's digest to the first width's tiled (:func:`check_tiled`).
    Launches K1 ``blocks + 2`` times at each width, once more at 32."""
    from ..ops.track_scan import channels_per_block
    from ..utils.device import card_or_cpu

    dev = card_or_cpu("cuda", "capacity.measure")     # CUDA events
    if widths[0] != 32:
        raise ValueError("the first width must be the scenario's 32")
    ps0, x, u2, cfg = scenario(dev)
    out, d32 = [], None
    for c in widths:
        rec, d = time_width(ps0, x, u2, cfg, c, blocks)
        if d32 is None:
            d32 = d
            check_receivers(ps0, x, u2, cfg, d32)
        host = host_cost.measure(c, BLOCK_EPOCHS, host_blocks, device=dev)
        out.append({
            "channels": c, "G": channels_per_block(c), **rec,
            "tiled": check_tiled(d32, d, c),
            "host_ms_per_block": host["host_ms_per_block"],
            "subframes_decoded": host["subframes_decoded"],
            **combine(BLOCK_EPOCHS / rec["program_ms"],
                      host["host_only_rt_x"], c),
        })
    return out


def table(records) -> str:
    """The records as the columns of docs/SCALING.md's system-ceiling
    table, with the program's split."""
    head = (f"{'C':>5} {'G':>2} {'K1 ms':>8} {'rest ms':>8} {'read ms':>8} "
            f"{'prog ms':>8} {'k':>8} {'host ms':>8} {'h':>7} {'serial':>7} "
            f"{'pipe':>7} {'C*serial':>9} {'C*pipe':>9}")
    lines = [head]
    for r in records:
        lines.append(
            f"{r['channels']:>5} {r['G']:>2} {r['k1_ms']:>8.3f} "
            f"{r['rest_ms']:>8.3f} {r['readback_ms']:>8.3f} "
            f"{r['program_ms']:>8.3f} {r['k']:>8.1f} "
            f"{r['host_ms_per_block']:>8.2f} {r['h']:>7.1f} "
            f"{r['serial_x']:>7.1f} {r['pipelined_x']:>7.1f} "
            f"{r['channels_rt_serial']:>9.0f} "
            f"{r['channels_rt_pipelined']:>9.0f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS))
    ap.add_argument("--blocks", type=int, default=20)
    ap.add_argument("--host-blocks", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("capacity: needs a CUDA device", file=sys.stderr)
        return 1
    try:
        recs = measure(args.widths, args.blocks, args.host_blocks)
    except CapacityError as e:
        print(f"capacity: {e}", file=sys.stderr)
        return 3
    for r in recs:
        print(json.dumps(r))
    print(table(recs))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    print(f"host CPU: {host_cost.cpu_model()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
