"""The captured tracking programs against their eager runs on the card.

The three per-block programs that the JAX package compiles with
``jax.jit`` and the port captures as CUDA graphs (utils.graphs):

* ``k1_carried``: ``runtime.receiver._track_and_digest_carried`` (K1, the
  unpacking and the digest; one graph), at 4, 32 and 256 channels
  (G = 2 at 256);
* ``k2_per_epoch``: ``runtime.receiver._track_and_digest`` with
  ``use_pallas=True, in_kernel_scan=False`` (``track_block``'s epoch step
  with K2, replayed once an epoch, then the digest graph), at 32;
* ``reference_scan``: the same with ``in_kernel_scan=False`` (the
  fractional-phase reference scan, no kernel), at 32.

Each one runs from one entering state over four consecutive 1000-epoch
blocks of a 4-satellite 48 dBHz capture (3 codes a bit, the satellites
tiled to the width; the state 0.1 chip and 15 Hz off the truth): three
blocks at the width, then one with the last channel dropped, which is a
new key and a fresh capture.  Each block is handed over as a host tensor,
as the Receiver hands a numpy block.  The program runs twice, eagerly
under ``graphs.disable_capture()`` and replayed, and :func:`check` holds:

* every leaf of the returned states (ScanState and TrackState, or
  TrackState) and of the digest, on the device and on the host, equal
  bit for bit, block for block;
* what block n returned unchanged after block n + 1 (no storage a
  later replay overwrites);
* the counted launches: K1 once a block at its width and nothing else;
  K2 once a tracked epoch and nothing else; the reference scan none;
  no plain-version call.

Printed, not held: each block's host wall (the call and the digest's
readback) and CUDA-event span, the captures of each run and the
warm-up launches.

    python -m stm32f4_sdr_gps_torch.probes.graph_replay

prints one JSON line; exit 0 when every check holds, 3 when one fails,
1 without a card.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import numpy as np
import torch

from ..config import BASEBAND_PLAN, TrackConfig
from ..ops import epl
from ..ops import track_scan as ts
from ..runtime.digest import digest_to_host
from ..runtime.receiver import _track_and_digest, _track_and_digest_carried
from ..signal.simulator import SimSat, simulate_capture
from ..track.state import TrackState, init_state
from ..utils import graphs

PRNS = (1, 7, 13, 22)
CIB = 3
BLOCK = 1000
BLOCKS = 3            # at the width; then one with a channel dropped
FILTER_LEN = 100
S = BASEBAND_PLAN.samples_per_epoch

CFGS = {
    "k1_carried": TrackConfig(codes_in_bit=CIB),
    "k2_per_epoch": TrackConfig(codes_in_bit=CIB, use_pallas=True,
                                in_kernel_scan=False),
    "reference_scan": TrackConfig(codes_in_bit=CIB, in_kernel_scan=False),
}
WIDTHS = {"k1_carried": (4, 32, 256), "k2_per_epoch": (32,),
          "reference_scan": (32,)}
# captures of a replayed run: its programs at the width and at one
# channel fewer (the step and the digest for the two scans)
CAPTURES = {"k1_carried": 2, "k2_per_epoch": 4, "reference_scan": 4}


class GraphCheckError(RuntimeError):
    """A replayed program parted from its eager run, or miscounted."""


def scenario(seed: int = 5):
    """(blocks: BLOCKS + 1 (BLOCK, S) complex64 numpy arrays, entering
    code phases, entering Dopplers) of the 4-satellite capture."""
    n = (BLOCKS + 1) * BLOCK
    rng = np.random.default_rng(seed)
    sats = [SimSat(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                   code_phase_chips=float(rng.uniform(0, 1023)),
                   cn0_dbhz=48.0, codes_in_bit=CIB,
                   nav_bits=rng.integers(0, 2, n // CIB + 10))
            for p in PRNS]
    x, _ = simulate_capture(sats, num_epochs=n, seed=seed)
    x = np.ascontiguousarray(x, dtype=np.complex64).reshape(n, S)
    return ([x[k * BLOCK:(k + 1) * BLOCK] for k in range(BLOCKS + 1)],
            np.array([s.code_phase_chips + 0.1 for s in sats]),
            np.array([s.doppler_hz + 15.0 for s in sats]))


def entering(name: str, c: int, cp0, dop0, device):
    """(carry, code rows) at ``c`` channels, the satellites tiled:
    channel j is satellite j mod 4.  The carry is K1's ScanState for
    ``k1_carried``, else the TrackState."""
    idx = [j % len(PRNS) for j in range(c)]
    cfg = CFGS[name]
    st = init_state(c, cp0[idx], dop0[idx], window=cfg.pll_check_window,
                    device=device)
    table = epl.code_rows(tuple(PRNS[j] for j in idx),
                          name != "reference_scan", str(device))
    carry = ts.state_from_track_state(st) if name == "k1_carried" else st
    return carry, table


def _drop_last(carry):
    if isinstance(carry, TrackState):
        return TrackState(*(v[:-1] for v in carry))
    return type(carry)(*(t[:, :-1].contiguous() for t in carry))


def _call(name, carry, blk, code):
    """(new carry, every returned tensor, the digest)."""
    cfg = CFGS[name]
    if name == "k1_carried":
        ps, st, d = _track_and_digest_carried(carry, blk, code, BASEBAND_PLAN,
                                              cfg, FILTER_LEN, True)
        return ps, graphs.flatten((ps, st, d))[0], d
    st, d = _track_and_digest(carry, blk, code, BASEBAND_PLAN, cfg,
                              FILTER_LEN, True)
    return st, graphs.flatten((st, d))[0], d


def counts() -> dict:
    return {"track_scan": ts.track_scan_cuda.launches,
            "track_scan_by_mode": dict(ts.track_scan_cuda.by_mode),
            "track_scan_plain": ts.track_scan_reference.calls,
            "epl": epl.epl_correlate_cuda.launches,
            "epl_plain": epl.epl_correlate_halfchip.calls}


def _since(before: dict) -> dict:
    now = counts()
    out = {k: now[k] - before[k] for k in now if k != "track_scan_by_mode"}
    out["track_scan_by_mode"] = {
        k: v - before["track_scan_by_mode"].get(k, 0)
        for k, v in now["track_scan_by_mode"].items()
        if v != before["track_scan_by_mode"].get(k, 0)}
    return out


def _same_bits(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def run(name: str, c: int, data, eager: bool, device="cuda",
        trace=None, device_blocks: bool = False) -> dict:
    """The program over the blocks, eagerly or replayed; every block's
    returned tensors on the host, its digest, its host wall and event
    span (ms), the launches and captures of the run (a replayed run
    starts from an empty cache).  ``trace``: a context manager factory
    entered around blocks 2 and 3 (the same key, both warm); such a run
    keeps nothing of its blocks, so that the traced window holds the
    program's calls and readbacks alone.  ``device_blocks``: each block
    is put on the card before it is timed (as the wire path hands it
    over), so the times hold no host-to-device copy."""
    blocks, cp0, dop0 = data
    carry, code = entering(name, c, cp0, dop0, device)
    if not eager:
        graphs.clear()              # every key of the run captured anew
    before, caps = counts(), graphs.stats["captures"]
    warm0 = dict(graphs.stats["warmup_launches"])
    recs, held = [], None
    traced = contextlib.ExitStack()
    for n, blk_np in enumerate(blocks):
        if n == BLOCKS:
            carry, code = _drop_last(carry), code[:-1].contiguous()
        if n == 1 and trace is not None:
            traced.enter_context(trace())
        blk = torch.from_numpy(blk_np)
        if device_blocks:
            blk = blk.to(device)
        torch.cuda.synchronize(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        with (graphs.disable_capture() if eager
              else contextlib.nullcontext()):
            carry, leaves, d = _call(name, carry, blk, code)
        host = digest_to_host(d)
        e1.record()
        e1.synchronize()
        wall = time.perf_counter() - t0
        if n == 2:
            traced.close()
        if trace is not None:        # a traced run is timed, not held
            continue
        snap = [t.cpu() for t in leaves]
        if held is not None:
            for i, (t, s) in enumerate(zip(*held)):
                if not _same_bits(t.cpu().numpy(), s.numpy()):
                    raise GraphCheckError(
                        f"{name} {c} ch ({'eager' if eager else 'replayed'})"
                        f": leaf {i} of block {n - 1} changed by block {n}")
        held = (leaves, snap)
        recs.append({"wall_ms": wall * 1e3,
                     "span_ms": e0.elapsed_time(e1),
                     "leaves": snap, "digest": host})
    warm = {k: v - warm0.get(k, 0)
            for k, v in graphs.stats["warmup_launches"].items()
            if v != warm0.get(k, 0)}
    return {"blocks": recs, "counts": _since(before),
            "captures": graphs.stats["captures"] - caps,
            "warmup_launches": warm}


def check(name: str, c: int, eager: dict, replayed: dict) -> None:
    """Raise GraphCheckError unless the replayed run equals the eager
    one bit for bit and both counted what the program launches."""
    for n, (a, b) in enumerate(zip(eager["blocks"], replayed["blocks"])):
        for i, (x, y) in enumerate(zip(a["leaves"], b["leaves"])):
            if not _same_bits(x.numpy(), y.numpy()):
                raise GraphCheckError(f"{name} {c} ch block {n}: leaf {i} "
                                      "replayed differs from eager")
        for f, x, y in zip(a["digest"]._fields, a["digest"], b["digest"]):
            if not _same_bits(x, y):
                raise GraphCheckError(f"{name} {c} ch block {n}: digest "
                                      f"{f} replayed differs from eager")
    mode = ts.kernel_mode(CFGS[name])
    want = {"track_scan": 0, "track_scan_by_mode": {},
            "track_scan_plain": 0, "epl": 0, "epl_plain": 0}
    if name == "k1_carried":
        want.update(track_scan=BLOCKS + 1, track_scan_by_mode={
            (mode, c): BLOCKS, (mode, c - 1): 1})
    elif name == "k2_per_epoch":
        want["epl"] = (BLOCKS + 1) * BLOCK
    for label, run_ in (("eager", eager), ("replayed", replayed)):
        if run_["counts"] != want:
            raise GraphCheckError(f"{name} {c} ch {label}: counts "
                                  f"{run_['counts']}, want {want}")
    if eager["captures"] or replayed["captures"] != CAPTURES[name]:
        raise GraphCheckError(
            f"{name} {c} ch: {eager['captures']} captures eagerly, "
            f"{replayed['captures']} replayed (want 0 and "
            f"{CAPTURES[name]}: one a key)")


def summary(eager: dict, replayed: dict) -> dict:
    """Each run's per-block host wall and event span (ms), its captures
    and warm-up launches."""
    def times(run_):
        return {"wall_ms": [b["wall_ms"] for b in run_["blocks"]],
                "span_ms": [b["span_ms"] for b in run_["blocks"]]}
    return {"eager": times(eager), "replayed": times(replayed),
            "captures": replayed["captures"],
            "warmup_launches": replayed["warmup_launches"],
            "launches": {k: v for k, v in replayed["counts"].items()
                         if v and k != "track_scan_by_mode"}}


def run_all(device="cuda", data=None) -> dict:
    """Every program at each of its widths, eager then replayed, checked;
    the summaries by program and width."""
    data = data or scenario()
    out = {}
    for name, widths in WIDTHS.items():
        for c in widths:
            eager = run(name, c, data, True, device)
            replayed = run(name, c, data, False, device)
            check(name, c, eager, replayed)
            out[f"{name}_{c}ch"] = summary(eager, replayed)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_replay: needs a CUDA device", file=sys.stderr)
        return 1
    try:
        res = run_all()
    except GraphCheckError as e:
        print(f"graph_replay: FAIL: {e}", file=sys.stderr)
        return 3
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "programs": res, "graphs": graphs.stats},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
