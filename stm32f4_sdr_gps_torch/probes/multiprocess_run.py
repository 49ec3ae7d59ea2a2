"""The mesh runtime across processes: one rank of a run over
``torch.distributed`` (the counterpart of the JAX package's
tests/multihost_worker.py).

    python -m stm32f4_sdr_gps_torch.probes.multiprocess_run RANK WORLD PORT \\
        --captures DIR [--device {cpu,cuda}] [--slow]

Each of WORLD ranks joins a gloo process group over loopback TCP
(``tcp://localhost:PORT``) and holds 8 / WORLD positions of one 2 x 4
(time, chan) mesh, every position on ``--device`` (both ranks on one
card with ``cuda``: the run checks the sharding and the collectives
across processes, and measures no scaling).  The stages:

1. the acquisition cube with the time axis across the ranks (each rank
   holds its own epoch rows), against the single-device cube,
   rtol 2e-4, atol 1e-2; PRN 3 detected within 260 Hz; and the halo
   exchange across the ranks, exactly the one-process halo;
2. channel-sharded tracking across the rank boundary (8 channels, 64
   epochs) against the unsharded scan, Doppler rtol 1e-6 / atol 1e-3,
   prompt I rtol 1e-5 / atol 1e-2 (the tracking-scan kernel once a
   position on the card, the reference scan on the CPU);
3. per-process decode of 8 PRNs (3 codes a bit, blocks of 500 epochs):
   each rank frames and decodes only its channel block, the observables
   gather to every rank, and the relative pseudoranges lie within 100 m
   of the planted delays;
4. with ``--slow``, the 29 s fix capture (4 PRNs and 4 ghosts): the
   distributed fix within 150 m of the planted position.

The captures are made once by the caller (:func:`write_captures`) and
loaded by every rank; :func:`launch` starts two ranks, and raises as
soon as one exits non-zero (with its log) or when the time limit passes
(with the tail of each log), stopping every rank.  A rank uses 2 CPU
threads (the CPU tests run beside other test processes).  The launch
counts are set to 0 before each stage; each stage records its
tracking-scan kernel launches and its calls of the kernel's plain
version, without stage 2's unsharded comparison launch, and on the card
a rank requires one kernel launch a position a block and no plain call.
Each rank prints one JSON record as its last line (each stage's seconds,
launches and result, the fix).  Exit 0 when every stage held.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack

import numpy as np
import torch
import torch.distributed as dist

WORLD_POSITIONS = (2, 4)          # the (time, chan) mesh of every run
PRNS8 = (2, 7, 15, 24, 5, 9, 18, 29)
DELAYS = (1.773, 6.402, 3.255, 9.911, 2.5, 7.7, 4.4, 8.8)
DOPS = (-2500.0, 800.0, 3100.0, -400.0, 1500.0, -3300.0, 600.0, -900.0)
CIB = 3
BLOCK = 500
E3 = 120 * CIB + 4 * 300 * CIB + 300


def write_captures(path: str, fix=None) -> None:
    """Simulate stages 1-3's captures into ``path`` (stage 1: PRN 3 over 8
    epochs; stage 2: the same satellite over 64; stage 3: 8 PRNs with
    compressed 3-epoch bits); with ``fix`` (a signal.scenarios
    FixScenario) also stage 4's capture and its truth."""
    from ..signal.nav_message import build_bitstream
    from ..signal.scenarios import CANONICAL_EPH
    from ..signal.simulator import SimSat, simulate_capture

    sat = SimSat(prn=3, doppler_hz=1800.0, code_phase_chips=444.0,
                 cn0_dbhz=46.0)
    np.save(os.path.join(path, "x1.npy"),
            simulate_capture([sat], num_epochs=8, seed=42)[0])
    np.save(os.path.join(path, "x2.npy"),
            simulate_capture([sat], num_epochs=64, seed=43)[0])
    prefix = np.tile([0, 1], 60).astype(np.int8)
    sats = []
    for prn, delay, dop in zip(PRNS8, DELAYS, DOPS):
        body = build_bitstream(dict(CANONICAL_EPH), start_tow_6s=58800,
                               num_subframes=4, subframe_ids=(5, 1, 2, 3))
        sats.append(SimSat(prn=prn, doppler_hz=dop, cn0_dbhz=49.0,
                           nav_bits=np.concatenate([prefix, body]),
                           codes_in_bit=CIB, delay_ms=delay))
    x3, truth3 = simulate_capture(sats, num_epochs=E3, seed=9)
    np.save(os.path.join(path, "x3.npy"), x3)
    np.save(os.path.join(path, "phases3.npy"), np.array(
        [truth3.code_phase_at_epoch(i, 0) for i in range(len(PRNS8))]))
    if fix is not None:
        np.save(os.path.join(path, "x4.npy"), fix.samples)
        n = len(fix.prns)
        with open(os.path.join(path, "fix4.json"), "w") as f:
            json.dump({
                "prns": [int(p) for p in fix.prns],
                "phases": [float(fix.truth.code_phase_at_epoch(i, 0))
                           for i in range(n)],
                "dopplers": [float(fix.truth.sats[i].doppler_hz)
                             for i in range(n)],
                "rr_true": [float(v) for v in fix.rr_true]}, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(device: str = "cuda", fix=None, timeout_s: float = 240.0) -> list:
    """Write the captures (with ``fix``, a FixScenario, also stage 4's,
    and run it: ``--slow``), start two ranks as subprocesses of this
    interpreter, and wait for them (:func:`_wait_ranks`).  Returns each
    rank's last-line record.  The ranks run on the card unless the
    caller asks for the CPU; raises without a card before any work."""
    from ..utils.device import card_or_cpu

    device = card_or_cpu(device, "multiprocess_run.launch").type
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # gloo picks its interface from the host name unless told: loopback,
    # since the ranks share one machine and it may have no network
    env = dict(os.environ, PYTHONPATH=root)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    world = 2
    with tempfile.TemporaryDirectory() as tmp, ExitStack() as stack:
        write_captures(tmp, fix)
        port = str(_free_port())
        procs, logs = [], []
        for rank in range(world):
            log = stack.enter_context(
                open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            logs.append(log)
            cmd = [sys.executable, "-m", __spec__.name, str(rank),
                   str(world), port, "--captures", tmp, "--device", device]
            procs.append(subprocess.Popen(
                cmd + (["--slow"] if fix is not None else []), cwd=root,
                env=env, stdout=log, stderr=subprocess.STDOUT))
        texts = _wait_ranks(procs, logs, timeout_s)
    return [json.loads(t.strip().splitlines()[-1]) for t in texts]


def _wait_ranks(procs, logs, timeout_s: float) -> list:
    """Poll the rank processes until every one has exited 0, and return
    each one's log text (``logs``: their open output files).  Raises
    RuntimeError, after stopping every rank still running, as soon as a
    rank exits non-zero (with that rank's log: its peer would block in a
    collective), or after ``timeout_s`` (with the tail of each log)."""
    failed, timed_out = None, False
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None:
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
    if failed is None and not timed_out:
        failed = next((r for r, p in enumerate(procs) if p.returncode != 0),
                      None)
    if failed is not None:
        raise RuntimeError(f"multiprocess_run rank {failed} exited "
                           f"{procs[failed].returncode}:\n"
                           f"{texts[failed][-4000:]}")
    if timed_out:
        tails = "\n".join(f"--- rank {r}:\n{t[-2000:]}"
                          for r, t in enumerate(texts))
        raise RuntimeError(f"multiprocess_run: ranks still running after "
                           f"{timeout_s} s, stopped:\n{tails}")
    return texts


def _reset_counts() -> None:
    from ..ops import track_scan as ts

    ts.track_scan_cuda.launches = 0
    ts.track_scan_cuda.by_mode.clear()
    ts.track_scan_reference.calls = 0


def _path_counts() -> dict:
    """The tracking-scan kernel's launches (in all and by mode and
    channels) and its plain version's calls since the last reset."""
    from ..ops import track_scan as ts

    return {"k1": ts.track_scan_cuda.launches,
            "k1_by_mode": {f"{m} x {c} ch": n for (m, c), n
                           in sorted(ts.track_scan_cuda.by_mode.items())},
            "plain": ts.track_scan_reference.calls}


def _allgather_columns(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes, channels last) joined on the last
    axis in rank order, on ``x``'s device."""
    mine = x.cpu()
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    return torch.cat(parts, dim=-1).to(x.device)


def _require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"multiprocess_run: {msg}")


def _tables(prns, cfg, dev):
    """The tracker's code table for ``cfg``'s tracking path on ``dev``."""
    from ..config import resolve_in_kernel_scan
    from ..ops.epl import code_rows

    return code_rows(tuple(prns), resolve_in_kernel_scan(cfg, dev), str(dev))


def stage_acquisition(mesh, dev, x1, rank, group) -> dict:
    from ..acquire.engine import acquisition_power, analyze_power
    from ..config import BASEBAND_PLAN as PLAN, AcqConfig
    from ..ops.correlate import code_fft_conj
    from ..ops.wipeoff import doppler_rotations
    from ..parallel.mesh import (halo_extend_blocks, make_mesh,
                                 sharded_acquisition_power)

    s = PLAN.samples_per_epoch
    e = len(x1) // s
    epochs = torch.as_tensor(x1.reshape(e, s), device=dev)
    prns = list(range(1, 9))
    cfc = code_fft_conj(prns, PLAN, device=dev)
    bins = np.arange(-3000.0, 3001.0, 500.0, dtype=np.float32)
    rot = doppler_rotations(torch.as_tensor(bins, device=dev), s,
                            PLAN.sample_rate_hz)
    nt = mesh.shape["time"]
    rows = e // nt
    local_t = sorted({p // mesh.shape["chan"] for p in mesh.positions})
    local = torch.cat([epochs[t * rows:(t + 1) * rows] for t in local_t])
    power = sharded_acquisition_power(local, cfc, rot, mesh,
                                      gather_output=True)
    ref = acquisition_power(epochs, cfc, rot)
    np.testing.assert_allclose(power.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-4, atol=1e-2)
    res = {r.prn: r for r in analyze_power(power, prns, bins, PLAN,
                                           AcqConfig())}
    _require(res[3].detected and abs(res[3].doppler_hz - 1800.0) < 260.0,
             f"stage 1: PRN 3 {res[3]}")
    # the halo across the rank boundary against the one-process halo
    blocks = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2 * nt, 64)).astype(np.float32), device=dev)
    brows = blocks.shape[0] // nt
    local_b = torch.cat([blocks[t * brows:(t + 1) * brows] for t in local_t])
    ext = halo_extend_blocks(local_b, 16, mesh)
    one = make_mesh(*WORLD_POSITIONS, devices=[dev] * mesh.size)
    want = halo_extend_blocks(blocks, 16, one)
    want = torch.cat([want[t * brows:(t + 1) * brows] for t in local_t])
    _require(torch.equal(ext, want), "stage 1: halo across the ranks")
    return {"peak_rel_err": float(torch.max(torch.abs(power - ref))
                                  / torch.max(ref)), "blocks": 0}


def stage_tracking(mesh, dev, x2, group) -> dict:
    from ..config import BASEBAND_PLAN as PLAN, TrackConfig
    from ..parallel.streaming import StreamingTracker
    from ..track.scan import track_block
    from ..track.state import init_state

    prns = list(range(1, 9))
    cfg = TrackConfig()
    rng = np.random.default_rng(5)
    phases = rng.uniform(0, 1023, len(prns))
    dops = rng.uniform(-3e3, 3e3, len(prns))
    phases[2], dops[2] = 444.0, 1800.0          # PRN 3 gets truth
    state0 = init_state(len(prns), phases, dops,
                        window=cfg.pll_check_window, device=dev)
    table = _tables(prns, cfg, dev)
    outs = StreamingTracker(state0, table, mesh, PLAN, cfg).process(x2)
    launches = _path_counts()     # the path's, before the comparison run
    got_dop = _allgather_columns(outs.doppler_hz, group)
    got_ip = _allgather_columns(outs.ip, group)
    s = PLAN.samples_per_epoch
    epochs = torch.as_tensor(x2.reshape(len(x2) // s, s), device=dev)
    _, ref = track_block(state0, epochs, table, PLAN, cfg)
    np.testing.assert_allclose(got_dop.cpu().numpy(),
                               ref.doppler_hz.cpu().numpy(),
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got_ip.cpu().numpy(), ref.ip.cpu().numpy(),
                               rtol=1e-5, atol=1e-2)
    return {"bit_equal": bool(torch.equal(got_dop, ref.doppler_hz)
                              and torch.equal(got_ip, ref.ip)),
            "blocks": 1, "launches": launches}


def _decode_run(mesh, dev, x, prns, phases, dops, cfg, rcfg, n_epochs,
                group):
    """Track ``n_epochs`` of ``x`` in blocks on the mesh, decode this
    rank's channel block; returns (decoder, epochs tracked)."""
    from ..config import BASEBAND_PLAN as PLAN
    from ..parallel.streaming import StreamingTracker
    from ..runtime.multiprocess import ShardDecoder, local_digest_block
    from ..track.state import init_state

    spe = PLAN.samples_per_epoch
    st = init_state(len(prns), phases, dops, window=cfg.pll_check_window,
                    device=dev)
    tracker = StreamingTracker(st, _tables(prns, cfg, dev), mesh, PLAN, cfg)
    decoder, cursor = None, 0
    for i in range(0, n_epochs - BLOCK + 1, BLOCK):
        d = tracker.process_digest(
            np.asarray(x[i * spe:(i + BLOCK) * spe]), rcfg)
        d_local, col0 = local_digest_block(d, mesh)
        if decoder is None:
            n_local = d_local.bit_count.shape[0]
            decoder = ShardDecoder(prns[col0: col0 + n_local], rcfg)
            _require(n_local == len(prns) // dist.get_world_size(group),
                     f"{n_local} local channels from column {col0}")
        decoder.consume_digest(d_local, BLOCK)
        cursor += BLOCK
    return decoder, cursor


def stage_decode(mesh, dev, x3, phases3, group) -> dict:
    from ..config import CLIGHT, FREQ_L1_HZ, ReceiverConfig, TrackConfig
    from ..runtime.multiprocess import gather_and_solve

    cfg = TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9)
    rcfg = ReceiverConfig(prns=PRNS8, track=cfg, enable_position=False,
                          enable_code_filter=False)
    decoder, cursor = _decode_run(mesh, dev, x3, PRNS8, phases3,
                                  np.array(DOPS), cfg, rcfg, E3, group)
    # every rank decoded ONLY its channel block
    counts = [(ch.prn, ch.subframe_count) for ch in decoder.channels]
    _require(all(ch.subframe_count >= 3 and ch.eph.has_full_set
                 for ch in decoder.channels), f"stage 3: subframes {counts}")
    obs, _ = gather_and_solve(decoder, cursor - 1, solve=False, group=group)
    _require(obs is not None and len(obs) == len(PRNS8),
             f"stage 3: {0 if obs is None else len(obs)} observations")
    by_prn = {o.sat: o.P for o in obs}
    ref_i = int(np.argmin(DELAYS))
    # code-Doppler drift of each delay over the capture, in ms
    drift_ms = np.array(DOPS) / FREQ_L1_HZ * cursor
    want = (np.array(DELAYS) - drift_ms) * CLIGHT / 1000.0
    got = np.array([by_prn[p] for p in PRNS8])
    rel_err = (got - got[ref_i]) - (want - want[ref_i])
    # the bound covers the 8-PRN cross-correlation bias on the DLL
    _require(np.max(np.abs(rel_err)) < 100.0, f"stage 3: {rel_err}")
    return {"max_rel_pseudorange_err_m": float(np.max(np.abs(rel_err))),
            "local_prns": [ch.prn for ch in decoder.channels],
            "blocks": cursor // BLOCK}


def stage_fix(mesh, dev, captures, group) -> dict:
    from ..config import BASEBAND_PLAN as PLAN, ReceiverConfig, TrackConfig
    from ..runtime.multiprocess import gather_and_solve

    with open(os.path.join(captures, "fix4.json")) as f:
        meta = json.load(f)
    x4 = np.load(os.path.join(captures, "x4.npy"), mmap_mode="r")
    n = len(meta["prns"])
    # the real channels and as many ghost copies pad the 8-position
    # mesh; the gather dedupes by PRN (first occurrence wins)
    prns = meta["prns"] * (mesh.size // n)
    phases = np.array(meta["phases"] * (mesh.size // n))
    dops = np.array(meta["dopplers"] * (mesh.size // n))
    cfg = TrackConfig(pll_bad_state_threshold=10**9)
    rcfg = ReceiverConfig(prns=tuple(meta["prns"]), track=cfg,
                          enable_position=False)
    decoder, cursor = _decode_run(mesh, dev, x4, prns, phases, dops, cfg,
                                  rcfg, len(x4) // PLAN.samples_per_epoch,
                                  group)
    _, sol = gather_and_solve(decoder, cursor - 1, group=group)
    _require(sol is not None and sol.ok, "stage 4: distributed fix failed")
    err = float(np.linalg.norm(np.asarray(sol.rr) - meta["rr_true"]))
    _require(err < 150.0, f"stage 4: fix error {err:.1f} m")
    return {"fix_error_m": err, "epochs": cursor, "blocks": cursor // BLOCK}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--captures", required=True)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--slow", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)

    from ..parallel.mesh import make_mesh
    from ..utils.device import card_or_cpu

    dev = card_or_cpu(args.device, "multiprocess_run")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("gloo",
                            init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    try:
        group = dist.group.WORLD
        n_pos = WORLD_POSITIONS[0] * WORLD_POSITIONS[1]
        if n_pos % args.world:
            raise ValueError(f"{args.world} ranks do not divide {n_pos} "
                             "positions")
        mesh = make_mesh(*WORLD_POSITIONS,
                         devices=[dev] * (n_pos // args.world), group=group)
        cap = args.captures
        rec = {"rank": args.rank, "world": args.world, "device": str(dev),
               "positions": list(mesh.positions)}
        stages = [
            ("acquisition", lambda: stage_acquisition(
                mesh, dev, np.load(os.path.join(cap, "x1.npy")), args.rank,
                group)),
            ("tracking", lambda: stage_tracking(
                mesh, dev, np.load(os.path.join(cap, "x2.npy")), group)),
            ("decode", lambda: stage_decode(
                mesh, dev, np.load(os.path.join(cap, "x3.npy")),
                np.load(os.path.join(cap, "phases3.npy")), group)),
        ]
        if args.slow:
            stages.append(("fix", lambda: stage_fix(mesh, dev, cap, group)))
        for name, run in stages:
            _reset_counts()
            t0 = time.perf_counter()
            rec[name] = run()
            rec[name]["seconds"] = time.perf_counter() - t0
            got = rec[name].setdefault("launches", _path_counts())
            # on the card: the kernel once a position a block, never its
            # plain version; on the CPU: no launch
            want = (len(mesh.positions) * rec[name]["blocks"]
                    if dev.type == "cuda" else 0)
            _require(got["k1"] == want and got["plain"] == 0,
                     f"{name}: launches {got}, want {want} kernel launches "
                     f"({rec[name]['blocks']} blocks x "
                     f"{len(mesh.positions)} positions) and no plain call")
            print(f"[rank {args.rank}] {name} OK {rec[name]}", flush=True)
        print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
