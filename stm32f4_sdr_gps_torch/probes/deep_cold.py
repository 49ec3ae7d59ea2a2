"""The cold-start fix floor of the deep chain (the port of the JAX
package's tools/deep_cold_probe.py).

    python -m stm32f4_sdr_gps_torch.probes.deep_cold [cn0=29] [seed=21]
        [frame_repeats=2] [--device cuda] [--held]

``ULTRA_ACQ`` acquisition -> fine Doppler + pre-track -> aided bit sync
-> 100 ms data-wipeoff PLL (``DEEP_COHERENT_TRACK``, on the card the
tracking-scan kernel K1 with ``pll_ext_bits = 5``) -> ephemeris decode ->
PVT, ``Receiver.run`` with 1000-epoch blocks over ``fix_scenario(
num_epochs=6000 + 30000 * frame_repeats, cn0_dbhz=cn0, seed=seed,
frame_repeats=frame_repeats)``: 66 s with the 30 s frame sent twice at
the defaults.  Prints each channel's bit sync, ephemeris mask and SNR,
and the fix error or ``NO FIX``, then the run's record
(probes/weak_chain.run_once) as one JSON line.  The Receiver runs on
``--device``: the card by default, raising without one.

:func:`check_fix` holds a record to tests/test_e2e_slow.py:83-90's bars:
every channel's ephemeris set full and its bit grid synced, a fix within
500 m; :func:`check_outcome` holds it to those bars or, on a seed of
KNOWN_MISS, to exactly that miss.  With ``--held`` every block of the
tracking-scan kernel on the card is also run through its plain version on
the CPU from the same entering state in worker processes
(:func:`run_traced`), each block where a channel parts is printed with the
marginal decision it parts on (:func:`scan_parts`; :func:`check_held`
fails on a part with none), and then the plain version runs the whole
chain on the CPU and the two runs are compared channel by channel: the
first block where they part and the first aided-sync window whose
engagement differs (:func:`compare_traces`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

FIX_BAR_M = 500.0


class DeepColdError(AssertionError):
    """A bar of the 29 dBHz cold start failed."""


def scenario(cn0=29.0, seed=21, reps=2):
    """The deep chain's ``fix_scenario``."""
    from ..signal.scenarios import fix_scenario

    return fix_scenario(num_epochs=6_000 + reps * 30_000, cn0_dbhz=cn0,
                        seed=seed, frame_repeats=reps)


def config(prns):
    """ULTRA_ACQ + DEEP_COHERENT_TRACK with 1000-epoch blocks."""
    from ..config import DEEP_COHERENT_TRACK, ULTRA_ACQ, ReceiverConfig

    return ReceiverConfig(prns=prns, acq=ULTRA_ACQ,
                          track=DEEP_COHERENT_TRACK, track_block_epochs=1000)


def save_scenario(path, cn0=29.0, seed=21, reps=2) -> None:
    """The scenario's samples, planted position and PRNs to ``path``
    (``.npz``), for a process that simulates it beside another's work."""
    sc = scenario(cn0, seed, reps)
    np.savez(path, samples=sc.samples, rr_true=sc.rr_true,
             prns=np.asarray(sc.prns))


def run(sc, device="cuda", kernel_plain=False) -> dict:
    """``Receiver.run`` of the deep chain on ``sc``: weak_chain.run_once's
    record.  ``kernel_plain`` runs the tracking-scan kernel's plain version
    on the CPU (``in_kernel_scan=True``)."""
    import dataclasses

    from .weak_chain import run_once

    cfg = config(tuple(sc.prns))
    if kernel_plain:
        cfg = cfg.replace(track=dataclasses.replace(cfg.track,
                                                    in_kernel_scan=True))
    return run_once(sc, cfg, device)


def check_fix(rec) -> None:
    """tests/test_e2e_slow.py:83-90 on a record of :func:`run`."""
    for ch in rec["channels"]:
        if not (ch["eph_full"] and ch["bit_synced"]):
            raise DeepColdError(f"PRN {ch['prn']}: eph full {ch['eph_full']}"
                                f", bit synced {ch['bit_synced']}", rec)
    err = rec["fix_error_m"]
    if err is None or not err < FIX_BAR_M:
        raise DeepColdError(f"fix error {err} m (bar {FIX_BAR_M:.0f})", rec)


# Where the deep chain misses the bar on the card (ROADMAP Queue 3, "The
# 29 dBHz fix floor"): seed -> (the one PRN short of a full ephemeris set,
# its subframes decoded), with no fix, every other set full and every
# channel bit synced.  Seed 42's miss is also that of the port's reference
# scan and of K1's plain version on the CPU (tests/
# test_torch_sensitivity_deep.py::test_deep_cold_29dbhz_seed42_miss); on
# seed 7 K1's plain version fixes, and the card's run parts from it only
# at half-chip cells that the two runs' code phases straddle (``--held``).
# The JAX reference scan fixes on both; the JAX Pallas kernel misses both
# with PRN 7 short (test_deep_cold_29dbhz_jax_kernel_misses).
KNOWN_MISS = {7: (15, 0), 42: (15, 0)}


def check_outcome(rec, seed) -> str:
    """:func:`check_fix`, or where that fails on a seed of KNOWN_MISS,
    exactly that miss.  Returns "fix" or "known miss"; raises
    DeepColdError on any other outcome."""
    try:
        check_fix(rec)
        return "fix"
    except DeepColdError as e:
        bar = e.args[0]
    short = [(ch["prn"], ch["subframes"]) for ch in rec["channels"]
             if not ch["eph_full"]]
    unsynced = [ch["prn"] for ch in rec["channels"] if not ch["bit_synced"]]
    want = KNOWN_MISS.get(seed)
    if want is None or short != [want] or unsynced or rec["solutions"]:
        raise DeepColdError(
            f"{bar}; not the known miss {want} (PRN, subframes): short of "
            f"a set {short}, not synced {unsynced}, {rec['solutions']} "
            "solutions", rec)
    return "known miss"


def check_held(parts) -> None:
    """Every block where K1 parted from its plain version (the ``parts``
    of :func:`run_traced` with ``held``) parts at a marginal decision;
    one with none is a kernel fault."""
    bad = [p for p in parts if p["marginal"] is None]
    if bad:
        raise DeepColdError(f"K1 parts from its plain version with no "
                            f"marginal decision: {bad}", parts)


# a prompt-sign decision on |ip| below this is marginal (chip_smoke.py)
MARGINAL_IP = 0.5
# tests/test_pallas_scan.py:68-117's tolerances on the (T, C) outputs
CP_ATOL = 5e-3
# a float32 ulp of a replica sample's position (< 2048 chips)
POS_ULP = 2.0 ** -13


def _half_chip_cells(cp_a, cp_b, dop_a, dop_b, plan):
    """(T, C) bool: epochs where two runs' code phases, within CP_ATOL of
    each other, put some replica sample in different half-chip cells (a
    multiple of 0.5 chip lies in the span their samples' positions
    sweep, widened by one float32 ulp; tests/test_torch_dynamics.py::
    half_chip_marginal)."""
    from ..config import FREQ_L1_HZ

    def sweep(dop):
        d_in = np.concatenate([dop[:1], dop[:-1]]).astype(np.float64)
        return ((plan.samples_per_epoch - 1) * float(plan.chips_per_sample)
                * d_in / FREQ_L1_HZ)

    cp_a, cp_b = cp_a.astype(np.float64), cp_b.astype(np.float64)
    sw_a, sw_b = sweep(dop_a), sweep(dop_b)
    lo = np.minimum(cp_a + np.minimum(sw_a, 0), cp_b + np.minimum(sw_b, 0))
    hi = np.maximum(cp_a + np.maximum(sw_a, 0), cp_b + np.maximum(sw_b, 0))
    return ((np.floor(2 * (hi + POS_ULP)) != np.floor(2 * (lo - POS_ULP)))
            & (np.abs(cp_a - cp_b) <= CP_ATOL))


def scan_parts(raw_k, raw_r, plan) -> dict:
    """Two (T, NOUT, C) slot streams of the tracking scan from the same
    entering state (K1's ``raw_k`` and its plain version's ``raw_r``),
    under tests/test_pallas_scan.py:68-117's tolerances and exact
    decisions: {channel: the first epoch where they part, and the first
    marginal decision at or before it (``marginal``: "prompt_sign"
    within MARGINAL_IP of zero, "half_chip" cell straddled, "bit_sum" a
    coherent bit's prompt-I sum within n * MARGINAL_IP of zero, or None:
    no marginal decision, a kernel fault) at ``marginal_epoch``, the
    largest Doppler difference before it (``doppler_diff_before``:
    float-order noise where the runs agree until then), and both runs'
    values at the part}.  As chip_smoke.py's _compare, a channel is held
    only up to its first marginal decision."""
    k, r = (np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else x, np.float64) for x in (raw_k, raw_r))
    names = ("ip", "qp", "code_phase", "doppler", "bit_ready", "bit_value",
             "bit_epoch", "sync")
    a = {n: k[:, i] for i, n in enumerate(names)}
    b = {n: r[:, i] for i, n in enumerate(names)}
    a["snr"], b["snr"] = (10 * np.log10(np.maximum(o[:, 8], 1e-30)
                                        / np.maximum(o[:, 10], 1e-30))
                          for o in (k, r))
    bad = np.zeros(a["ip"].shape, bool)
    for n, rtol, atol in (("ip", 2e-2, 2.0), ("qp", 2e-2, 2.0),
                          ("code_phase", 0.0, CP_ATOL), ("doppler", 0.0, 0.5),
                          ("snr", 0.0, 0.1)):
        bad |= ~(np.abs(a[n] - b[n]) <= atol + rtol * np.abs(b[n]))
    ready = b["bit_ready"] > 0
    bad |= (a["bit_ready"] != b["bit_ready"]) | (a["sync"] != b["sync"])
    bad |= ready & ((a["bit_value"] != b["bit_value"])
                    | (a["bit_epoch"] != b["bit_epoch"]))
    kinds = {"prompt_sign": ((a["ip"] > 0) != (b["ip"] > 0))
             & (np.minimum(np.abs(a["ip"]), np.abs(b["ip"])) < MARGINAL_IP),
             "half_chip": _half_chip_cells(a["code_phase"], b["code_phase"],
                                           a["doppler"], b["doppler"], plan),
             "bit_sum": np.zeros_like(bad)}
    for t, c in zip(*np.nonzero(a["bit_value"] != b["bit_value"])):
        prev = np.nonzero(ready[:t, c])[0]
        be = int(prev[-1]) if prev.size else 0
        sums = [float(np.where(o["sync"][be:t, c] > 0, o["ip"][be:t, c],
                               0.0).sum()) for o in (a, b)]
        if min(map(abs, sums)) < MARGINAL_IP * max(t - be, 1):
            kinds["bit_sum"][t, c] = True
    parts = {}
    for c in np.nonzero(bad.any(0))[0]:
        t = int(bad[:, c].argmax())
        first = {kd: int(m[: t + 1, c].argmax()) for kd, m in kinds.items()
                 if m[: t + 1, c].any()}
        kd = min(first, key=first.get) if first else None
        dd = np.abs(a["doppler"][:, c] - b["doppler"][:, c])
        parts[int(c)] = {"epoch": t, "marginal": kd,
                         "marginal_epoch": first.get(kd),
                         "doppler_diff_before": float(
                             dd[: first[kd]].max(initial=0.0) if first
                             else dd[:t].max(initial=0.0)),
                         **{n: [float(a[n][t, c]), float(b[n][t, c])]
                            for n in ("ip", "qp", "code_phase", "doppler",
                                      "bit_value", "sync")}}
    return parts


def held_block(state, epochs, u2, plan, tcfg, raw_k) -> dict:
    """One block of K1 (its slot stream ``raw_k``) held to its plain
    version on the CPU from the same entering ScanState ``state``:
    :func:`scan_parts`."""
    from ..ops import track_scan as ts

    _, raw_r = ts.track_scan_reference(state, epochs, u2, plan, tcfg)
    return scan_parts(raw_k, raw_r, plan)


def worker_init() -> None:
    """A worker process of ``run_traced``'s ``procs``: one thread each."""
    torch.set_num_threads(1)


def run_traced(sc, device="cuda", kernel_plain=False, procs=None) -> dict:
    """:func:`run`, recording every tracking block (its entering epoch,
    code phase and Doppler, and the (T, NOUT, C) slot stream) and every
    aided-sync window (the boundary phases and confidences of
    track.aided_sync.boundary_from_flip_hist, and which channels it
    engaged) under "trace".  Given ``procs`` (an executor of processes
    started with :func:`worker_init`), each block of K1 on the card is
    also run there through its plain version on the CPU from the same
    entering ScanState and held to it (:func:`held_block`; the card's
    state carries on): "parts" lists each block where a channel parted.
    The run is eager (``graphs.disable_capture``): its hook reads each
    block's slot stream, which a captured program keeps inside."""
    from ..runtime import receiver
    from ..utils import graphs

    trace = {"blocks": [], "windows": []}
    held_jobs = []
    orig_scan, orig_hist = receiver.track_scan, receiver.boundary_from_flip_hist
    orig_engage = receiver.engage_bit_sync

    def scan(ps, epochs, u2, plan, tcfg):
        ps_k, raw_k = orig_scan(ps, epochs, u2, plan, tcfg)
        block = int(ps.i32[11, 0])
        trace["blocks"].append({
            "epoch": block, "code_phase": ps.f32[0].cpu().numpy(),
            "doppler": ps.f32[1].cpu().numpy(), "raw": raw_k.cpu().numpy()})
        if procs is not None:
            held_jobs.append((block, procs.submit(
                held_block, type(ps)(*(t.cpu() for t in ps)), epochs.cpu(),
                u2.cpu(), plan, tcfg, raw_k.cpu())))
        return ps_k, raw_k

    def hist(h):
        phases, confs = orig_hist(h)
        trace["windows"].append({"phases": np.asarray(phases),
                                 "confs": np.asarray(confs),
                                 "engaged": None})
        return phases, confs

    def engage(state, phases, epoch, cib, mask):
        trace["windows"][-1].update(engaged=np.asarray(mask), epoch=epoch)
        return orig_engage(state, phases, epoch, cib, mask)

    receiver.track_scan = scan
    receiver.boundary_from_flip_hist = hist
    receiver.engage_bit_sync = engage
    try:
        with graphs.disable_capture():
            rec = run(sc, device, kernel_plain)
    finally:
        receiver.track_scan = orig_scan
        receiver.boundary_from_flip_hist = orig_hist
        receiver.engage_bit_sync = orig_engage
    prns = [ch["prn"] for ch in rec["channels"]]
    parts = []
    for block, job in held_jobs:
        parts += [{"block": block, "channel": c, "prn": prns[c], **p}
                  for c, p in job.result().items()]
    return {**rec, "parts": parts, "trace": trace}


def compare_traces(ta, tb, prns, plan) -> dict:
    """Two whole runs' traces (:func:`run_traced`, e.g. the card's and K1's
    plain version's on the CPU) compared channel by channel: the first
    block whose slot streams part (:func:`scan_parts`, with the two runs'
    entering code phases and Dopplers there), and the first aided-sync
    window whose engagement differs, with both runs' confidences.  Returns
    {prn: {...}}."""
    out = {}
    for c, prn in enumerate(prns):
        rec = {}
        for ba, bb in zip(ta["blocks"], tb["blocks"]):
            p = scan_parts(ba["raw"][..., c: c + 1], bb["raw"][..., c: c + 1],
                           plan).get(0)
            if p is not None:
                rec["part"] = {"block": ba["epoch"], **p, "entering": {
                    "code_phase": [float(ba["code_phase"][c]),
                                   float(bb["code_phase"][c])],
                    "doppler": [float(ba["doppler"][c]),
                                float(bb["doppler"][c])]}}
                break
        for i, (wa, wb) in enumerate(zip(ta["windows"], tb["windows"])):
            ea, eb = (bool(w["engaged"] is not None and w["engaged"][c])
                      for w in (wa, wb))
            if ea != eb:
                rec["engagement"] = {
                    "window": i, "engaged": [ea, eb],
                    "confidence": [float(wa["confs"][c]),
                                   float(wb["confs"][c])],
                    "phase": [int(wa["phases"][c]), int(wb["phases"][c])]}
                break
        rec["engaged_at"] = [
            [int(w["epoch"]) for w in t["windows"]
             if w["engaged"] is not None and w["engaged"][c]]
            for t in (ta, tb)]
        out[prn] = rec
    return out


def report_lines(rec) -> list:
    """The tool's printout of a record."""
    lines = [f"  prn {ch['prn']}: synced={ch['bit_synced']} "
             f"eph_full={ch['eph_full']} mask={ch['mask']:#05b} "
             f"snr={ch['snr_db']:.1f}" for ch in rec["channels"]]
    err = rec["fix_error_m"]
    lines.append(f"FIX err={err:.1f} m ({rec['solutions']} solutions)"
                 if err is not None else "NO FIX")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cn0", type=float, nargs="?", default=29.0)
    ap.add_argument("seed", type=int, nargs="?", default=21)
    ap.add_argument("frame_repeats", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--held", action="store_true",
                    help="hold K1 to its plain version on every block, and "
                         "compare the run with the plain version's own")
    args = ap.parse_args(argv)
    from ..config import BASEBAND_PLAN
    from ..utils.device import card_or_cpu

    card_or_cpu(args.device, "deep_cold")
    print(f"cn0={args.cn0} seed={args.seed} frame_repeats="
          f"{args.frame_repeats} epochs={6_000 + args.frame_repeats * 30_000}",
          flush=True)
    t0 = time.time()
    sc = scenario(args.cn0, args.seed, args.frame_repeats)
    print(f"synth {time.time() - t0:.0f}s", flush=True)
    if args.held:
        import multiprocessing
        import os
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(
                max(1, (os.cpu_count() or 2) - 1),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=worker_init) as procs:
            rec = run_traced(sc, args.device, procs=procs)
    else:
        rec = run(sc, args.device)
    print(f"receiver {rec['wall_s']:.0f}s", flush=True)
    print("\n".join(report_lines(rec)))
    extra = {}
    if args.held:
        for p in rec["parts"]:
            print(f"  part: block {p['block']} epoch {p['epoch']} PRN "
                  f"{p['prn']} marginal {p['marginal']} at "
                  f"{p['marginal_epoch']}: {p}")
        plain = run_traced(sc, "cpu", kernel_plain=True)
        print("the kernel's plain version on the CPU, the whole run:")
        print("\n".join(report_lines(plain)))
        prns = [ch["prn"] for ch in rec["channels"]]
        runs = compare_traces(rec.pop("trace"), plain.pop("trace"), prns,
                              BASEBAND_PLAN)
        for prn, c in runs.items():
            print(f"  PRN {prn} card vs plain: {c}")
        extra = {"parts": rec.pop("parts"), "plain": plain, "runs": runs}
        check_held(extra["parts"])
    print(json.dumps({"cn0": args.cn0, "seed": args.seed,
                      "frame_repeats": args.frame_repeats,
                      "device": args.device, **rec, **extra}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
