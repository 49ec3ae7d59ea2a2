"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
before the result line):

1. card: the device name and ``nvidia-smi`` name/power-limit line;
2. build: the four kernel libraries from csrc/ with nvcc, one nvcc each,
   all started together (build seconds and ptxas lines): the tracking
   scan (K1), the per-epoch E/P/L correlator (K2), the correlator-bank
   probe (P5) and the epoch-cost probes (P6-P8);
3. K1 vs its plain version on the card: the tracking scan on 32 channels
   (PRNs 1-32 at 48 dBHz, seeded Doppler and code phase, 3 codes per
   bit) over 1000 epochs, and on the main path's 4-channel shape, held to
   its plain torch version with the tolerances of
   tests/test_pallas_scan.py:68-117 and exact integer decisions (each
   channel up to its first prompt-sign decision that lies within float32
   summation error of zero, see MARGINAL_IP); a 500 + 500 split must
   equal the full run; median block times from CUDA events (the kernel
   over 20 back-to-back launches);
4. K1 main path: ``Receiver.run`` on the card from cold start to a
   position fix on a 29 s, 4-satellite capture with real 20 ms nav bits
   at 48 dBHz; the fix must be within 500 m of the planted position, and
   every tracking block must have gone through the kernel;
5. K2 vs its plain version on the card, one epoch: 4, 32 and 128
   channels at random phases and at the code-phase wrap edges of
   tests/test_pallas.py:57, rtol 1e-4 / atol 1e-3 on the sums (summation
   order, and sincospif vs cos/sin(2 pi .)); at 4 and 32 channels the
   device time per call (calls queued behind a device sleep) and the
   time per call over 1000 back-to-back calls, host included;
6. the per-epoch closed loop with K2: ``track_block`` with
   ``use_pallas=True, in_kernel_scan=False`` on phase 3's 32-channel,
   1000-epoch scenario on the card, held to the same scan on CPU copies
   (the plain version) under phase 3's rules, with one K2 launch per
   epoch and no plain-version call on the card side;
7. the half-chip main path: ``Receiver.run`` with ``use_pallas=True,
   in_kernel_scan=False`` on the card on phase 4's capture; fix within
   500 m, |vel| < 10 m/s, full ephemerides, one K2 launch per tracked
   epoch, no plain-version call and no tracking-scan launch;
8. P5, both variants at C = 32, SP = 2048, N = 128, T = 1600 on the
   probe's inputs, held to their plain versions (1e-4 of the largest
   sum), then the probe's entry point, which prints ns per step;
9. P6-P8, every variant (11 + 11 + 8) at the check size (C = 32, G = 2,
   K = 4) on the probe's inputs and on seeded ones, held to its plain
   version on the card (fused steps, P7 and the sums rtol 1e-5, sincos
   atol 1e-5 besides; selects, int ops, transposes and the barrel exact)
   with finite outputs; each variant's kernel and plain-version time per
   launch there; then the three entry points at full size (C = 32 and 4
   at G = 128, and C = 32 at G = 64 to show the time scales with G; P7
   also on finite values, and its barrier variants at C = 256), which
   print ns per iteration per variant (the device time of launches queued
   behind a device sleep) and P7's deltas over base, and must launch
   every kernel.

The second-to-last stdout line is the kernels' JSON record, the last the
device record.  Imports only this checkout's stm32f4_sdr_gps_torch,
torch and numpy.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(smi)
    return name, smi


def build():
    from concurrent.futures import ThreadPoolExecutor

    from stm32f4_sdr_gps_torch.ops import kernel_lib

    libs = {"track_scan_cuda": kernel_lib.cuda_lib,
            "epl_cuda": kernel_lib.epl_lib,
            "corr_bank_cuda": kernel_lib.corr_bank_lib,
            "forest_cuda": kernel_lib.forest_lib}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(fn) for fn in libs.values()]:
            fut.result()
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f}"
          " s wall (one nvcc each, in parallel)")
    for name in libs:
        info = kernel_lib.build_info[name]
        print(f"[build] {name} built in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            print(f"[build]   {line}")


def _median_ms(fn, reps, calls):
    """Median over ``reps`` of the CUDA-event time of ``calls`` calls of
    ``fn`` issued back to back, per call: the device time per call, with
    the host's per-call work hidden behind the device's."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# A prompt-sign decision on |ip| below this many units is inside the
# float32 summation-order error of a 2046-sample correlator sum (the
# kernel and the plain version add the samples in different orders), so
# either sign is right; past such an epoch the two closed loops may part.
MARGINAL_IP = 0.5


def _compare(st_k, out_k, st_r, out_r, label):
    """Kernel (k) vs plain version (r) on one run of a tracking loop: the
    tolerances of tests/test_pallas_scan.py:68-117 on the floats and exact
    integer decisions, for every channel up to its first marginal
    prompt-sign decision (see MARGINAL_IP); a channel without one must
    also end in the same integer state, and at most one channel in eight
    (at least one) may have such a decision.  ``st_*`` are final
    ScanStates (i32 planes and watchdog window), ``out_*`` TrackOutputs
    with (T, C) leaves.  Returns the max |kernel - plain| over the
    compared outputs (ip and qp dominate: correlator units, the
    2046-sample sums of a 48 dBHz signal run to thousands)."""
    import numpy as np

    k = {f: getattr(out_k, f).cpu().numpy() for f in out_k._fields}
    r = {f: getattr(out_r, f).cpu().numpy() for f in out_r._fields}
    t_cnt, c_cnt = r["ip"].shape
    marginal = (((k["ip"] > 0) != (r["ip"] > 0))
                & (np.minimum(np.abs(k["ip"]), np.abs(r["ip"]))
                   < MARGINAL_IP))
    stop = np.where(marginal.any(0), marginal.argmax(0), t_cnt)
    valid = np.arange(t_cnt)[:, None] < stop[None, :]          # (T, C)
    if (stop < t_cnt).sum() > max(1, c_cnt // 8):
        fail(f"{label}: marginal sign decisions on {(stop < t_cnt).sum()}"
             f" of {c_cnt} channels")

    errs = {}

    def check(name, rtol, atol):
        a, b = k[name].astype(np.float64), r[name].astype(np.float64)
        diff = np.abs(a - b)
        bad = valid & ~(diff <= atol + rtol * np.abs(b))
        if bad.any():
            t, c = np.argwhere(bad)[0]
            fail(f"{label}: {name} differs at epoch {t} channel {c}: "
                 f"kernel {a[t, c]} plain {b[t, c]}")
        errs[name] = float(np.where(valid, diff, 0.0).max())

    check("ip", 2e-2, 2.0)
    check("qp", 2e-2, 2.0)
    check("code_phase_chips", 0.0, 5e-3)
    check("doppler_hz", 0.0, 0.5)
    check("snr_db", 0.0, 0.1)
    for name in ("bit_ready", "bit_value", "bit_epoch", "period_sync_ok",
                 "code_wrapped"):
        check(name, 0.0, 0.0)
    whole = stop == t_cnt
    for name, a, b in (("i32 state", st_k.i32, st_r.i32),
                       ("watchdog window", st_k.win, st_r.win)):
        if not np.array_equal(a.cpu().numpy()[:, whole],
                              b.cpu().numpy()[:, whole]):
            fail(f"{label}: final {name} differs")
    bits = int(r["bit_ready"][valid].sum())
    if bits == 0:
        fail(f"{label}: the scenario produced no nav bit")
    print(f"[compare] {label}: {bits} bits, integer decisions equal; "
          f"channels with a marginal sign decision (compared up to it): "
          f"{ {int(c): int(stop[c]) for c in np.nonzero(~whole)[0]} }; "
          f"max |kernel - plain| {errs}")
    return max(errs.values())


def _compare_scan(ps_k, out_k, ps_r, out_r, label):
    """_compare on two runs of the tracking-scan kernel's slot streams."""
    from stm32f4_sdr_gps_torch.ops.track_scan import outputs_from_raw

    return _compare(ps_k, outputs_from_raw(out_k), ps_r,
                    outputs_from_raw(out_r), label)


def kernel_vs_plain():
    """K1 against its plain version; returns the max error, the block
    times and the 32-channel scenario (state, epochs, codes) on the
    card."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
    from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
    from stm32f4_sdr_gps_torch.signal.simulator import (SimSat,
                                                        simulate_capture)
    from stm32f4_sdr_gps_torch.track.state import init_state

    dev = torch.device("cuda")
    plan, cib, n_ep = BASEBAND_PLAN, 3, 1000
    prns = list(range(1, 33))
    rng = np.random.default_rng(7)
    sats = [SimSat(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                   code_phase_chips=float(rng.uniform(0, 1023)),
                   cn0_dbhz=48.0, codes_in_bit=cib,
                   nav_bits=rng.integers(0, 2, 400)) for p in prns]
    t0 = time.perf_counter()
    x_np, _ = simulate_capture(sats, num_epochs=n_ep, seed=7)
    print(f"[kernel] simulated 32 satellites x {n_ep} epochs in "
          f"{time.perf_counter() - t0:.1f} s")
    x = torch.as_tensor(x_np.reshape(n_ep, plan.samples_per_epoch),
                        device=dev)
    u2 = torch.as_tensor(upsampled_code_doubled(ca_table_bipolar(prns)),
                         device=dev)
    cfg = TrackConfig(codes_in_bit=cib)
    st = init_state(len(prns),
                    np.array([s.code_phase_chips + 0.1 for s in sats]),
                    np.array([s.doppler_hz + 15.0 for s in sats]),
                    device=dev)
    ps0 = ts.state_from_track_state(st)

    ps_k, out_k = ts.track_scan_cuda(ps0, x, u2, plan, cfg)
    ps_r, out_r = ts.track_scan_reference(ps0, x, u2, plan, cfg)
    torch.cuda.synchronize()
    err32 = _compare_scan(ps_k, out_k, ps_r, out_r, "K1 32 ch x 1000 epochs")
    ps_a, out_a = ts.track_scan_cuda(ps0, x[:500], u2, plan, cfg)
    ps_b, out_b = ts.track_scan_cuda(ps_a, x[500:], u2, plan, cfg)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, torch.cat([out_a, out_b]))
            and all(torch.equal(a, b) for a, b in zip(ps_k, ps_b))):
        fail("kernel: split 500 + 500 differs from the full 1000 run")
    print("[kernel] split 500 + 500 == full 1000 run, bit for bit")

    # the main path's shape: 4 channels x 1000 epochs
    sub = ts.ScanState(f32=ps0.f32[:, :4].contiguous(),
                       i32=ps0.i32[:, :4].contiguous(),
                       win=ps0.win[:, :4].contiguous())
    u2_4 = u2[:4].contiguous()
    ps_k4, out_k4 = ts.track_scan_cuda(sub, x, u2_4, plan, cfg)
    ps_r4, out_r4 = ts.track_scan_reference(sub, x, u2_4, plan, cfg)
    torch.cuda.synchronize()
    err4 = _compare_scan(ps_k4, out_k4, ps_r4, out_r4, "K1 4 ch x 1000 epochs")

    times = {}
    for label, state, table in (("32ch", ps0, u2), ("4ch", sub, u2_4)):
        ts.track_scan_cuda(state, x, table, plan, cfg)       # warm-up
        k_ms = _median_ms(
            lambda: ts.track_scan_cuda(state, x, table, plan, cfg), 5, 20)
        p_ms = _median_ms(
            lambda: ts.track_scan_reference(state, x, table, plan, cfg), 3, 1)
        times[label] = (k_ms, p_ms)
        print(f"[kernel] {label} x 1000 epochs: kernel median {k_ms:.4f} ms"
              f", plain version median {p_ms:.2f} ms per block "
              f"(CUDA events)")
    return max(err32, err4), times, (st, x, u2)


def _reset_counts():
    """Every kernel's launch count and every plain version's call count
    to 0."""
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import corr_bank as cb

    ts.track_scan_cuda.launches = 0
    ts.track_scan_reference.calls = 0
    epl.epl_correlate_cuda.launches = 0
    epl.epl_correlate_halfchip.calls = 0
    cb.corr_bank_fma_cuda.launches = 0
    cb.corr_bank_mma_cuda.launches = 0
    for mod, _, _ in _forest_probes():
        for fn in set(mod.KERNELS.values()):
            fn.launches = 0


def _counts():
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.ops import track_scan as ts

    return {"track_scan": ts.track_scan_cuda.launches,
            "track_scan_plain": ts.track_scan_reference.calls,
            "epl": epl.epl_correlate_cuda.launches,
            "epl_plain": epl.epl_correlate_halfchip.calls}


def _run_receiver(sc, track, label):
    """Receiver.run on the card on the fix scenario; checks the fix and
    the ephemerides, returns (report, receiver, kernel counts of the
    run)."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig(prns=sc.prns, track=track, track_block_epochs=1000)
    rx = Receiver(cfg, device="cuda")
    _reset_counts()
    t0 = time.perf_counter()
    report = rx.run(sc.samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    tracked = report.epochs_processed - cfg.acq.noncoherent_epochs
    blocks = rx.profiler.stages["track"].calls
    print(f"[{label}] Receiver.run: {wall:.2f} s wall for "
          f"{report.epochs_processed} epochs ({tracked} tracked in {blocks} "
          f"blocks; {len(sc.samples) / 2.046e6 / wall:.2f}x real time); "
          f"counts {counts}")
    print(rx.profiler.report())
    for ch in report.channels:
        print(f"[{label}] PRN {ch.prn:2d} {ch.state_name} dop "
              f"{ch.doppler_hz:9.2f} Hz cn0 {ch.cn0_dbhz:5.1f} dBHz subframes "
              f"{ch.subframe_count} eph {ch.eph.has_full_set}")
        if not ch.eph.has_full_set:
            fail(f"{label}: PRN {ch.prn} has no full ephemeris set")
    if not report.solutions:
        fail(f"{label}: no position fix")
    sol = report.solutions[-1]
    err = float(np.linalg.norm(sol.rr - sc.rr_true))
    vel = float(np.linalg.norm(sol.vel))
    print(f"[{label}] {len(report.solutions)} solutions; final fix error "
          f"{err:.1f} m, |vel| {vel:.2f} m/s")
    if not (np.all(np.isfinite(sol.rr)) and err < 500.0 and vel < 10.0):
        fail(f"{label}: fix error {err:.1f} m / |vel| {vel:.2f} m/s out of "
             "bounds")
    return report, rx, counts, tracked


def main_path(sc):
    """K1's main path: the default TrackConfig on the card."""
    from stm32f4_sdr_gps_torch.config import TrackConfig

    _, rx, counts, _ = _run_receiver(sc, TrackConfig(), "main")
    blocks = rx.profiler.stages["track"].calls
    if (counts["track_scan"] < blocks or counts["track_scan_plain"]
            or counts["epl"] or counts["epl_plain"]):
        fail(f"main path bypassed the tracking-scan kernel: {counts} for "
             f"{blocks} blocks")
    return counts["track_scan"]


WRAP_EDGES = (0.0, 0.2, 0.49, 0.51, 1022.6, 1022.99)


def epl_vs_plain():
    """K2 against its plain version on one epoch; returns the max error
    and the per-call times (kernel, plain) at 4 and 32 channels."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.probes.common import queued_ms
    from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar

    dev = torch.device("cuda")
    fs = BASEBAND_PLAN.sample_rate_hz
    rng = np.random.default_rng(9)
    max_err, inputs = 0.0, {}
    for c in (4, 32, 128):
        u2 = epl.upsampled_code_doubled(
            ca_table_bipolar([1 + i % 32 for i in range(c)]))
        for edges in (False, True):
            x = (rng.standard_normal(epl.S)
                 + 1j * rng.standard_normal(epl.S)).astype(np.complex64)
            cp = (np.resize(np.array(WRAP_EDGES, np.float32), c) if edges
                  else rng.uniform(0, 1023, c).astype(np.float32))
            dop = rng.uniform(-5000, 5000, c).astype(np.float32)
            ph = rng.uniform(0, 1, c).astype(np.float32)
            args = [torch.as_tensor(a, device=dev)
                    for a in (x, u2, cp, dop, ph)]
            got = epl.epl_correlate_cuda(*args, fs)
            want = epl.epl_correlate_halfchip(*args, fs)
            torch.cuda.synchronize()
            g = torch.view_as_real(got).cpu().numpy().astype(np.float64)
            w = torch.view_as_real(want).cpu().numpy().astype(np.float64)
            diff = np.abs(g - w)
            if not np.all(diff <= 1e-3 + 1e-4 * np.abs(w)):
                fail(f"K2 {c} ch (wrap edges {edges}): max |kernel - plain|"
                     f" {diff.max()} beyond rtol 1e-4 / atol 1e-3")
            max_err = max(max_err, float(diff.max()))
            print(f"[epl] {c:3d} ch, {'wrap-edge' if edges else 'random'} "
                  f"code phases: max |kernel - plain| {diff.max():.3e} "
                  f"(|sums| up to {np.abs(w).max():.1f})")
            if not edges:
                inputs[c] = args
    times = {}
    for c in (4, 32):
        args = inputs[c]

        def kernel():
            return epl.epl_correlate_cuda(*args, fs)

        def plain():
            return epl.epl_correlate_halfchip(*args, fs)

        kernel(), plain()                                    # warm-up
        k_dev = queued_ms(kernel, 3, 500)
        p_dev = queued_ms(plain, 3, 30)
        k_ms = _median_ms(kernel, 3, 1000)
        p_ms = _median_ms(plain, 3, 1000)
        times[c] = {"ms": k_dev, "plain_ms": p_dev, "call_ms": k_ms,
                    "plain_call_ms": p_ms}
        print(f"[epl] {c} ch: device time per call (queued ahead) kernel "
              f"{k_dev * 1e3:.2f} us, plain version {p_dev * 1e3:.2f} us; "
              f"per call over 1000 back-to-back calls (host included) "
              f"kernel {k_ms * 1e3:.2f} us, plain version {p_ms * 1e3:.2f} us"
              " (CUDA events)")
    return max_err, times


def closed_loop(scenario):
    """The per-epoch half-chip scan with K2 on the card against the same
    scan on CPU copies (the plain version)."""
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.ops.track_scan import state_from_track_state
    from stm32f4_sdr_gps_torch.track.scan import track_block

    st, x, u2 = scenario
    cfg = TrackConfig(codes_in_bit=3, use_pallas=True, in_kernel_scan=False)
    _reset_counts()
    t0 = time.perf_counter()
    st_k, out_k = track_block(st, x, u2, BASEBAND_PLAN, cfg)
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    counts = _counts()
    if counts["epl"] != x.shape[0] or counts["epl_plain"] \
            or counts["track_scan"]:
        fail(f"per-epoch scan on the card: counts {counts} for "
             f"{x.shape[0]} epochs")
    cpu = [t.cpu() for t in (x, u2)]
    st_c = type(st)(*(t.cpu() for t in st))
    t0 = time.perf_counter()
    st_r, out_r = track_block(st_c, *cpu, BASEBAND_PLAN, cfg)
    wall_r = time.perf_counter() - t0
    print(f"[loop] per-epoch half-chip scan, 32 ch x {x.shape[0]} epochs: "
          f"card (K2) {wall_k:.2f} s, CPU (plain) {wall_r:.2f} s; "
          f"card counts {counts}")
    return _compare(state_from_track_state(st_k), out_k,
                    state_from_track_state(st_r), out_r,
                    "K2 per-epoch scan 32 ch x 1000 epochs, card vs CPU")


def half_chip_path(sc):
    """The slice's main path: the per-epoch half-chip loop with K2."""
    from stm32f4_sdr_gps_torch.config import TrackConfig

    _, _, counts, tracked = _run_receiver(
        sc, TrackConfig(use_pallas=True, in_kernel_scan=False), "half-chip")
    if (counts["epl"] != tracked or counts["epl_plain"]
            or counts["track_scan"] or counts["track_scan_plain"]):
        fail(f"half-chip main path: counts {counts} for {tracked} tracked "
             "epochs (want one K2 launch per epoch and nothing else)")
    return counts["epl"]


def corr_bank():
    """P5: both variants against their plain versions, then the probe's
    entry point (launches counted there)."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.probes import corr_bank as cb

    steps = 1600
    inputs = cb.device_inputs(torch.device("cuda"))
    res = {}
    for variant in ("fma", "mma"):
        args = inputs[variant]
        got = cb.KERNELS[variant](*args, steps)
        want = cb.PLAIN[variant](*args, steps)
        torch.cuda.synchronize()
        g = got.cpu().numpy().astype(np.float64)
        w = want.cpu().numpy().astype(np.float64)
        if g.shape != (cb.C, 1) or not np.all(np.isfinite(g)):
            fail(f"P5 {variant}: output {g.shape}, finite {np.isfinite(g)}")
        err = float(np.abs(g - w).max())
        # float32 sums over 1600 steps of 2048-term row sums, in other
        # orders on the two sides (the mma side in float32 tensor-core
        # accumulators, its plain version in float64 on the same bf16
        # values): a few units in 1e-5 of the largest sum
        tol = 1e-4 * float(np.abs(w).max())
        if err > tol:
            fail(f"P5 {variant}: max |kernel - plain| {err} > {tol}")
        k_ms = _median_ms(lambda: cb.KERNELS[variant](*args, steps), 5, 1)
        p_ms = _median_ms(lambda: cb.PLAIN[variant](*args, steps), 3, 1)
        print(f"[p5] {variant}: max |kernel - plain| {err:.4g} (tolerance "
              f"{tol:.4g}, |sums| up to {np.abs(w).max():.1f}); kernel "
              f"{k_ms:.4f} ms, plain version {p_ms:.2f} ms per {steps} steps")
        res[variant] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
    _reset_counts()
    for variant in ("fma", "mma"):
        res[variant]["ns_per_step"] = cb.run(variant, steps)
    for variant in ("fma", "mma"):
        res[variant]["launches"] = cb.KERNELS[variant].launches
        if res[variant]["launches"] == 0:
            fail(f"P5 {variant}: the probe's entry point launched nothing")
    print(f"[p5] per step at 32 channels: vector sums (fma) "
          f"{res['fma']['ns_per_step']:.1f} ns, tensor-core products (mma) "
          f"{res['mma']['ns_per_step']:.1f} ns")
    return res


def _forest_probes():
    """(module, name, the TPU kernel it replaces) of P6, P7 and P8."""
    from stm32f4_sdr_gps_torch.probes import (forest_chain, forest_constructs,
                                              forest_layout)

    return ((forest_chain, "forest_chain", "tools/forest_probe.py:97"),
            (forest_constructs, "forest_constructs",
             "tools/forest_probe2.py:68"),
            (forest_layout, "forest_layout", "tools/forest_probe3.py:67"))


def forest():
    """P6-P8: every variant against its plain version at the check size
    on both input sets, then the entry points at full size (launches
    counted there)."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.probes.common import queued_ms

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    res = {}
    for mod, name, replaces in _forest_probes():
        err, rel, exact, check_ms = 0.0, 0.0, 0, {}
        for v in mod.VARIANTS:
            kernel, plain = mod.KERNELS[v], mod.PLAIN[v]
            rtol, atol = mod.tolerance(v)
            for which in ("probe", "seeded"):
                args = mod.check_args(v, which, dev)
                got, want = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                same = True
                for g, w in zip(got, want):
                    g = g.cpu().numpy().astype(np.float64)
                    w = w.cpu().numpy().astype(np.float64)
                    if (g.shape != w.shape or not np.all(np.isfinite(g))
                            or not np.all(np.isfinite(w))):
                        fail(f"{name} {v} ({which} inputs): shapes "
                             f"{g.shape} / {w.shape} or non-finite output")
                    diff = np.abs(g - w)
                    if not np.all(diff <= atol + rtol * np.abs(w)):
                        fail(f"{name} {v} ({which} inputs): max |kernel - "
                             f"plain| {diff.max()} beyond rtol {rtol} / "
                             f"atol {atol}")
                    err = max(err, float(diff.max()))
                    rel = max(rel, float((diff / np.maximum(
                        np.abs(w), 1e-30)).max()))
                    same = same and bool(np.array_equal(g, w))
                exact += same
            args = mod.check_args(v, "probe", dev)
            check_ms[v] = (queued_ms(lambda: kernel(*args), 5, 20),
                           _median_ms(lambda: plain(*args), 3, 1))
        n = 2 * len(mod.VARIANTS)
        k_ms = sum(k for k, _ in check_ms.values())
        p_ms = sum(p for _, p in check_ms.values())
        print(f"[forest] {name}: {len(mod.VARIANTS)} variants x 2 input "
              f"sets at the check size, {exact} of {n} bit for bit with the "
              f"plain version; max |kernel - plain| {err:.4g} (relative "
              f"{rel:.3g}); one launch of every variant {k_ms:.4f} ms (device"
              f" time, queued), the plain versions {p_ms:.2f} ms (CUDA "
              f"events)")
        pairs = {v: (round(k, 4), round(p, 2))
                 for v, (k, p) in check_ms.items()}
        print(f"[forest] {name} at the check size, ms per launch, kernel / "
              f"plain: {pairs}")
        res[name] = {"replaces": replaces, "max_abs_err": err,
                     "max_rel_err": rel, "bit_exact": f"{exact}/{n}",
                     "ms": k_ms, "plain_ms": p_ms, "check_ms": check_ms}

    _reset_counts()
    full = {}
    for mod, name, _ in _forest_probes():
        for c, g in ((32, 128), (32, 64), (4, 128)):
            if name == "forest_chain":
                r = mod.run(mod.VARIANTS, c, mod.K, g)
            elif name == "forest_constructs":
                # on finite values too (the chains overflow at full size)
                r = mod.run(mod.VARIANTS, c, g, finite=g == 128)
            else:
                r = mod.run(mod.VARIANTS, c, g)
            full[name, c, g] = r
        if name == "forest_constructs":
            for c in (32, 4):
                res[name][f"delta_ns_{c}ch"] = {
                    v: t["delta_ns"] for v, t in full[name, c, 128].items()}
                res[name][f"ns_per_iter_finite_{c}ch"] = {
                    v: t["ns_per_iter_finite"]
                    for v, t in full[name, c, 128].items()}
            # the barrier of a 256-thread block, K1's block size
            r = mod.run(["base", "when_any", "when_any4"], 256, 128,
                        finite=False)
            res[name]["delta_ns_256ch"] = {v: t["delta_ns"]
                                           for v, t in r.items()}
    for mod, name, _ in _forest_probes():
        launches = sum(fn.launches for fn in set(mod.KERNELS.values()))
        if launches == 0:
            fail(f"{name}: the entry points launched nothing")
        ns128, ns64, ns4 = ({v: t["ns_per_iter"] for v, t in r.items()}
                            for r in (full[name, 32, 128], full[name, 32, 64],
                                      full[name, 4, 128]))
        ratio = {v: round(ns64[v] / ns128[v], 3) for v in ns128}
        print(f"[forest] {name}: ns/iter at G = 64 over G = 128 (1.0: the "
              f"time scales with G): {ratio}")
        res[name].update(launches=launches, ns_per_iter=ns128,
                         ns_per_iter_g64=ns64, ns_per_iter_4ch=ns4)
    print(f"[forest] phase 9 in {time.perf_counter() - t0:.1f} s")
    return res


def main():
    sys.path.insert(0, HERE)
    import stm32f4_sdr_gps_torch

    pkg_dir = os.path.dirname(os.path.abspath(stm32f4_sdr_gps_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"stm32f4_sdr_gps_torch imported from {pkg_dir}, not from this "
             "checkout")
    name, smi = card()
    build()
    k1_err, k1_times, scenario = kernel_vs_plain()

    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    t0 = time.perf_counter()
    sc = fix_scenario(num_epochs=29_000)
    print(f"[main] simulated {len(sc.samples) / 2.046e6:.1f} s of "
          f"{len(sc.prns)}-satellite baseband ({sc.samples.nbytes / 1e6:.0f}"
          f" MB) in {time.perf_counter() - t0:.1f} s")
    k1_launches = main_path(sc)
    k2_err, k2_times = epl_vs_plain()
    loop_err = closed_loop(scenario)
    k2_launches = half_chip_path(sc)
    p5 = corr_bank()
    forest_res = forest()
    src = "stm32f4_sdr_gps_torch/csrc/"
    kernels = {"kernels": [{
        "name": "track_scan",
        "route": "cuda",
        "source": src + "track_scan.cu",
        "replaces": "stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py:179",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_times["4ch"][0],
        "plain_ms": k1_times["4ch"][1],
        "ms_32ch": k1_times["32ch"][0],
        "plain_ms_32ch": k1_times["32ch"][1],
    }, {
        "name": "epl",
        "route": "cuda",
        "source": src + "epl.cu",
        "replaces": "stm32f4_sdr_gps_tpu/ops/pallas_epl.py:57",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "closed_loop_max_abs_err": loop_err,
        **k2_times[4],
        **{f"{k}_32ch": v for k, v in k2_times[32].items()},
    }] + [{
        "name": f"corr_bank_{v}",
        "route": "cuda",
        "source": src + "corr_bank.cu",
        "replaces": "tools/mxu_corr_probe.py:56",
        "launches": p5[v]["launches"],
        "max_abs_err": p5[v]["max_abs_err"],
        "ms": p5[v]["ms"],
        "plain_ms": p5[v]["plain_ms"],
        "ns_per_step": p5[v]["ns_per_step"],
    } for v in ("fma", "mma")] + [{
        "name": name,
        "route": "cuda",
        "source": src + "forest.cu",
        **r,
    } for name, r in forest_res.items()]}
    import torch

    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
