"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
before the result line):

1. card: the device name and ``nvidia-smi`` name/power-limit line;
2. build: the tracking-scan kernel from csrc/ with nvcc (build seconds);
3. kernel vs plain version on the card: the tracking scan on 32 channels
   (PRNs 1-32 at 48 dBHz, seeded Doppler and code phase, 3 codes per
   bit) over 1000 epochs, and on the main path's 4-channel shape, held to
   its plain torch version with the tolerances of
   tests/test_pallas_scan.py:68-117 and exact integer decisions (each
   channel up to its first prompt-sign decision that lies within float32
   summation error of zero, see MARGINAL_IP); a 500 + 500 split must
   equal the full run; median block times from CUDA events (the kernel
   over 20 back-to-back launches);
4. main path: ``Receiver.run`` on the card from cold start to a position
   fix on a 29 s, 4-satellite capture with real 20 ms nav bits at
   48 dBHz; the fix must be within 500 m of the planted position, and
   every tracking block must have gone through the kernel.

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
    from stm32f4_sdr_gps_torch.ops import kernel_lib

    kernel_lib.cuda_lib()
    info = kernel_lib.build_info["track_scan_cuda"]
    print(f"[build] track_scan.cu built in {info['seconds']:.2f} s")
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


def _compare(ps_k, out_k, ps_r, out_r, label):
    """Kernel (k) vs plain version (r) on one slot stream: the tolerances
    of tests/test_pallas_scan.py:68-117 on the floats and exact integer
    decisions, for every channel up to its first marginal prompt-sign
    decision (see MARGINAL_IP); a channel without one must also end in
    the same integer state, and at most one channel in eight (at least
    one) may have such a decision.  Returns the max |kernel - plain| over
    the compared outputs (ip and qp dominate: correlator units, the
    2046-sample sums of a 48 dBHz signal run to thousands)."""
    import numpy as np

    from stm32f4_sdr_gps_torch.ops.track_scan import _snr_db_from_sums

    k = out_k.cpu().numpy()
    r = out_r.cpu().numpy()
    t_cnt, _, c_cnt = k.shape
    marginal = (((k[:, 0] > 0) != (r[:, 0] > 0))
                & (np.minimum(np.abs(k[:, 0]), np.abs(r[:, 0]))
                   < MARGINAL_IP))
    stop = np.where(marginal.any(0), marginal.argmax(0), t_cnt)
    valid = np.arange(t_cnt)[:, None] < stop[None, :]          # (T, C)
    if (stop < t_cnt).sum() > max(1, c_cnt // 8):
        fail(f"{label}: marginal sign decisions on {(stop < t_cnt).sum()}"
             f" of {c_cnt} channels")

    errs = {}

    def check(name, a, b, rtol, atol):
        diff = np.abs(a - b)
        bad = valid & ~(diff <= atol + rtol * np.abs(b))
        if bad.any():
            t, c = np.argwhere(bad)[0]
            fail(f"{label}: {name} differs at epoch {t} channel {c}: "
                 f"kernel {a[t, c]} plain {b[t, c]}")
        errs[name] = float(np.where(valid, diff, 0.0).max())

    check("ip", k[:, 0], r[:, 0], 2e-2, 2.0)
    check("qp", k[:, 1], r[:, 1], 2e-2, 2.0)
    check("code_phase_chips", k[:, 2], r[:, 2], 0.0, 5e-3)
    check("doppler_hz", k[:, 3], r[:, 3], 0.0, 0.5)
    snr = [_snr_db_from_sums(o[:, 8], o[:, 10]).numpy()
           for o in (out_k.cpu(), out_r.cpu())]
    check("snr_db", snr[0], snr[1], 0.0, 0.1)
    for slot, name in ((4, "bit_ready"), (5, "bit_value"), (6, "bit_epoch"),
                       (7, "period_sync_ok"), (9, "code_wrapped")):
        check(name, k[:, slot], r[:, slot], 0.0, 0.0)
    whole = stop == t_cnt
    for name, a, b in (("i32 state", ps_k.i32, ps_r.i32),
                       ("watchdog window", ps_k.win, ps_r.win)):
        if not np.array_equal(a.cpu().numpy()[:, whole],
                              b.cpu().numpy()[:, whole]):
            fail(f"{label}: final {name} differs")
    bits = int(r[:, 4][valid].sum())
    if bits == 0:
        fail(f"{label}: the scenario produced no nav bit")
    print(f"[kernel] {label}: {bits} bits, integer decisions equal; "
          f"channels with a marginal sign decision (compared up to it): "
          f"{ {int(c): int(stop[c]) for c in np.nonzero(~whole)[0]} }; "
          f"max |kernel - plain| {errs}")
    return max(errs.values())


def kernel_vs_plain():
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
    err32 = _compare(ps_k, out_k, ps_r, out_r, "32 ch x 1000 epochs")
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
    err4 = _compare(ps_k4, out_k4, ps_r4, out_r4, "4 ch x 1000 epochs")

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
    return max(err32, err4), times


def main_path():
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    t0 = time.perf_counter()
    sc = fix_scenario(num_epochs=29_000)
    print(f"[main] simulated {len(sc.samples) / 2.046e6:.1f} s of "
          f"{len(sc.prns)}-satellite baseband ({sc.samples.nbytes / 1e6:.0f}"
          f" MB) in {time.perf_counter() - t0:.1f} s")
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000)
    rx = Receiver(cfg, device="cuda")
    ts.track_scan_cuda.launches = 0
    ts.track_scan_reference.calls = 0
    t0 = time.perf_counter()
    report = rx.run(sc.samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ts.track_scan_cuda.launches
    plain_runs = ts.track_scan_reference.calls
    blocks = rx.profiler.stages["track"].calls
    print(f"[main] Receiver.run: {wall:.2f} s wall for "
          f"{report.epochs_processed} epochs ({blocks} tracking blocks); "
          f"kernel launches {launches}, plain-version runs {plain_runs}")
    print(rx.profiler.report())
    for ch in report.channels:
        print(f"[main] PRN {ch.prn:2d} {ch.state_name} dop "
              f"{ch.doppler_hz:9.2f} Hz cn0 {ch.cn0_dbhz:5.1f} dBHz subframes "
              f"{ch.subframe_count} eph {ch.eph.has_full_set}")
        if not ch.eph.has_full_set:
            fail(f"PRN {ch.prn} has no full ephemeris set")
    if not report.solutions:
        fail("no position fix")
    sol = report.solutions[-1]
    err = float(np.linalg.norm(sol.rr - sc.rr_true))
    vel = float(np.linalg.norm(sol.vel))
    print(f"[main] {len(report.solutions)} solutions; final fix error "
          f"{err:.1f} m, |vel| {vel:.2f} m/s")
    if not (np.all(np.isfinite(sol.rr)) and err < 500.0 and vel < 10.0):
        fail(f"fix error {err:.1f} m / |vel| {vel:.2f} m/s out of bounds")
    if launches < blocks or plain_runs != 0:
        fail(f"main path bypassed the kernel: {launches} launches for "
             f"{blocks} blocks, {plain_runs} plain-version runs")
    return launches


def main():
    sys.path.insert(0, HERE)
    import stm32f4_sdr_gps_torch

    pkg_dir = os.path.dirname(os.path.abspath(stm32f4_sdr_gps_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"stm32f4_sdr_gps_torch imported from {pkg_dir}, not from this "
             "checkout")
    name, smi = card()
    build()
    max_err, times = kernel_vs_plain()
    launches = main_path()
    kernels = {"kernels": [{
        "name": "track_scan",
        "route": "cuda",
        "source": "stm32f4_sdr_gps_torch/csrc/track_scan.cu",
        "replaces": "stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py:179",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["4ch"][0],
        "plain_ms": times["4ch"][1],
        "ms_32ch": times["32ch"][0],
        "plain_ms_32ch": times["32ch"][1],
    }]}
    import torch

    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
