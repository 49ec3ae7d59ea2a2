"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
before the result line):

1. card: the device name and ``nvidia-smi`` name/power-limit line;
2. build: the five kernel libraries from csrc/ with nvcc, one nvcc each,
   all started together (build seconds and ptxas lines): the tracking
   scan (K1), the per-epoch E/P/L correlator (K2), the correlator-bank
   probe (P5), the epoch-cost probes (P6-P8) and the roll probes (P1-P4);
   fails unless ptxas reports all 8 instantiations of K1's
   track_scan_kernel, and every kernel of the P5 and K2 libraries, with
   0 bytes of stack frame and no spills (their registers, stack and
   spills go into the kernels line);
3. K1 vs its plain version on the card: the tracking scan on 32 channels
   (PRNs 1-32 at 48 dBHz, seeded Doppler and code phase, 3 codes per
   bit) over 1000 epochs, and on the main path's 4-channel shape, held to
   its plain torch version with the tolerances of
   tests/test_pallas_scan.py:68-117 and exact integer decisions (each
   channel up to its first prompt-sign decision that lies within float32
   summation error of zero, see MARGINAL_IP); a 500 + 500 split must
   equal the full run; 256 channels (the 32 channels' state planes and
   code rows tiled 8 times, so K1 groups G > 1 channels per block) must
   equal the 32-channel run channel for channel (c against c mod 32),
   bit for bit, and hold to the plain version; median block times from
   CUDA events (the kernel over 20 back-to-back launches) at 4, 32, 128
   and 256 channels, with each one's G; then K1 in each of its other
   modes (coherent_bit_vote, coherent_pll, coherent_pll with
   pll_ext_bits = 5, emit_correlators) on the 32-channel scenario under
   the same rules, the E/L slots under the I/Q tolerance, with its block
   time in each, and coherent_bit_vote also at the main path's 4 channels
   (phase 4b's instantiation at its shape);
4. K1 main path: ``Receiver.run`` on the card from cold start to a
   position fix on a 29 s, 4-satellite capture with real 20 ms nav bits
   at 48 dBHz; the fix must be within 500 m of the planted position, and
   every tracking block must have gone through the kernel;
4b. the same with ``TrackConfig(coherent_bit_vote=True)``: grid-locked
   bit sync and the coherent bit decision, through K1;
5. K2 vs its plain version on the card, one epoch: 4, 32 and 128
   channels at random phases and at the code-phase wrap edges of
   tests/test_pallas.py:57, rtol 1e-4 / atol 1e-3 on the sums (summation
   order, and sincospif vs cos/sin(2 pi .)); at 4 and 32 channels the
   device time per call (calls queued behind a device sleep) beside the
   launch floor (``torch.cuda._sleep(1)``, a near-empty kernel, queued
   the same way), and the time per call over 1000 back-to-back calls,
   host included;
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
   sum); the kernels' times beside the one-call yardsticks
   (``probes/corr_bank.library_call``: ``torch.bmm`` in float32 for fma;
   for mma a bf16 ``torch.matmul`` over the yr_t and yi rows of every
   step, the kernel's work, and over the yr_t rows alone, half the
   work), each yardstick's result checked against the plain version
   within its output rounding; kernels and yardsticks timed as device
   time per call, 10 calls queued behind a device sleep; then the
   probe's entry point, which prints ns per step (a launch's time over
   its T steps);
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
   every kernel;
10. P1-P4, every case (P1 at 4352 and 2176 lanes, both signs; P2; P3;
   P4 both signs) at 8, 32 and 128 rows on the tools' inputs and on
   seeded ones, held to its plain version bit for bit; the device time
   per launch (queued) beside the plain version's and that of the one
   torch.gather that computes the same (the yardstick); then the two
   entry points, roll_wide and mosaic_bisect, each with every stage.
   The kernels line has one record per kernel wrapper (P1's four cases
   share dyn_roll_cuda, P4's two roll_cuda), each case's numbers inside.

Every kernel's record carries its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over the peak rate of their type
(67 TFLOP/s float32, 989 TFLOP/s bf16 on the tensor cores), the H100 SXM
data sheet's figures at 700 W, from this run's shapes.  The
second-to-last stdout line is the kernels' JSON record, the last the
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
            "forest_cuda": kernel_lib.forest_lib,
            "roll_cuda": kernel_lib.roll_lib}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(fn) for fn in libs.values()]:
            fut.result()
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.2f}"
          " s wall (one nvcc each, in parallel)")
    for name in libs:
        info = kernel_lib.build_info[name]
        print(f"[build] {name} built in {info['seconds']:.2f} s"
              + (" (cached)" if info["cached"] else ""))
        for line in info["log"].splitlines():
            print(f"[build]   {line}")
    k1 = kernel_lib.ptxas_report(kernel_lib.build_info["track_scan_cuda"]
                                 ["log"], "track_scan_kernel")
    bad = [k for k in k1 if k["stack"] or k["spill_stores"]
           or k["spill_loads"]]
    if len(k1) != 8 or bad:
        fail(f"K1: ptxas reports {len(k1)} of 8 track_scan_kernel "
             f"instantiations, {len(bad)} with a stack frame or spills: {bad}")
    regs = sorted({k["registers"] for k in k1})
    print(f"[build] K1: all 8 track_scan_kernel instantiations with 0 bytes "
          f"of stack frame and no spills; registers {regs}")
    ptxas = {"track_scan": _ptxas_record(k1)}
    for lib, kernels in (("epl_cuda", {"epl": "epl_kernel"}),
                         ("corr_bank_cuda", {"corr_bank_fma": "fma_kernel",
                                             "corr_bank_mma": "mma_kernel"})):
        log = kernel_lib.build_info[lib]["log"]
        every = kernel_lib.ptxas_report(log, "")
        bad = [k for k in every if k["stack"] or k["spill_stores"]
               or k["spill_loads"]]
        if not every or bad:
            fail(f"{lib}: ptxas reports {len(every)} kernels, with a stack "
                 f"frame or spills: {bad}")
        for name, kernel in kernels.items():
            rec = kernel_lib.ptxas_report(log, kernel)
            if len(rec) != 1:
                fail(f"{lib}: ptxas reports {len(rec)} entries named {kernel}")
            ptxas[name] = _ptxas_record(rec)
        print(f"[build] {lib}: {len(every)} kernels with 0 bytes of stack "
              f"frame and no spills; registers "
              f"{ {k['name']: k['registers'] for k in every} }")
    # ptxas warns when it has to serialise the mma kernel's wgmmas
    ptxas["wgmma_serialized"] = "serialized" in kernel_lib.build_info[
        "corr_bank_cuda"]["log"]
    return ptxas


def _ptxas_record(report):
    """The largest registers, stack and spill bytes over ptxas entries."""
    return {"registers": max(k["registers"] for k in report),
            "stack_bytes": max(k["stack"] for k in report),
            "spill_bytes": max(k["spill_stores"] + k["spill_loads"]
                               for k in report)}


# The H100 SXM data sheet's peaks at 700 W (dense, without sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
# K1's float32 operations per sample and channel: the carrier angle (a
# multiply, an add, the floor and its subtraction, the doubling: 5),
# sincospif counted as 2, the rotation (4 multiplies, 2 adds) and the six
# multiply-adds (12)
K1_OPS_PER_SAMPLE = 25


def bound(nbytes, ops=0.0, peak=PEAK_FP32):
    """(bound_ms, bound_by): the least time for the work, the larger of
    the bytes over the memory rate and the operations over the peak
    rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_bound(t_cnt, c, nout=11, win=4):
    """K1's bound for one block: the epochs, the code rows and the state
    read once, the outputs and the state written once; 25 float32
    operations per sample and channel."""
    state = (16 + 14 + win) * c * 4
    nbytes = t_cnt * 2046 * 8 + c * 4352 * 4 + 2 * state + t_cnt * nout * c * 4
    return bound(nbytes, t_cnt * c * 2046 * K1_OPS_PER_SAMPLE)


def k2_bound(c):
    """K2's bound for one epoch: the epoch, the code rows, three state
    rows in, (C, 3) complex64 out."""
    return bound(2046 * 8 + c * 4352 * 4 + 3 * c * 4 + c * 3 * 8,
                 c * 2046 * K1_OPS_PER_SAMPLE)


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


def _compare(st_k, out_k, st_r, out_r, label, coherent=False):
    """Kernel (k) vs plain version (r) on one run of a tracking loop: the
    tolerances of tests/test_pallas_scan.py:68-117 on the floats and exact
    integer decisions, for every channel up to its first marginal
    prompt-sign decision (see MARGINAL_IP); a channel without one must
    also end in the same integer state, and at most one channel in eight
    (at least one) may have such a decision.  With ``coherent`` (the
    coherent bit decision of coherent_bit_vote and coherent_pll) a
    bit_value slot whose running prompt-I sum, over the n epochs since the
    last bit boundary, lies within n * MARGINAL_IP of zero is such a
    decision too; the run must start at epoch 0.  ``st_*`` are final
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
    bit_sums = {}
    if coherent:
        # every epoch's bit_value slot is the sign of the running prompt-I
        # sum of the synced epochs since the last bit boundary (the last
        # epoch with bit_ready before it), ready or not
        ready = r["bit_ready"] > 0
        for t, c in zip(*np.nonzero(r["bit_value"] != k["bit_value"])):
            prev = np.nonzero(ready[:t, c])[0]
            be = int(prev[-1]) if prev.size else 0
            ks, rs = (float(np.where(o["period_sync_ok"][be:t, c] > 0,
                                     o["ip"][be:t, c], 0.0).sum())
                      for o in (k, r))
            if min(abs(ks), abs(rs)) < MARGINAL_IP * max(t - be, 1):
                marginal[t, c] = True
                bit_sums.setdefault(int(c), (int(t), ks, rs))
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
    if r["ie"].size:
        for name in ("ie", "qe", "il", "ql"):
            check(name, 2e-2, 2.0)
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
          + (f"coherent bit sums there (epoch, kernel, plain) {bit_sums}; "
             if bit_sums else "")
          + f"max |kernel - plain| {errs}")
    return max(errs.values())


def _compare_scan(ps_k, out_k, ps_r, out_r, label, coherent=False):
    """_compare on two runs of the tracking-scan kernel's slot streams."""
    from stm32f4_sdr_gps_torch.ops.track_scan import outputs_from_raw

    return _compare(ps_k, outputs_from_raw(out_k), ps_r,
                    outputs_from_raw(out_r), label, coherent)


def kernel_vs_plain():
    """K1 against its plain version; returns the max error, the block
    times and the 32-channel scenario (state, epochs, codes) on the
    card."""
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes.scan_time import CIB, k1_scenario, tiled

    plan, cib = BASEBAND_PLAN, CIB
    t0 = time.perf_counter()
    st, x, u2 = k1_scenario(torch.device("cuda"))
    n_ep = x.shape[0]
    print(f"[kernel] simulated {u2.shape[0]} satellites x {n_ep} epochs in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = TrackConfig(codes_in_bit=cib)
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
    # the coherent_bit_vote instantiation at the main path's shape (phase 4b)
    cbv = TrackConfig(codes_in_bit=cib, **K1_MODES["coherent_bit_vote"])
    ps_k4, out_k4 = ts.track_scan_cuda(sub, x, u2_4, plan, cbv)
    ps_r4, out_r4 = ts.track_scan_reference(sub, x, u2_4, plan, cbv)
    torch.cuda.synchronize()
    err4 = max(err4, _compare_scan(ps_k4, out_k4, ps_r4, out_r4,
                                   "K1 coherent_bit_vote 4 ch x 1000 epochs",
                                   coherent=True))

    # 256 channels: the 32 tiled 8 times, G > 1 channels per block; every
    # channel must be its 32-channel original, bit for bit
    groups = {c: ts.channels_per_block(c) for c in (4, 32, 128, 256)}
    if groups[4] != 1 or groups[32] != 1 or groups[256] < 2:
        fail(f"K1 channels per block {groups}: want 1 at 4 and 32, > 1 at "
             "256")
    big, u2_256 = tiled(ps0, u2, 256)
    ps_kb, out_kb = ts.track_scan_cuda(big, x, u2_256, plan, cfg)
    torch.cuda.synchronize()
    if not (torch.equal(out_kb, out_k.repeat(1, 1, 8))
            and all(torch.equal(a, b.repeat(1, 8))
                    for a, b in zip(ps_kb, ps_k))):
        fail("K1 256 ch: a channel differs from its 32-channel original")
    print(f"[kernel] 256 ch (G = {groups[256]}) == the 32-channel run tiled "
          "8 times, bit for bit")
    ps_rb, out_rb = ts.track_scan_reference(big, x, u2_256, plan, cfg)
    torch.cuda.synchronize()
    err256 = _compare_scan(ps_kb, out_kb, ps_rb, out_rb,
                           "K1 256 ch x 1000 epochs")

    times = {}
    for c in (4, 32, 128, 256):
        state, table = tiled(ps0, u2, c)
        ts.track_scan_cuda(state, x, table, plan, cfg)       # warm-up
        k_ms = _median_ms(
            lambda: ts.track_scan_cuda(state, x, table, plan, cfg), 5, 20)
        p_ms = (_median_ms(lambda: ts.track_scan_reference(
            state, x, table, plan, cfg), 3, 1) if c <= 32 else None)
        times[c] = {"G": groups[c], "ms": k_ms, "plain_ms": p_ms,
                    "bound": k1_bound(1000, c)}
        print(f"[kernel] {c} ch x 1000 epochs (G = {groups[c]}): kernel "
              f"median {k_ms:.4f} ms"
              + (f", plain version median {p_ms:.2f} ms" if p_ms else "")
              + f" per block (CUDA events); bound {times[c]['bound'][0]:.4f}"
              f" ms ({times[c]['bound'][1]})")
    modes = {}
    for mode, change in K1_MODES.items():
        mcfg = TrackConfig(codes_in_bit=cib, **change)
        ps_k, out_k = ts.track_scan_cuda(ps0, x, u2, plan, mcfg)
        ps_r, out_r = ts.track_scan_reference(ps0, x, u2, plan, mcfg)
        torch.cuda.synchronize()
        if out_k.shape[1] != (15 if mcfg.emit_correlators else 11):
            fail(f"K1 {mode}: {out_k.shape[1]} output slots")
        err = _compare_scan(ps_k, out_k, ps_r, out_r,
                            f"K1 {mode} 32 ch x {n_ep} epochs",
                            coherent=mode != "emit_correlators")
        k_ms = _median_ms(lambda: ts.track_scan_cuda(ps0, x, u2, plan, mcfg),
                          3, 10)
        synced = int((ps_r.i32[4] == 1).sum())
        print(f"[kernel] {mode}: kernel median {k_ms:.4f} ms per block at "
              f"32 ch; {synced} of 32 channels synced at the end, K-bit "
              f"count {ps_r.i32[13].tolist()}")
        modes[mode] = {"max_abs_err": err, "ms_32ch": k_ms}
    return max(err32, err4, err256), times, (st, x, u2), modes


# K1's modes beyond the default loop (pallas_track_scan.py :613-622,
# :660-712, :738-745, :774-775, :791-794, :834-835)
K1_MODES = {
    "coherent_bit_vote": dict(coherent_bit_vote=True),
    "coherent_pll": dict(coherent_pll=True),
    "coherent_pll_ext5": dict(coherent_pll=True, pll_ext_bits=5),
    "emit_correlators": dict(emit_correlators=True),
}


def _reset_counts():
    """Every kernel's launch count and every plain version's call count
    to 0."""
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import corr_bank as cb

    for mod, _, _ in _roll_probes():
        for fn in set(mod.KERNELS.values()):
            fn.launches = 0
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
    rx = Receiver(cfg)                      # the card, by default
    if rx.device.type != "cuda":
        fail(f"{label}: Receiver(cfg) chose {rx.device}, not the card")
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
    return report, rx, counts, tracked, wall


def main_path(sc, label="main", **track):
    """K1's main path: the TrackConfig (default, or with ``track``) on the
    card; returns K1's launches, the final fix error (m), the wall time
    (s) and the mean ``track`` stage per block (ms)."""
    import numpy as np

    from stm32f4_sdr_gps_torch.config import TrackConfig

    report, rx, counts, _, wall = _run_receiver(sc, TrackConfig(**track),
                                                label)
    blocks = rx.profiler.stages["track"].calls
    if (counts["track_scan"] < blocks or counts["track_scan_plain"]
            or counts["epl"] or counts["epl_plain"]):
        fail(f"{label} path bypassed the tracking-scan kernel: {counts} for "
             f"{blocks} blocks")
    err = float(np.linalg.norm(report.solutions[-1].rr - sc.rr_true))
    return (counts["track_scan"], err, wall,
            rx.profiler.stages["track"].mean_s * 1e3)


WRAP_EDGES = (0.0, 0.2, 0.49, 0.51, 1022.6, 1022.99)


def epl_vs_plain():
    """K2 against its plain version on one epoch; returns the max error
    and the per-call times (kernel, plain) at 4 and 32 channels."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.probes.common import queued_ms, warm_up
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

        warm_up(kernel)
        plain()
        k_dev = queued_ms(kernel, 3, 500)
        floor = queued_ms(lambda: torch.cuda._sleep(1), 3, 500)
        p_dev = queued_ms(plain, 3, 30)
        k_ms = _median_ms(kernel, 3, 1000)
        p_ms = _median_ms(plain, 3, 1000)
        times[c] = {"ms": k_dev, "plain_ms": p_dev, "floor_ms": floor,
                    "call_ms": k_ms, "plain_call_ms": p_ms}
        print(f"[epl] {c} ch: device time per call (queued ahead) kernel "
              f"{k_dev * 1e3:.3f} us, launch floor (an empty kernel) "
              f"{floor * 1e3:.3f} us, plain version {p_dev * 1e3:.2f} us; "
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

    _, _, counts, tracked, _ = _run_receiver(
        sc, TrackConfig(use_pallas=True, in_kernel_scan=False), "half-chip")
    if (counts["epl"] != tracked or counts["epl_plain"]
            or counts["track_scan"] or counts["track_scan_plain"]):
        fail(f"half-chip main path: counts {counts} for {tracked} tracked "
             "epochs (want one K2 launch per epoch and nothing else)")
    return counts["epl"]


def corr_bank():
    """P5: both variants against their plain versions, the kernels' times
    beside the one-call yardsticks, then the probe's entry point
    (launches counted there)."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.probes import corr_bank as cb
    from stm32f4_sdr_gps_torch.probes.common import (SLEEP_CYCLES, queued_ms,
                                                     warm_up)

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
        warm_up(lambda: cb.KERNELS[variant](*args, steps))
        k_ms = queued_ms(lambda: cb.KERNELS[variant](*args, steps), 5, 10,
                         SLEEP_CYCLES)
        p_ms = _median_ms(lambda: cb.PLAIN[variant](*args, steps), 3, 1)
        print(f"[p5] {variant}: max |kernel - plain| {err:.4g} (tolerance "
              f"{tol:.4g}, |sums| up to {np.abs(w).max():.1f}); kernel "
              f"{k_ms:.4f} ms, plain version {p_ms:.2f} ms per {steps} steps")
        res[variant] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "want": want}
    # the yardsticks: every step's products in one torch call, the stacked
    # inputs built outside the timed call; each checked against the plain
    # version within its output rounding (bf16 for mma: 2^-9 of each
    # product, two products a channel and step)
    for lib in cb.LIBRARY:
        variant = "fma" if lib == "fma" else "mma"
        args = inputs[variant]
        call = cb.library_call(lib, args, steps)
        out = call()
        if lib != "mma_yr":
            tot = cb.library_totals(variant, out, args[3] if variant == "mma"
                                    else None, steps)
            w = res[variant]["want"].double()
            diff = float((tot - w).abs().max())
            tol = (1e-4 * float(w.abs().max()) if variant == "fma"
                   else 2 * steps * 2.0 ** -9 * float(out.float().abs().max()))
            if diff > tol:
                fail(f"P5 yardstick {lib}: max |library - plain| {diff} > "
                     f"{tol}")
        ms = queued_ms(call, 5, 10, SLEEP_CYCLES)
        key = "library_ms" if lib != "mma_yr" else "library_yr_ms"
        res[variant][key] = ms
        what = {"fma": "torch.bmm float32 (TF32 off)",
                "mma": "torch.matmul bf16, yr_t and yi rows (same work)",
                "mma_yr": "torch.matmul bf16, yr_t rows only (half the "
                          "work)"}[lib]
        print(f"[p5] yardstick {lib}: {what} over all {steps} steps "
              f"{ms:.4f} ms" + (f"; agrees with the plain version within "
                                f"{diff:.4g} (tolerance {tol:.4g})"
                                if lib != "mma_yr" else ""))
        del call, out
        torch.cuda.empty_cache()
    for variant in ("fma", "mma"):
        del res[variant]["want"]
        r = res[variant]
        print(f"[p5] {variant}: kernel {r['ms']:.4f} ms against the "
              f"same-work yardstick {r['library_ms']:.4f} ms: the "
              f"{'kernel' if r['ms'] < r['library_ms'] else 'yardstick'} "
              "wins")
    c, sp, n = cb.C, cb.SP, cb.N
    res["fma"]["bound"] = bound(_nbytes(*inputs["fma"]) + c * 4,
                                steps * c * sp * 13)
    res["mma"]["bound"] = bound(_nbytes(*inputs["mma"]) + c * 4,
                                steps * 2 * 2 * c * sp * n, PEAK_BF16)
    _reset_counts()
    for variant in ("fma", "mma"):
        res[variant]["ns_per_step"] = cb.run(variant, steps)
    for variant in ("fma", "mma"):
        res[variant]["launches"] = cb.KERNELS[variant].launches
        if res[variant]["launches"] == 0:
            fail(f"P5 {variant}: the probe's entry point launched nothing")
    print(f"[p5] per step at 32 channels (a launch's time over its steps): "
          f"vector sums (fma) {res['fma']['ns_per_step']:.1f} ns, tensor-core"
          f" products (mma) {res['mma']['ns_per_step']:.1f} ns")
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
        t_bytes = t_ops = 0.0
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
            outs = kernel(*args)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += list(outs if isinstance(outs, tuple) else (outs,))
            t_bytes += bound(_nbytes(*tensors))[0]
            t_ops += bound(0, _forest_ops(name, v, args))[0]
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
                     "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "library_ms": None, "check_ms": check_ms}

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


def _forest_ops(name, variant, args):
    """float32 operations of one P6-P8 launch (a fused multiply-add counts
    2; P7 counts its two fma pairs per iteration, not the construct; a
    barrel stage is a copy)."""
    if name == "forest_chain":
        x, _, k, g = args
        pairs = k // 4 if variant.startswith("ilp") else k
        per_pair = {"fma": 4, "sel": 8, "int": 6}[variant.split("_")[1]]
        return x.numel() // 2 * pairs * per_pair * g * 8
    if name == "forest_constructs":
        x, _, g = args
        return x.shape[1] * g * 8 * 8
    x, w, _, g = args
    c = x.numel() // 8
    per_iter = {"tr6": 7 * c, "tr2": 3 * c, "wide": 28 * w.numel(),
                "red": 18 * w.numel(), "roll": c}
    return per_iter[variant if variant.startswith("tr")
                    else variant.split("_")[0]] * g * 8


def _roll_probes():
    """(module, its cases, P-numbers) of the roll probes."""
    from stm32f4_sdr_gps_torch.probes import mosaic_bisect, roll_wide

    return ((roll_wide, roll_wide.CASES, "P1-P3"),
            (mosaic_bisect, mosaic_bisect.CASES, "P4"))


def _roll_nbytes(case, args, outs):
    """The bytes a P1-P4 case must move: its amounts and outputs, and of
    its input plane what the kernel reads: row 0 for P2 (statwin), WIN
    lanes of each u2 row for P3 (the barrel's rebuild), all of it for the
    row rolls."""
    from stm32f4_sdr_gps_torch.probes.roll_wide import WIN

    x = args[0]
    read = {"statwin": x.shape[1], "barrel": x.shape[0] * WIN}.get(
        case, x.numel()) * x.element_size()
    return read + _nbytes(*args[1:], *outs)


def roll_probes():
    """P1-P4: every case against its plain version bit for bit at 8, 32
    and 128 rows on the tools' inputs and on seeded ones; device time per
    launch (queued) beside the plain version and the one-call gather; then
    the two entry points (launches counted there, per kernel wrapper).
    Returns the per-(case, rows) times and bounds, each case's max
    |kernel - plain| and each wrapper's launches."""
    import torch

    from stm32f4_sdr_gps_torch.probes import roll_wide
    from stm32f4_sdr_gps_torch.probes.common import (SLEEP_CYCLES, queued_ms,
                                                     warm_up)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    args = roll_wide.check_args("dynu2_pos", "probe", dev, 128)
    warm_up(lambda: roll_wide.dyn_roll_cuda(*args))
    res, errs = {}, {}
    for mod, cases, _ in _roll_probes():
        for case in cases:
            kernel, plain = mod.KERNELS[case], mod.PLAIN[case]
            errs[case] = 0.0
            for rows in (8, 32, 128):
                for which in ("probe", "seeded"):
                    args = mod.check_args(case, which, dev, rows)
                    got, want = kernel(*args), plain(*args)
                    lib = roll_wide.library_call(case, args)()
                    torch.cuda.synchronize()
                    got, want = ((t if isinstance(t, tuple) else (t,))
                                 for t in (got, want))
                    errs[case] = max([errs[case]] + [
                        float((g.double() - w.double()).abs().max())
                        for g, w in zip(got, want)])
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        fail(f"{case} at {rows} rows ({which} inputs): the "
                             "kernel differs from its plain version")
                    if not torch.equal(lib, torch.stack(want).reshape(
                            lib.shape)):
                        fail(f"{case} at {rows} rows ({which} inputs): the "
                             "gather yardstick differs from the plain version")
                args = mod.check_args(case, "probe", dev, rows)
                out = kernel(*args)
                lib = roll_wide.library_call(case, args)
                k_ms = queued_ms(lambda: kernel(*args, out=out), 5, 20,
                                 SLEEP_CYCLES)
                l_ms = queued_ms(lib, 5, 20, SLEEP_CYCLES)
                p_ms = _median_ms(lambda: plain(*args), 3, 1)
                outs = out if isinstance(out, tuple) else (out,)
                b_ms, b_by = bound(_roll_nbytes(case, args, outs))
                res[case, rows] = {"ms": k_ms, "plain_ms": p_ms,
                                   "library_ms": l_ms, "bound_ms": b_ms,
                                   "bound_by": b_by}
                print(f"[roll] {case:10s} {rows:3d} rows x "
                      f"{args[0].shape[1]} lanes: bit for bit on both input "
                      f"sets; kernel {k_ms * 1e3:.2f} us per launch (queued), "
                      f"gather {l_ms * 1e3:.2f} us, plain version "
                      f"{p_ms:.3f} ms; bound {b_ms * 1e6:.1f} ns ({b_by})")
    _reset_counts()
    for mod, _, pn in _roll_probes():
        name = mod.__name__.rsplit(".", 1)[1]
        rc = mod.main([name, "all"])
        if rc != 0:
            fail(f"{name} ({pn}) exited {rc}")
    launches = {fn.__name__: fn.launches for mod, _, _ in _roll_probes()
                for fn in set(mod.KERNELS.values())}
    if not all(launches.values()):
        fail(f"the roll entry points left a kernel unlaunched: {launches}")
    print(f"[roll] phase 10 in {time.perf_counter() - t0:.1f} s; max |kernel"
          f" - plain| {errs}; launches in the entry points {launches}")
    return res, errs, launches


def main():
    sys.path.insert(0, HERE)
    import stm32f4_sdr_gps_torch

    pkg_dir = os.path.dirname(os.path.abspath(stm32f4_sdr_gps_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"stm32f4_sdr_gps_torch imported from {pkg_dir}, not from this "
             "checkout")
    name, smi = card()
    ptxas = build()
    k1_err, k1_times, scenario, k1_modes = kernel_vs_plain()

    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    t0 = time.perf_counter()
    sc = fix_scenario(num_epochs=29_000)
    print(f"[main] simulated {len(sc.samples) / 2.046e6:.1f} s of "
          f"{len(sc.prns)}-satellite baseband ({sc.samples.nbytes / 1e6:.0f}"
          f" MB) in {time.perf_counter() - t0:.1f} s")
    k1_launches, fix_err, wall, track_ms = main_path(sc)
    cbv_launches, cbv_err, cbv_wall, cbv_track_ms = main_path(
        sc, "main-cbv", coherent_bit_vote=True)
    k2_err, k2_times = epl_vs_plain()
    loop_err = closed_loop(scenario)
    k2_launches = half_chip_path(sc)
    p5 = corr_bank()
    forest_res = forest()
    roll_res, roll_errs, roll_launches = roll_probes()
    src = "stm32f4_sdr_gps_torch/csrc/"
    k2_b4, k2_b32 = k2_bound(4), k2_bound(32)

    def roll_entry(name, wrapper, cases, replaces):
        """One kernel wrapper's record: its launches in the entry points,
        the max error over its cases, the first case's numbers at 8 rows
        on top and every case's at 8, 32 and 128 rows under ``cases``."""
        return {
            "name": name, "route": "cuda", "source": src + "roll.cu",
            "replaces": replaces, "launches": roll_launches[wrapper],
            "max_abs_err": max(roll_errs[c] for c in cases),
            **roll_res[cases[0], 8],
            "cases": {f"{c}_{rows}rows": roll_res[c, rows]
                      for c in cases for rows in (8, 32, 128)},
        }

    kernels = {"kernels": [{
        "name": "track_scan",
        "route": "cuda",
        "source": src + "track_scan.cu",
        "replaces": "stm32f4_sdr_gps_tpu/ops/pallas_track_scan.py:179",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_times[4]["ms"],
        "plain_ms": k1_times[4]["plain_ms"],
        "bound_ms": k1_times[4]["bound"][0],
        "bound_by": k1_times[4]["bound"][1],
        "library_ms": None,
        "G": k1_times[4]["G"],
        **{f"{k}_{c}ch": v for c in (32, 128, 256)
           for k, v in (("G", k1_times[c]["G"]), ("ms", k1_times[c]["ms"]),
                        ("plain_ms", k1_times[c]["plain_ms"]),
                        ("bound_ms", k1_times[c]["bound"][0]),
                        ("bound_by", k1_times[c]["bound"][1]))
           if v is not None},
        **ptxas["track_scan"],
        "fix_error_m": fix_err,
        "main_path_wall_s": wall,
        "main_path_track_ms_per_block": track_ms,
        "modes": k1_modes,
        "coherent_bit_vote_path": {"launches": cbv_launches,
                                   "fix_error_m": cbv_err,
                                   "wall_s": cbv_wall,
                                   "track_ms_per_block": cbv_track_ms},
    }, {
        "name": "epl",
        "route": "cuda",
        "source": src + "epl.cu",
        "replaces": "stm32f4_sdr_gps_tpu/ops/pallas_epl.py:57",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "closed_loop_max_abs_err": loop_err,
        **k2_times[4],
        "bound_ms": k2_b4[0],
        "bound_by": k2_b4[1],
        "library_ms": None,
        **{f"{k}_32ch": v for k, v in k2_times[32].items()},
        "bound_ms_32ch": k2_b32[0],
        **ptxas["epl"],
    }] + [{
        "name": f"corr_bank_{v}",
        "route": "cuda",
        "source": src + "corr_bank.cu",
        "replaces": "tools/mxu_corr_probe.py:56",
        "launches": p5[v]["launches"],
        "max_abs_err": p5[v]["max_abs_err"],
        "ms": p5[v]["ms"],
        "plain_ms": p5[v]["plain_ms"],
        "bound_ms": p5[v]["bound"][0],
        "bound_by": p5[v]["bound"][1],
        "library_ms": p5[v]["library_ms"],
        **({"library_yr_ms": p5[v]["library_yr_ms"],
            "wgmma_serialized": ptxas["wgmma_serialized"]}
           if v == "mma" else {}),
        "ns_per_step": p5[v]["ns_per_step"],
        **ptxas[f"corr_bank_{v}"],
    } for v in ("fma", "mma")] + [{
        "name": name,
        "route": "cuda",
        "source": src + "forest.cu",
        **r,
    } for name, r in forest_res.items()] + [
        roll_entry("roll_dyn", "dyn_roll_cuda",
                   ["dynu2_neg", "dynu2_pos", "dynwin_neg", "dynwin_pos"],
                   "tools/tpu_roll_wide_probe.py:78"),
        roll_entry("roll_static", "statwin_cuda", ["statwin"],
                   "tools/tpu_roll_wide_probe.py:115"),
        roll_entry("barrel", "barrel_cuda", ["barrel"],
                   "tools/tpu_roll_wide_probe.py:157"),
        roll_entry("roll_256", "roll_cuda", ["roll_neg", "roll_pos"],
                   "tools/tpu_mosaic_bisect.py:76"),
    ]}
    import torch

    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
