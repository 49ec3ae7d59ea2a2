"""The kernels' times on the card, for one or more checkouts of this
repository, in turns.

    python stm32f4_sdr_gps_torch/probes/scan_time.py ROOT [ROOT ...]

For each ROOT in the order given (parent, change, change, parent to
compare two commits on one card), a fresh process imports
``stm32f4_sdr_gps_torch`` from ROOT, builds that checkout's kernels and
times

* K1 in the default mode on :func:`k1_scenario` at 32, 4, 128 and 256
  channels (the 128 and 256 by tiling the 32 channels' state planes and
  code rows 4 and 8 times, :func:`tiled`): the median over 5 runs of 20
  back-to-back launches per 1000-epoch block, timed with CUDA events,
  and the channels per block (G) where the checkout reports it;
* K2 on one seeded epoch at 4 and 32 channels: device time per call, 500
  calls queued behind a device sleep (``probes/common.queued_ms``);
* the per-epoch half-chip loop with K2 (``track_block`` with
  ``use_pallas=True, in_kernel_scan=False``) on :func:`k1_scenario`:
  seconds of host clock for its 1000 epochs, ending in a synchronize;
* P5, both variants at T = 1600 on the probe's inputs: device time per
  launch, 10 launches queued behind a device sleep;
* P7 and P8, every variant at full size (G = 128) on the probes' inputs
  at 32 and 4 channels: ns per iteration (the probes' ``ns_per_iter``,
  launches queued behind a device sleep), after a warm-up;
* P6, its fma variants at the tool's size (C = 32, K = 64, G = 128): ns
  per iteration the same way, and the SM clock that ``nvidia-smi`` reads
  while the chains run (:func:`sm_clocks_under`);
* P1-P4, every case on the tools' inputs at 8, 32 and 128 rows: device
  time per launch in us, 20 launches queued behind a device sleep.

Prints one JSON line per run and the card's ``nvidia-smi`` name and power
limit; exits 1 without a card.  Run as a script, the file imports the package only from ROOT, so
it also times checkouts that predate it.  chip_smoke.py and
probes/scan_parts.py build their K1 scenarios with :func:`k1_scenario`
and :func:`tiled` too.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


CIB = 3                       # codes per nav bit in the K1 scenario
CHANNELS = (32, 4, 128, 256)  # the channel counts timed


def k1_scenario(device):
    """K1's 32-channel scenario: PRNs 1-32 at 48 dBHz, seeded Doppler and
    code phase, CIB codes per bit, 1000 epochs.  Returns the initial
    TrackState (0.1 chip and 15 Hz off the truth), the (1000, 2046)
    complex64 epochs and the (32, 4352) code rows, on ``device``.  Imports
    the package by its absolute name: under ``--one ROOT``, ROOT's."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
    from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
    from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
    from stm32f4_sdr_gps_torch.track.state import init_state

    prns = list(range(1, 33))
    rng = np.random.default_rng(7)
    sats = [SimSat(prn=p, doppler_hz=float(rng.uniform(-4000, 4000)),
                   code_phase_chips=float(rng.uniform(0, 1023)),
                   cn0_dbhz=48.0, codes_in_bit=CIB,
                   nav_bits=rng.integers(0, 2, 400)) for p in prns]
    x_np, _ = simulate_capture(sats, num_epochs=1000, seed=7)
    x = torch.as_tensor(x_np.reshape(1000, 2046), device=device)
    u2 = torch.as_tensor(upsampled_code_doubled(ca_table_bipolar(prns)),
                         device=device)
    st = init_state(len(prns),
                    np.array([s.code_phase_chips + 0.1 for s in sats]),
                    np.array([s.doppler_hz + 15.0 for s in sats]),
                    device=device)
    return st, x, u2


def tiled(ps, u2, c):
    """The first ``c`` channels of the scan state ``ps`` (a ScanState of
    the 32-channel scenario) and its code rows ``u2``, tiled as often as
    ``c`` needs: channel j is channel j mod 32."""
    reps = -(-c // u2.shape[0])
    planes = [t.repeat(1, reps)[:, :c].contiguous() for t in ps]
    return type(ps)(*planes), u2.repeat(reps, 1)[:c].contiguous()


def _block_ms(launch) -> float:
    """Median over 5 runs of 20 back-to-back launches, per launch (ms),
    after 20 launches that warm the clocks."""
    import torch

    for _ in range(20):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    return statistics.median(times)


def _time_one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import stm32f4_sdr_gps_torch as pkg
    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.ops import kernel_lib
    from stm32f4_sdr_gps_torch.ops import track_scan as ts

    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != root:
        raise RuntimeError(f"imported {pkg.__file__}, not from {root}")
    st, x, u2 = k1_scenario(torch.device("cuda"))
    cfg = TrackConfig(codes_in_bit=CIB)
    ps = ts.state_from_track_state(st)
    res = {"root": root}
    lib = kernel_lib.cuda_lib() if hasattr(ts, "channels_per_block") else None
    for c in CHANNELS:
        sub, table = tiled(ps, u2, c)
        res[f"ms_{c}ch"] = _block_ms(lambda: ts.track_scan_cuda(
            sub, x, table, BASEBAND_PLAN, cfg))
        if lib is not None:
            res[f"G_{c}ch"] = lib.track_scan_channels_per_block(c)
    res.update(_k2_times(x[0], u2))
    res.update(_loop_s(st, x, u2))
    res.update(_p5_times())
    res.update(_forest_times())
    res.update(_chain_times())
    res.update(_roll_times())
    return res


def _k2_times(epoch, u2) -> dict:
    """K2's device time per call (ms) at 4 and 32 channels on one epoch,
    at seeded code phases, Dopplers and carrier phases."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.probes.common import queued_ms

    rng = np.random.default_rng(9)
    res = {}
    for c in (4, 32):
        cp, dop, ph = (torch.as_tensor(a, device=u2.device) for a in (
            rng.uniform(0, 1023, c).astype(np.float32),
            rng.uniform(-5000, 5000, c).astype(np.float32),
            rng.uniform(0, 1, c).astype(np.float32)))
        table = u2[:c].contiguous()

        def call():
            return epl.epl_correlate_cuda(epoch, table, cp, dop, ph,
                                          BASEBAND_PLAN.sample_rate_hz)

        for _ in range(500):
            call()
        res[f"k2_ms_{c}ch"] = queued_ms(call, 5, 500)
    return res


def _loop_s(st, x, u2) -> dict:
    """Seconds of host clock for the per-epoch half-chip loop with K2 over
    the scenario's 1000 epochs at 32 channels (after 20 epochs that warm
    it up)."""
    import time

    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.track.scan import track_block

    cfg = TrackConfig(codes_in_bit=CIB, use_pallas=True,
                      in_kernel_scan=False)
    track_block(st, x[:20], u2, BASEBAND_PLAN, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    track_block(st, x, u2, BASEBAND_PLAN, cfg)
    torch.cuda.synchronize()
    return {"loop_s_32ch": time.perf_counter() - t0}


def _p5_times() -> dict:
    """P5's device time per launch (ms) at T = 1600, both variants."""
    import torch

    from stm32f4_sdr_gps_torch.probes import corr_bank as cb
    from stm32f4_sdr_gps_torch.probes.common import queued_ms

    res = {}
    for variant, args in cb.device_inputs(torch.device("cuda")).items():
        fn = cb.KERNELS[variant]
        for _ in range(20):
            fn(*args, 1600)
        res[f"p5_{variant}_ms"] = queued_ms(lambda: fn(*args, 1600), 5, 10,
                                            20_000_000)
    return res


def _forest_times() -> dict:
    """P7's and P8's ns per iteration per variant at G = 128, 32 and 4
    channels, on the probes' inputs."""
    import torch

    from stm32f4_sdr_gps_torch.probes import forest_constructs as p7
    from stm32f4_sdr_gps_torch.probes import forest_layout as p8
    from stm32f4_sdr_gps_torch.probes.common import warm_up

    res = {}
    for c in (32, 4):
        x = torch.as_tensor(p7.probe_inputs(c), device="cuda")
        warm_up(lambda: p7.constructs_cuda(x, "base", p7.G))
        for v in p7.VARIANTS:
            res[f"p7_{v}_ns_{c}ch"] = p7.ns_per_iter(v, x)
        for v in p8.VARIANTS:
            if p8.supports(v, c):
                x8, w8 = (torch.as_tensor(a, device="cuda")
                          for a in p8.probe_inputs(v, c))
                res[f"p8_{v}_ns_{c}ch"] = p8.ns_per_iter(v, x8, w8)
    return res


def sm_clocks_under(launch, seconds: float = 1.5) -> dict:
    """The SM clock in MHz (median, min and max of ``nvidia-smi`` samples
    every 100 ms) and its maximum, read while ``launch`` runs back to back
    on the card for ``seconds`` (after 0.3 s that raise the clocks)."""
    import time

    import torch

    from stm32f4_sdr_gps_torch.probes.common import warm_up

    warm_up(launch)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=30)[0]
    samples = [[float(v) for v in line.split(",")]
               for line in text.splitlines() if line.count(",") == 1]
    if not samples:
        raise RuntimeError("nvidia-smi gave no clock samples")
    sm = [s for s, _ in samples]
    return {"sm_mhz": statistics.median(sm), "sm_mhz_min": min(sm),
            "sm_mhz_max": max(sm), "sm_max_mhz": samples[-1][1],
            "samples": len(sm)}


def _chain_times() -> dict:
    """P6's fma variants: ns per iteration at the tool's size, and the SM
    clock while c1_fma runs."""
    import torch

    from stm32f4_sdr_gps_torch.probes import forest_chain as p6
    from stm32f4_sdr_gps_torch.probes.common import warm_up

    res = {}
    for v in [v for v in p6.VARIANTS if v.endswith("_fma")]:
        x = torch.as_tensor(p6.probe_inputs(v, p6.C), device="cuda")
        warm_up(lambda: p6.chain_cuda(x, v, p6.K, p6.G))
        res[f"p6_{v}_ns"] = p6.ns_per_iter(v, x, p6.K, p6.G)
    x = torch.as_tensor(p6.probe_inputs("c1_fma", p6.C), device="cuda")
    res["p6_clocks"] = sm_clocks_under(
        lambda: p6.chain_cuda(x, "c1_fma", p6.K, p6.G))
    return res


def _roll_times() -> dict:
    """P1-P4: each case's device time per launch (us) on the tools'
    inputs at 8, 32 and 128 rows."""
    import torch

    from stm32f4_sdr_gps_torch.probes import mosaic_bisect, roll_wide
    from stm32f4_sdr_gps_torch.probes.common import (SLEEP_CYCLES,
                                                     queued_ms, warm_up)

    res = {}
    for mod in (roll_wide, mosaic_bisect):
        for case in mod.CASES:
            fn = mod.KERNELS[case]
            for rows in (8, 32, 128):
                args = mod.check_args(case, "probe", "cuda", rows)
                out = fn(*args)
                warm_up(lambda: fn(*args, out=out), 0.1)
                res[f"{case}_us_{rows}rows"] = queued_ms(
                    lambda: fn(*args, out=out), 5, 20, SLEEP_CYCLES) * 1e3
    torch.cuda.synchronize()
    return res


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        print(json.dumps(_time_one(argv[2])))
        return 0
    if len(argv) < 2:
        print(f"usage: {argv[0]} ROOT [ROOT ...]", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("scan_time: needs a CUDA device", file=sys.stderr)
        return 1
    for root in argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
