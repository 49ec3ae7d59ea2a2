"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
before the result line):

1. card: the device name and ``nvidia-smi`` name/power-limit line;
2. build: the seven kernel libraries from csrc/ with nvcc, one nvcc
   each, all started together (build seconds and ptxas lines): the
   tracking scan (K1), the per-epoch E/P/L correlator (K2), the
   correlator-bank probe (P5), the epoch-cost probes (P6-P8), the roll
   probes (P1-P4), the handoff search (pretrack.cu) and the real-IF
   ingest (if_resample.cu, R1); fails unless ptxas reports all 8
   instantiations of K1's track_scan_kernel, and every kernel of the P5,
   K2, P6-P8, handoff and ingest libraries, with 0 bytes of stack frame
   and no spills, and the roll
   library's two kernels also with 0 bytes of shared memory and no
   barriers (their registers, stack, spills and shared memory go into
   the kernels line);
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
   launch there; the three col variants at C = 32 and 4 bit for bit
   against the host build of their decomposition (``layout_col_host``:
   the same slabs, halo and summation order); then the three entry
   points at full size (C = 32 and 4
   at G = 128, and C = 32 at G = 64 to show the time scales with G; P7
   also on finite values, and its barrier variants at C = 256), which
   print ns per iteration per variant (the device time of launches queued
   behind a device sleep) and P7's deltas over base, and must launch
   every kernel; every col variant's time per iteration at G = 64 must lie
   within 0.95-1.10 of its time at G = 128 (every iteration's work is
   done); then ``cuobjdump -sass`` of the P6-P8 library: for each
   col_kernel instantiation the MEMBAR.*.GPU, CCTL.IVALL and cluster
   barrier (CGABAR) instructions, none of which may lie inside a loop or
   outnumber what the kernel's entry and exit cluster barriers compile to;
   then P6 priced against its latency: from the SASS of chain_kernel's
   one-chain instantiations the dependent instructions and the
   instructions a pair of each op, the SM clock read by ``nvidia-smi``
   while c1_fma runs at the tool's size, and each variant's latency bound
   and share at C = 32, K = 64, G = 128 (``forest_chain.latency_bound_ns``);
10. P1-P4, every case (P1 at 4352 and 2176 lanes, both signs; P2; P3;
   P4 both signs) at 8, 32 and 128 rows on the tools' inputs and on
   seeded ones, held to its plain version bit for bit; the device time
   per launch (queued) beside the plain version's and that of the one
   torch.gather that computes the same (the yardstick); P1 and P2 at an
   odd width (2175 lanes, the kernel's scalar path) at 8, 32 and 128 rows,
   bit for bit; ``cuobjdump -sass`` of the roll library: no block barrier
   (BAR) and no shared-memory access (LDS, STS) in either kernel, and
   16-byte stores (STG.E.128), three a thread in barrel_kernel; then the
   two entry points, roll_wide and mosaic_bisect, each with every stage.
   The kernels line has one record per kernel wrapper (P1's four cases
   share dyn_roll_cuda, P4's two roll_cuda), each case's numbers inside;
11. the weak-signal chain at 32 dBHz: ``Receiver.run`` on the card with
   ``DEEP_ACQ`` + ``COHERENT_TRACK`` (``track_block_epochs=1000``) on a
   36 s, 4-satellite ``fix_scenario``: fix within 500 m, |vel| < 10 m/s,
   every channel bit synced by the aided histogram search (at least one
   engagement each) with a full ephemeris set, every block through K1's
   ``coherent_pll`` mode and nothing else; wall time, ``track`` ms a
   block and acquisition ms;
12. the same at 29 dBHz on a 66 s capture with the frame sent twice,
   ``ULTRA_ACQ`` (10 bit-edge hypotheses on the card) +
   ``DEEP_COHERENT_TRACK`` (K1 with ``pll_ext_bits = 5``);
13. background re-acquisition and demotion: the two runs of
   tests/test_late_rise.py (the riser joins) and the setting capture with
   a 35 dBHz C/N0 floor (PRN 18 drops and re-joins; at the default floor
   neither package drops it); every block through K1 at the channel count
   it starts with, and the watchdog rows, code rows and carried watchdog
   window following the channels;
14. phase 4's capture with ``enable_rtcm=True``: every frame passes its
   CRC-24Q, each satellite's 1019 decodes to its ephemeris, the MSM5
   pseudoranges at the fix's epoch lie within 100 m of the fixed position
   (clock removed); a checkpoint at half the capture, loaded with no
   device (so on the card), continues to the same bits, framer history,
   ephemerides and RTCM frames as an uninterrupted run whose K1 carry is
   dropped at the same block, its state planes to phase 3's tolerances;
   the fix of the resumed run beside that of the run keeping its carry;
   the counts are set to 0 before each of the three runs, and each run
   launches K1 once for each of its track-stage calls (the resumed run's
   two receivers together) and calls no plain version;
15. acquisition of PRNs 1-32 on phase 4's capture: the FFT cube and the
   matmul DFT at "highest" (float32; TF32 off, torch's default) and
   "default" (bf16 inputs, float32 accumulation and result) give the
   same detections and Doppler bins; the epoch vote equals its plain version on the CPU and
   the cube on every PRN it detects (it misses PRN 7, whose votes split
   between two Doppler bins, as the JAX package's does); each one's
   CUDA-event time;
16. the wire format: a 1-bit ``REFERENCE_PLAN`` capture packed into SPI
   words, conditioned on the card (``reference_to_baseband_device``)
   against the host conditioner within 1e-5, then
   ``python -m stm32f4_sdr_gps_torch run <file> --format bits16`` as a
   subprocess on the card: exit 0, PRN 19 tracking.

17. the mesh and multi-process runtime, on grids whose positions all
   name the card (they check the sharding and the collectives on one
   card and measure no scaling): (a) phase 3's 32-channel scenario
   through ``StreamingTracker`` on 8 positions, K1 once a position a
   block, bit for bit one K1 launch over all 32 channels in every output
   and state plane; then ``dryrun_multichip(8)`` (sharded acquisition,
   the halo, the sharded reference scan and K1, the MeshReceiver to a
   fix within 100 m of the single-process Receiver's with equal subframe
   ledgers); (b) the MeshReceiver on phase 4's capture, 4 PRNs and 4
   ghost channels on a 2 x 4 grid: fix within 500 m, |vel| < 10 m/s, K1
   once a position a block (1 channel each) and nothing else, its
   distance from phase 4's fix, wall time and ``track`` stage; (c) two
   processes x 4 positions over gloo on loopback TCP,
   ``probes/multiprocess_run.py --device cuda --slow``: the acquisition
   cube and halo across the processes, tracking across the boundary,
   per-process decode of 8 PRNs, and the distributed 29 s fix within
   150 m; a rank that exits non-zero or outlives its time limit fails
   the run.  Phase 17's records go into K1's entry of the kernels line.
18. the reference scan on the card: ``entry_jnp_scan()`` (32 channels x
   100 epochs of seed-0 noise through ``track_block`` with
   ``in_kernel_scan=False``) against ``entry_jnp_scan(device="cpu")`` on
   the same inputs under phase 3's rules; then ``Receiver.run`` with
   ``TrackConfig(in_kernel_scan=False)`` on phase 4's capture: fix within
   500 m, |vel| < 10 m/s, full ephemerides, and no launch of K1 or K2 (nor
   a plain version's call); its fix error beside phase 4's through K1.
   Meanwhile, in the background: native/ rebuilt with ``make -B`` (never a
   library built on another machine) and phases 19-20's wire captures
   generated, one ``native/capture_gen`` each, all at once;
19. the firmware oracle (native/firmware_rx.cpp) against K1 on the card,
   ``probes/firmware_parity.py``: the non-slow captures of
   tests/test_firmware_parity.py (12 s, seed 11), test_master_parity.py
   (38 s cold, seed 3) and test_parity_stress.py (``cn0_45``), each
   through the oracle and the port's Receiver on the card with the
   suite's own bars (nav bits equal on the 20 ms grid up to one polarity;
   Doppler < 5 Hz, code < 0.32 chip; the cold bins within one 500 Hz bin;
   relative pseudoranges in the master suite's light-ms classes, window
   and overlap bounds; the stress point's piecewise bits and code-delay
   trajectory), K1 on every tracking block and nothing else; then
   tests/test_reference_format_e2e.py's 2.3 s PRN 19 capture to decoded
   subframes;
20. the streaming soak (``probes/soak.py``): 30 s of wire capture pushed
   through the native ring at 2.0x real time into the Receiver on the
   card, zero dropped epochs, all but at most 1000 epochs consumed, 4
   channels tracking, K1 on every block, and what it decoded (each PRN's
   subframe ledger, subframes and bits, every fix) equal to a direct
   ``Receiver.run`` of the same capture on the card; its sustained
   real-time factor, the ring's high-water mark, the consumer's stall and
   its fixes (none on this capture, as for the JAX kernel: PERF.md);
21. ``Profiler.device_trace`` around 3 warm ``process_block`` calls of
   phase 4's main path: the card's busy share of the traced window (the
   union of its kernel and memcpy intervals) and the top 5 device
   operations by time, printed, not gated;
22. the receiver under stress (``probes/stress.py``, the JAX package's
   robustness suites): every scenario through the default path on the
   card (K1) under its suite's bars: the RF-impaired compressed-time
   Receiver, the sub-epoch bit edges, eight channels, the Doppler ramp,
   dropout and noise burst (each also held to K1's plain version on the
   CPU under _compare's rules, with no nav bit required), the coherent
   bit and PLL claims, K1 on every block and nothing else; then the
   29 s impaired cold start with one K1 launch a block: a fix within
   700 m with every ephemeris set full, or else exactly the reference's
   outcome on the other side of PRN 15's fade (its bit split at epochs
   24252 / 24267, the other sets full, no fix: ROADMAP Queue 3);
23. ``probes/wire_e2e.py`` at tools/tpu_e2e.py's defaults on the card: the
   29 s capture_gen wire capture uploaded and conditioned on the card a
   256-epoch chunk at a time, cold start and every block from device
   memory, the last fix within 500 m, every block a CUDA tensor, no
   samples copied from the host (``upload.samples``), K1 on every
   block;
24. the system ceiling (``probes/capacity.py``): phase 3's 32-channel,
   1000-epoch scenario tiled to 32, 64, 128, 256, 512 and 1024 channels
   (G = 1 to 4) through the Receiver's per-block program
   (``_track_and_digest_carried`` then ``digest_to_host``), timed with
   CUDA events in three parts (K1; the rest on the device; the readback),
   median over 20 blocks; the 32-channel digest must equal the Receiver's
   own block bit for bit, and every width's digest the 32-channel digest
   tiled (integer leaves bit for bit, float leaves bit for bit or within
   1e-6 relative, and which is printed); the host decode
   (``probes/host_cost.py``, 30 blocks of LNAV-carrying digests through
   ``Receiver._consume_digest``) at each width must decode the subframes
   the JAX package's tools/host_cost_probe.py decodes
   (JAX_HOST_SUBFRAMES); K1 in its default mode and nothing else; the
   table of k, h, serial and pipelined multiples and aggregate channels
   is printed, not gated;
25. the sensitivity envelope: the seven claims of
   tests/test_sensitivity.py (``probes/sensitivity.py``) on the card under
   their bars, each peak ratio printed beside its threshold, the two
   tracking claims through K1's default mode and the five acquisition
   claims with no K1 launch; ``probes/ext_pll.py``'s synced-handoff sweep
   (26-23 dBHz, seeds 42, 7, 21, 75 bits) through K1's ``coherent_pll``
   and ``coherent_pll_ext5`` modes, the ext loop's bit errors within
   EXT_MARGIN of tools/ext_pll_tune.py's table (JAX_EXT_ERRS) at every
   C/N0; then the deep chain (``probes/deep_cold.py``: ULTRA_ACQ +
   DEEP_COHERENT_TRACK) at 29 dBHz on seeds 7 and 42 (eager:
   ``deep_cold.run_traced`` reads every block's slot stream), every block
   through K1 with pll_ext_bits = 5 and held to K1's plain version on the
   CPU from the card's entering state (``deep_cold.check_held``: a part
   with no marginal decision fails), each run held to the bar of a fix
   within 500 m with every ephemeris set full and every channel bit
   synced, or to exactly the seed's known miss where the bar misses on
   the card (``deep_cold.check_outcome``, KNOWN_MISS; printed "BAR NOT
   MET"; any other outcome fails).  Phase 12 is the third seed, 21, held
   to the bar alone.
   Phase 23's capture, phase 22's 29 s fix_scenario and phase 25's two
   66 s fix_scenarios are made in the background from phase 18 on (the
   fix_scenarios in processes of their own).  Phases 18-25's records go
   into K1's entry of the kernels line, and their seconds into the
   ``[phases]`` line;
26. the captured programs (``utils/graphs.py``, ``probes/
   graph_replay.py``): K1's carried block program at 4, 32 and 256
   channels (G = 2), the K2 per-epoch ``_track_and_digest`` and the
   reference scan's at 32, each from one entering state over three
   1000-epoch blocks and a fourth with the last channel dropped (a new
   key, captured anew), run eagerly (``graphs.disable_capture()``) and
   replayed: every leaf of the returned states and digest bit for bit,
   block n's results unchanged by block n + 1, K1 once a block and K2
   once an epoch and nothing else, one capture a key; printed, not
   gated: each block's host wall and CUDA-event span, eager and
   replayed, the captures and warm-up launches; then K1's program at 32
   channels again with the blocks already on the card (checked the same
   way; its times hold no host copy), and the card's busy share of two
   warm such blocks, eager and replayed, by phase 21's method.  Its
   records go into K1's and K2's entries of the kernels line.
27. the handoff search's kernels (``probes/pretrack_kernels.py``) against
   the plain loops they replace, on the card: the squared prompts at
   (C = 4, E = 32), (32, 256) and (32, 512), the half-chip power at
   (C = 4, K = 31, E = 20) and (32, 31, 100), on simulated 45 dBHz
   captures: the Doppler bins and the code peaks equal, the prompts and
   the power within 1e-5 of each channel's largest, one launch a prompts
   call and two a power call with no plain-loop call; each call's device
   time (queued) beside its bound, an empty kernel's and the plain
   loop's time.  Every Receiver run of the phases before (4, 4b, 7, 11,
   12, 13 and the others that run ``Receiver.run`` on the card) must
   have handed over through these kernels and called no plain loop, and
   phase 13's re-acquisitions too; the launch counts go into the
   kernels line.
28. the real-IF ingest kernel (``probes/if_resample.py``, R1) on the
   SoftGNSS cell's own 266-epoch windows of int8 samples at 38.192 MHz
   (seeded noise at 8 LSB twice, at 40 LSB once): the kernel, its plain
   version on the card and the g++ build of its arithmetic each within
   1e-5 of the float64 reference's RMS (signal/if_reference.py; the
   plain version with half-precision taps, the control, must miss it),
   the kernel equal to its host build bit for bit, one launch a window;
   its device time a window (queued) beside its bytes bound, an empty
   kernel's, the plain version's and the whole ingest's from host
   memory, standalone (pageable) and as a window of a buffer three
   windows long (page-locked once, utils/device.py ``HostPages``), each
   with its GB/s, the two basebands equal bit for bit.
29. the SoftGNSS deployment's cold start on the main path
   (``int8_coldstart_phase``): three 266-epoch windows of a 38.192 MHz
   int8 capture of 8 satellites (the port's simulator at 50 dBHz,
   quantised at 8 LSB) each through ``if_to_baseband_device``,
   ``acquire_all`` over 32 PRNs and ``start_tracking``: no satellite
   missed, every handoff within 32 Hz and 1.0 chip of the truth, one R1
   launch a window (counted from zero before the run; the kernels line's
   R1 ``launches``) and the handoff through its kernels alone; then two
   starts with the acquired phases planted 0.75 chip either side of the
   truth, each of which must search the Doppler again
   (``pretrack.doppler_again``, two squared-prompt launches) and hand
   over within the same limits.
30. the captured acquisition (``probes/acquire_replay.py``): the cube
   and its peak analysis (``acquire.engine._acquire_fused``) at 4 and 32
   PRNs, with 2-epoch coherent sums and 2 bit-edge hypotheses, with a
   hint mask and on the matmul DFT's "default" path, run eagerly
   (``graphs.disable_capture()``) and captured, on two windows with two
   PRN sets of one size: every AcqResult field bit for bit, one
   ``acquire.capture`` then an ``acquire.replay`` a call, one readback
   a call; the host time of a whole ``acquire`` call (median of 50) and
   the device time of a program call (queued), eager and replayed; then
   the "highest" DFT precision must raise on its replayed key once TF32
   is switched on.

Every tracking program runs as a captured CUDA graph by default
(``utils/graphs.py``: the port's ``jax.jit``), and every phase's launch
counts are those of the programs' replays (a capture's warm-up launches
are counted apart); each Receiver run prints the captures it made.

The fix-scenario captures are simulated on the host where their phase
starts (phase 11's and 12's simulation times are printed, not counted in
the phases' seconds).

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
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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

    libs = {"track_scan_cuda": kernel_lib.cuda_lib,
            "epl_cuda": kernel_lib.epl_lib,
            "corr_bank_cuda": kernel_lib.corr_bank_lib,
            "forest_cuda": kernel_lib.forest_lib,
            "roll_cuda": kernel_lib.roll_lib,
            "pretrack_cuda": kernel_lib.pretrack_lib,
            "if_resample_cuda": kernel_lib.if_resample_lib}
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
                                             "corr_bank_mma": "mma_kernel"}),
                         ("pretrack_cuda", {
                             "sq_prompts": "sq_prompt_kernel",
                             "pretrack_corr": "pretrack_corr_kernel",
                             "pretrack_sum": "pretrack_sum_kernel"})):
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
    # the ingest kernel is a template on L (1 and 3): both clean
    log = kernel_lib.build_info["if_resample_cuda"]["log"]
    rec = kernel_lib.ptxas_report(log, "if_resample_kernel")
    bad = [k for k in rec if k["stack"] or k["spill_stores"]
           or k["spill_loads"]]
    if len(rec) != 2 or bad:
        fail(f"if_resample_cuda: ptxas reports {len(rec)} of 2 "
             f"if_resample_kernel instantiations, with a stack frame or "
             f"spills: {bad}")
    ptxas["if_resample"] = _ptxas_record(rec)
    print(f"[build] if_resample_cuda: both if_resample_kernel "
          f"instantiations with 0 bytes of stack frame and no spills; "
          f"registers {sorted({k['registers'] for k in rec})}")
    # ptxas warns when it has to serialise the mma kernel's wgmmas
    ptxas["wgmma_serialized"] = "serialized" in kernel_lib.build_info[
        "corr_bank_cuda"]["log"]
    log = kernel_lib.build_info["forest_cuda"]["log"]
    every = kernel_lib.ptxas_report(log, "")
    bad = [k for k in every if k["stack"] or k["spill_stores"]
           or k["spill_loads"]]
    if not every or bad:
        fail(f"forest_cuda: ptxas reports {len(every)} kernels, with a stack "
             f"frame or spills: {bad}")
    for name, kernels in FOREST_KERNELS.items():
        rec = [k for kern in kernels
               for k in kernel_lib.ptxas_report(log, kern)]
        if not rec:
            fail(f"forest_cuda: ptxas reports no {kernels}")
        ptxas[name] = _ptxas_record(rec)
    print(f"[build] forest_cuda: all {len(every)} kernels (P6-P8) with 0 "
          "bytes of stack frame and no spills; registers "
          f"{ {n: ptxas[n]['registers'] for n in FOREST_KERNELS} } (most "
          "of any instantiation)")
    # the roll kernels are gathers: no shared memory, no barrier either
    log = kernel_lib.build_info["roll_cuda"]["log"]
    for kernel in ("roll_rows_kernel", "barrel_kernel"):
        rec = kernel_lib.ptxas_report(log, kernel)
        bad = [k for k in rec if k["stack"] or k["spill_stores"]
               or k["spill_loads"] or k["smem"] or k["barriers"]]
        if len(rec) != 1 or bad:
            fail(f"roll_cuda: ptxas reports {len(rec)} entries named "
                 f"{kernel}, with a stack frame, spills, shared memory or "
                 f"barriers: {bad}")
        ptxas[kernel] = _ptxas_record(rec)
    print("[build] roll_cuda: roll_rows_kernel and barrel_kernel with 0 "
          "bytes of stack frame, no spills, 0 bytes of shared memory and no "
          "barriers; registers "
          f"{ {k: ptxas[k]['registers'] for k in ('roll_rows_kernel', 'barrel_kernel')} }")
    return ptxas


# the forest library's kernels of each probe, as ptxas names them
FOREST_KERNELS = {"forest_chain": ("chain_kernel",),
                  "forest_constructs": ("constructs_kernel",),
                  "forest_layout": ("tr_kernel", "row_kernel", "col_kernel")}


def _ptxas_record(report):
    """The largest registers, stack, spill and static shared memory bytes
    over ptxas entries."""
    return {"registers": max(k["registers"] for k in report),
            "stack_bytes": max(k["stack"] for k in report),
            "spill_bytes": max(k["spill_stores"] + k["spill_loads"]
                               for k in report),
            "smem_bytes": max(k["smem"] for k in report)}


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


def _compare(st_k, out_k, st_r, out_r, label, coherent=False, bits=True):
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
    with (T, C) leaves; ``bits=False`` for a scenario that carries no
    data bits (no nav bit is then required).  Returns the max |kernel -
    plain| over the
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
    n_bits = int(r["bit_ready"][valid].sum())
    if bits and n_bits == 0:
        fail(f"{label}: the scenario produced no nav bit")
    print(f"[compare] {label}: {n_bits} bits, integer decisions equal; "
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
    """Every kernel's launch count, every plain version's call count and
    the count of samples copied from the host (``utils.profiling``'s
    ``upload.samples``) to 0."""
    from stm32f4_sdr_gps_torch.acquire import engine
    from stm32f4_sdr_gps_torch.ops import epl
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import corr_bank as cb
    from stm32f4_sdr_gps_torch.signal import capture
    from stm32f4_sdr_gps_torch.track import pretrack
    from stm32f4_sdr_gps_torch.utils import profiling

    for mod, _, _ in _roll_probes():
        for fn in set(mod.KERNELS.values()):
            fn.launches = 0
    profiling.counters.pop("upload.samples", None)
    ts.track_scan_cuda.launches = 0
    ts.track_scan_cuda.by_mode.clear()
    ts.track_scan_reference.calls = 0
    epl.epl_correlate_cuda.launches = 0
    epl.epl_correlate_halfchip.calls = 0
    engine.squared_prompts_cuda.launches = 0
    engine.squared_prompts_plain.calls = 0
    pretrack.pretrack_power_cuda.launches = 0
    pretrack._pretrack_power.calls = 0
    capture.if_resample_cuda.launches = 0
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


#: handoff kernel launches of each Receiver run and re-acquisition on the
#: card, by phase label (phase 27 prints them)
HANDOFF_LAUNCHES: dict = {}


def _check_handoff(label, least=3):
    """Fail unless the run since the last ``_reset_counts`` handed over
    through the handoff search's kernels (at least ``least`` launches: one
    squared-prompt launch and two power launches a handoff) and never
    through their plain loops."""
    from stm32f4_sdr_gps_torch.acquire import engine
    from stm32f4_sdr_gps_torch.track import pretrack

    launches = (engine.squared_prompts_cuda.launches
                + pretrack.pretrack_power_cuda.launches)
    plain = engine.squared_prompts_plain.calls + pretrack._pretrack_power.calls
    if launches < least or plain:
        fail(f"{label}: the handoff bypassed its kernels: {launches} kernel "
             f"launches, {plain} plain-loop calls")
    HANDOFF_LAUNCHES[label] = launches


def _run_receiver(sc, track, label, acq=None):
    """Receiver.run on the card on the fix scenario (the default
    AcqConfig unless ``acq``); checks the fix and the ephemerides, returns
    (report, receiver, kernel counts of the run)."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig(prns=sc.prns, track=track, track_block_epochs=1000,
                         acq=acq or AcqConfig())
    from stm32f4_sdr_gps_torch.utils import graphs

    rx = Receiver(cfg)                      # the card, by default
    if rx.device.type != "cuda":
        fail(f"{label}: Receiver(cfg) chose {rx.device}, not the card")
    _reset_counts()
    captures = graphs.stats["captures"]
    t0 = time.perf_counter()
    report = rx.run(sc.samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    _check_handoff(label)
    tracked = report.epochs_processed - cfg.acq.noncoherent_epochs
    blocks = rx.profiler.stages["track"].calls
    print(f"[{label}] Receiver.run: {wall:.2f} s wall for "
          f"{report.epochs_processed} epochs ({tracked} tracked in {blocks} "
          f"blocks; {len(sc.samples) / 2.046e6 / wall:.2f}x real time); "
          f"counts {counts}; {graphs.stats['captures'] - captures} "
          "captures")
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
    (s), the mean ``track`` stage per block (ms) and the final fix."""
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
            rx.profiler.stages["track"].mean_s * 1e3,
            report.solutions[-1].rr)


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

    # the col kernels against the host build of their decomposition (the
    # same channel groups, slabs, halo and summation order): bit for bit
    from stm32f4_sdr_gps_torch.probes import forest_layout as p8

    for v in ("wide_col", "red_col", "roll_col"):
        for c in (32, 4):
            for which in ("probe", "seeded"):
                args = p8.check_args(v, which, dev, c)
                got = p8.layout_cuda(*args)
                want = p8.layout_col_host(*(a.cpu() if isinstance(
                    a, torch.Tensor) else a for a in args))
                if not all(torch.equal(g.cpu(), w)
                           for g, w in zip(got, want)):
                    fail(f"forest_layout {v} at C = {c} ({which} inputs): "
                         "the kernel differs from the host build of its "
                         "decomposition")
    print("[forest] wide_col, red_col, roll_col at C = 32 and 4 on both "
          "input sets: bit for bit the host build of the col decomposition")

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
        # the col kernels must do every iteration's work
        off = {v: r for v, r in ratio.items()
               if v.endswith("_col") and not 0.95 <= r <= 1.10}
        if off:
            fail(f"{name}: G = 64 over G = 128 outside 0.95-1.10: {off}")
        res[name].update(launches=launches, ns_per_iter=ns128,
                         ns_per_iter_g64=ns64, ns_per_iter_4ch=ns4)
    res["forest_layout"]["sass_col"] = col_sass()
    res["forest_chain"].update(chain_latency(full["forest_chain", 32, 128]))
    print(f"[forest] phase 9 in {time.perf_counter() - t0:.1f} s")
    return res


# SASS of one cluster barrier (barrier.cluster.arrive.release + wait.
# acquire, cluster.sync): the fence, the arrive and the wait, the L1
# invalidate; and how many each col variant has (after the mbarrier init
# and before exit; none for wide_col, which exchanges nothing)
CLUSTER_BARRIER_SASS = {"membar_gpu": 1, "cctl_ivall": 1, "cluster_barrier": 2}
COL_CLUSTER_BARRIERS = {3: 2, 5: 2, 7: 2}     # WIDE_COL, RED_COL, ROLL_COL


def _sass_kind(ins):
    """Which counted class a SASS instruction falls in, or None."""
    words = ins.split()
    if words and words[0].startswith("@"):       # a predicate
        words = words[1:]
    op = words[0] if words else ""
    if op.startswith("MEMBAR") and ".GPU" in op:
        return "membar_gpu"
    if op.startswith("CCTL") and "IVALL" in op:
        return "cctl_ivall"
    if "CGABAR" in op:
        return "cluster_barrier"
    return None


def col_sass():
    """``cuobjdump -sass`` of the forest library: for each col_kernel
    instantiation, its MEMBAR.*.GPU, CCTL.IVALL and cluster-barrier
    (CGABAR) instructions, in all and inside a loop (able to reach
    themselves in the kernel's control flow, ``sass.on_cycle``).  Fails if
    any lies in a loop or there are more than the design's entry and exit
    barriers compile to."""
    from stm32f4_sdr_gps_torch.ops import kernel_lib
    from stm32f4_sdr_gps_torch.probes import sass

    funcs = sass.functions(
        sass.dump(kernel_lib.build_info["forest_cuda"]["path"]),
        r"col_kernelILi(\d+)ELi(\d+)E")
    funcs = {tuple(map(int, k)): v for k, v in funcs.items()}
    if len(funcs) != 12:
        fail(f"SASS: {len(funcs)} col_kernel instantiations, want 12")
    res = {}
    names = {3: "wide_col", 5: "red_col", 7: "roll_col"}
    for (v, cg), ins in sorted(funcs.items()):
        succ = sass.successors(ins)
        count = dict.fromkeys(CLUSTER_BARRIER_SASS, 0)
        in_loop = dict.fromkeys(CLUSTER_BARRIER_SASS, 0)
        for i, (_, text) in enumerate(ins):
            kind = _sass_kind(text)
            if kind:
                count[kind] += 1
                in_loop[kind] += sass.on_cycle(succ, i)
        most = {k: n * COL_CLUSTER_BARRIERS[v]
                for k, n in CLUSTER_BARRIER_SASS.items()}
        label = f"{names[v]} CG={cg}"
        loop = any(sass.on_cycle(succ, i) for i in range(len(ins)))
        print(f"[forest] SASS {label}: {len(ins)} instructions; {count} "
              f"(design at most {most}), inside a loop {in_loop}")
        if not loop:
            fail(f"SASS {label}: no loop found")
        if any(in_loop.values()) or any(count[k] > most[k] for k in count):
            fail(f"SASS {label}: {count} / in a loop {in_loop} beyond the "
                 f"entry and exit barriers ({most})")
        res[label] = {"counts": count, "in_loop": in_loop,
                      "design_most": most}
    return res


def chain_latency(times):
    """P6 priced against its latency: from the SASS of chain_kernel's
    one-chain instantiation of each op, the dependent instructions a pair
    (the longest chain's growth per trip of the loop over pairs, over the
    pairs a trip) and the instructions a pair (the trip's, less the loop's
    own); the SM clock read by nvidia-smi while c1_fma runs at the tool's
    size; then each variant's latency bound per iteration
    (``forest_chain.latency_bound_ns``) and its share of the measured
    ``times`` (the entry point's at C = 32, K = 64, G = 128)."""
    import torch

    from stm32f4_sdr_gps_torch.ops import kernel_lib
    from stm32f4_sdr_gps_torch.probes import forest_chain as p6
    from stm32f4_sdr_gps_torch.probes import sass
    from stm32f4_sdr_gps_torch.probes.scan_time import sm_clocks_under

    funcs = sass.functions(
        sass.dump(kernel_lib.build_info["forest_cuda"]["path"]),
        r"chain_kernelILi(\d)ELi1E")
    per_pair = {}
    for op, code in (("fma", "0"), ("sel", "1"), ("int", "2")):
        ins = funcs.get((code,))
        if not ins:
            fail(f"SASS: no chain_kernel<{op}, 1>")
        marker, per = p6.PAIR_MARKER[op]
        best = None
        for first, last in sass.inner_loops(ins):
            body = [t for _, t in ins[first:last]]
            n = sum(sass.opcode(t).startswith(marker) for t in body)
            if n and (best is None or n > best[0]):
                best = (n, body)
        if best is None:
            fail(f"SASS: no loop of chain_kernel<{op}, 1> holds a {marker}")
        pairs = best[0] / per
        body = best[1]
        per_pair[op] = {
            "pairs_per_trip": pairs,
            "dependent": sass.depth_per_trip(body) / pairs,
            "instructions": (len(body) - sass.loop_control(body)) / pairs}
    x = torch.as_tensor(p6.probe_inputs("c1_fma", p6.C), device="cuda")
    clocks = sm_clocks_under(lambda: p6.chain_cuda(x, "c1_fma", p6.K, p6.G))
    bound, share = {}, {}
    for v, t in times.items():
        pp = per_pair[v.split("_")[1]]
        bound[v] = p6.latency_bound_ns(v, pp["dependent"], pp["instructions"],
                                       clocks["sm_mhz"])
        share[v] = bound[v] / t["ns_per_iter"]
    print(f"[forest] P6 SASS per pair (one chain): {per_pair}; SM clock "
          f"{clocks} MHz while c1_fma runs")
    for v in times:
        print(f"[forest] P6 {v}: {times[v]['ns_per_iter']:.1f} ns/iter, "
              f"latency bound {bound[v]:.1f} ns ({share[v]:.0%})")
    return {"sm_clocks_mhz": clocks, "sass_per_pair": per_pair,
            "latency_bound_ns_per_iter": bound, "latency_share": share}


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


# the 16-byte stores (STG.E.128) each thread of a roll kernel makes: E, P
# and L for the barrel, one row's four lanes for roll_rows
ROLL_STORES_128 = {"roll_rows_kernel": 1, "barrel_kernel": 3}


def roll_sass():
    """``cuobjdump -sass`` of the roll library: each kernel's block
    barriers (BAR), shared-memory loads and stores (LDS, STS) and 16-byte
    global stores.  Fails on any barrier or shared-memory access, or
    fewer 16-byte stores than ROLL_STORES_128."""
    from stm32f4_sdr_gps_torch.ops import kernel_lib
    from stm32f4_sdr_gps_torch.probes import sass

    funcs = sass.functions(
        sass.dump(kernel_lib.build_info["roll_cuda"]["path"]),
        r"(roll_rows_kernel|barrel_kernel)")
    res = {}
    for kernel, most in ROLL_STORES_128.items():
        ins = funcs.get((kernel,))
        if not ins:
            fail(f"SASS: no {kernel} in the roll library")
        ops = [sass.opcode(t) for _, t in ins]
        rec = {"instructions": len(ops),
               "bar": sum(o.startswith("BAR") for o in ops),
               "shared": sum(o.startswith(("LDS", "STS")) for o in ops),
               "stg128": sum(o.startswith("STG") and ".128" in o
                             for o in ops)}
        print(f"[roll] SASS {kernel}: {rec}")
        if rec["bar"] or rec["shared"] or rec["stg128"] < most:
            fail(f"SASS {kernel}: {rec}: want no BAR, LDS or STS and at "
                 f"least {most} STG.E.128")
        res[kernel] = rec
    return res


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
    # the scalar path: a width that is no multiple of 4, rows not 16-byte
    # aligned past the first
    lanes = roll_wide.ODD_WIDTH
    for case in ("dynwin_neg", "dynwin_pos", "statwin"):
        for rows in (8, 32, 128):
            args = roll_wide.check_args(case, "seeded", dev, rows, lanes)
            got = roll_wide.KERNELS[case](*args)
            want = roll_wide.PLAIN[case](*args)
            if not torch.equal(got, want):
                fail(f"{case} at {rows} rows x {lanes} lanes: the kernel "
                     "differs from its plain version")
            errs[case] = max(errs[case],
                             float((got.double() - want.double()).abs().max()))
    print(f"[roll] dynwin_neg, dynwin_pos, statwin at {lanes} lanes, 8 / 32 "
          "/ 128 rows (seeded): bit for bit")
    sass_rec = roll_sass()
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
    return res, errs, launches, sass_rec


# ---------------------------------------------------------------- phases 11-16

# the fix-scenario captures of phases 4-15 (fix_scenario keyword
# arguments)
CAPTURES = {
    "main": dict(num_epochs=29_000),
    "weak32": dict(num_epochs=36_000, cn0_dbhz=32.0),
    "weak29": dict(num_epochs=66_000, cn0_dbhz=29.0, frame_repeats=2),
}


def _capture(key):
    """fix_scenario(**CAPTURES[key]), with its simulation time."""
    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    t0 = time.perf_counter()
    sc = fix_scenario(**CAPTURES[key])
    print(f"[{key}] simulated {len(sc.samples) / 2.046e6:.1f} s of "
          f"{len(sc.prns)}-satellite baseband at {CAPTURES[key]} "
          f"({sc.samples.nbytes / 1e6:.0f} MB) in "
          f"{time.perf_counter() - t0:.1f} s")
    return sc


def _launched(counts_by_mode):
    """{(mode, C): launches} of the last run, as printable text."""
    return ", ".join(f"{m} x {c} ch: {n}"
                     for (m, c), n in sorted(counts_by_mode.items()))


def weak_chain(sc, acq, track, label, mode):
    """The weak-signal chain on the card: ``Receiver.run`` with a deep
    acquisition preset and a coherent tracking preset from cold start to
    a fix.  Every channel must be bit synced by the aided search (at least
    one engagement each) with a full ephemeris set, every block must go
    through K1 in ``mode`` and nothing else, and the fix must lie within
    500 m with |vel| < 10 m/s.  Returns its record."""
    import numpy as np

    from stm32f4_sdr_gps_torch.ops import track_scan as ts

    report, rx, counts, tracked, wall = _run_receiver(sc, track, label,
                                                      acq=acq)
    blocks = rx.profiler.stages["track"].calls
    by_mode = dict(ts.track_scan_cuda.by_mode)
    modes = {m for m, _ in by_mode}
    if (counts["track_scan"] != blocks or modes != {mode}
            or counts["track_scan_plain"] or counts["epl"]
            or counts["epl_plain"]):
        fail(f"{label}: {counts}, K1 {_launched(by_mode)} for {blocks} "
             f"blocks (want every block through K1 in {mode})")
    for ch in report.channels:
        n = rx.aided_engagements.get(ch.prn, 0)
        if not ch.bit_synced or n < 1:
            fail(f"{label}: PRN {ch.prn} bit_synced {ch.bit_synced}, "
                 f"{n} aided engagements")
    stages = rx.profiler.stages
    rec = {"launches": counts["track_scan"],
           "fix_error_m": float(np.linalg.norm(
               report.solutions[-1].rr - sc.rr_true)),
           "wall_s": wall,
           "track_ms_per_block": stages["track"].mean_s * 1e3,
           "acquire_ms": stages["acquire"].total_s * 1e3,
           "pretrack_ms": stages["pretrack"].total_s * 1e3,
           "aided_engagements": {int(k): v for k, v in
                                 sorted(rx.aided_engagements.items())}}
    print(f"[{label}] K1 {_launched(by_mode)}; aided engagements "
          f"{rec['aided_engagements']}; acquisition {rec['acquire_ms']:.1f} "
          f"ms, track {rec['track_ms_per_block']:.2f} ms a block")
    return rec


def _rise_set_captures():
    """tests/test_late_rise.py's two captures (PRNs 5 and 18 at 47 dBHz,
    3 codes a bit), made with the port's simulator from the same seeds:
    PRN 18 rising at 1.2 s, and PRN 18 gone from 1.0 s to 2.5 s."""
    from stm32f4_sdr_gps_torch.signal.simulator import SimSat, \
        simulate_capture

    def sats():
        return (SimSat(prn=5, doppler_hz=1200.0, code_phase_chips=300.0,
                       cn0_dbhz=47.0, codes_in_bit=3),
                SimSat(prn=18, doppler_hz=-2400.0, code_phase_chips=700.0,
                       cn0_dbhz=47.0, codes_in_bit=3))

    a, b = sats()
    xa, _ = simulate_capture([a], num_epochs=3000, seed=31)
    xb, truth = simulate_capture([b], num_epochs=3000, seed=32)
    xb[: 1200 * 2046] = 0
    rise = (xa + xb, truth)
    a, b = sats()
    xa, _ = simulate_capture([a], num_epochs=4000, seed=41)
    xb, _ = simulate_capture([b], num_epochs=4000, seed=42)
    xb[1000 * 2046: 2500 * 2046] = 0
    return rise, (xa + xb, None)


def reacquire():
    """Phase 13: the runs of tests/test_late_rise.py on the card (and the
    setting capture with a 35 dBHz C/N0 floor, under which the JAX
    Receiver drops PRN 18 at 2.51 s and re-acquires it at 3.01 s; at the
    default 25 dBHz it never drops it).  Each block goes through K1 at the
    block's channel count, and the carried watchdog window has one row
    per live channel, equal to the TrackState's."""
    import torch

    from stm32f4_sdr_gps_torch.config import ReceiverConfig, TrackConfig
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    t0 = time.perf_counter()
    (x_rise, truth), (x_set, _) = _rise_set_captures()
    recs = {}
    for label, x, floor in (("rise", x_rise, 25.0), ("set", x_set, 25.0),
                            ("set_floor35", x_set, 35.0)):
        cfg = ReceiverConfig(
            prns=(5, 18), enable_position=False, track_block_epochs=250,
            reacquire_period_ms=500, cn0_floor_dbhz=floor,
            track=TrackConfig(codes_in_bit=3, pll_bad_state_threshold=10**9))
        rx = Receiver(cfg)
        live = []

        def after_block(r):
            c = len(r.channels)
            if (r.track_state.ip_sign_window.shape[0] != c
                    or r.code_table.shape[0] != c):
                fail(f"[reacq] {label}: {c} channels, watchdog rows "
                     f"{r.track_state.ip_sign_window.shape[0]}, code rows "
                     f"{r.code_table.shape[0]}")
            # the carried kernel state, while it is valid, has the
            # TrackState's watchdog window, one row a channel
            if r.track_state is r._scan_carry_ref and not torch.equal(
                    r._scan_carry.win,
                    ts.state_from_track_state(r.track_state).win):
                fail(f"[reacq] {label}: carried watchdog window differs")
            live.append((r.epoch_cursor, tuple(ch.prn for ch in r.channels)))

        _reset_counts()
        report = rx.run(x, status_callback=after_block)
        torch.cuda.synchronize()
        counts, by_mode = _counts(), dict(ts.track_scan_cuda.by_mode)
        # every block ran K1 at the channel count it started with: the
        # count after the block before it
        if ({c for _, c in by_mode} != {len(p) for _, p in live[:-1]}
                or counts["track_scan"] != len(live)):
            fail(f"[reacq] {label}: K1 at {_launched(by_mode)}, channel "
                 f"sets {live}")
        if counts["track_scan_plain"] or counts["epl"]:
            fail(f"[reacq] {label}: counts {counts}")
        # the cold start's handoff, and a second where a satellite joins
        _check_handoff(f"reacq_{label}", 3 if label == "set" else 6)
        by = {ch.prn: ch for ch in report.channels}
        ok = (5 in by and 18 in by and by[18].state_name == "TRACKING"
              and abs(by[18].doppler_hz + 2400.0) < 15.0)
        if label == "rise":
            cp_true = truth.code_phase_at_epoch(0,
                                                report.epochs_processed - 1)
            err = (by[18].code_phase_chips - cp_true + 511.5) % 1023 - 511.5
            ok = ok and abs(err) < 0.5 and not rx.standby_channels
            ok = ok and live[0][1] == (5,)
        if label == "set_floor35":
            gone = [t for t, p in live if p == (5,)]
            ok = ok and bool(gone) and 2500 <= gone[0] and gone[-1] < 3500
        if not ok:
            fail(f"[reacq] {label}: live sets {live}, final "
                 f"{[(c.prn, c.state_name, c.doppler_hz) for c in report.channels]}")
        changes = [(t, p) for i, (t, p) in enumerate(live)
                   if i == 0 or p != live[i - 1][1]]
        recs[label] = {"launches": counts["track_scan"],
                       "launches_by_channels": {
                           str(c): n for (_, c), n in sorted(by_mode.items())},
                       "channel_sets": [[t, list(p)] for t, p in changes]}
        print(f"[reacq] {label}: channel sets {changes}; K1 "
              f"{_launched(by_mode)}")
    print(f"[reacq] phase 13 in {time.perf_counter() - t0:.1f} s")
    return recs


def _msm_vs_fix(rx, sol):
    """Each satellite's MSM5 pseudorange in the frames at the fix's epoch
    against the range from the fixed position (its own clock removed):
    returns the largest |residual - median residual| (m) and the frame's
    TOW."""
    import numpy as np

    from stm32f4_sdr_gps_torch.io.rtcm3 import decode_msm, deframe
    from stm32f4_sdr_gps_torch.pvt.gpstime import gpst2time, time2gpst
    from stm32f4_sdr_gps_torch.pvt.solve import NX, Obs, rescode, satposs

    eph = {ch.prn: ch.eph for ch in rx.channels}
    week = rx.channels[0].eph.week
    tow_fix, _ = time2gpst(sol.time)
    best = None
    for f in rx.rtcm_frames:
        p = deframe(f)
        if (p[0] << 4) | (p[1] >> 4) != 1075:
            continue
        d = decode_msm(p)
        if best is None or abs(d["tow_ms"] / 1e3 - tow_fix) < \
                abs(best["tow_ms"] / 1e3 - tow_fix):
            best = d
    t = gpst2time(week, best["tow_ms"] / 1e3)
    obs = [Obs(sat=o["sat"], time=t, P=o["pseudorange_m"])
           for o in best["obs"]]
    rs, dts, var, svh, _ = satposs(t, obs, eph)
    x = np.zeros(NX)
    x[:3] = sol.rr
    v = rescode(obs, rs, dts, var, svh, eph, x)[0][: len(obs)]
    return float(np.max(np.abs(v - np.median(v)))), best["tow_ms"], len(obs)


def rtcm_checkpoint(sc):
    """Phase 14: phase 4's capture with enable_rtcm on the card.  Run A
    keeps K1's carry throughout; run B stops at the block past half the
    capture, is checkpointed, loaded with no device (so on the card) and
    continued; run C is A with the carry dropped at B's cut, which is
    what the resumed receiver does (a checkpoint stores no kernel state).
    B must equal C: bits, framer history, ephemerides and RTCM frames
    exactly, the state planes to phase 3's tolerances.  Every frame
    deframes with a valid CRC-24Q, each satellite's 1019 decodes to its
    ephemeris, and the MSM5 pseudoranges at the fix's epoch agree with the
    fixed position within 100 m (clock removed)."""
    import tempfile

    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.convert import track_state_to_numpy
    from stm32f4_sdr_gps_torch.io.rtcm3 import decode_1019, deframe
    from stm32f4_sdr_gps_torch.runtime.checkpoint import (load_receiver,
                                                          save_receiver)
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    t0 = time.perf_counter()
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000,
                         enable_rtcm=True)
    spe = cfg.plan.samples_per_epoch
    x = sc.samples
    cut = len(x) // spe // 2

    def blocks(rx, pos, until=None):
        while pos + spe <= len(x) and (until is None
                                       or rx.epoch_cursor < until):
            chunk = x[pos: pos + 1000 * spe]
            rx.process_block(chunk)
            pos += (len(chunk) // spe) * spe
        return pos

    def start(rx):
        acq_e = cfg.acq.noncoherent_epochs
        rx.acquire_all(x)
        rx.start_tracking(x[acq_e * spe:], start_epoch=acq_e)
        rx.epoch_cursor = acq_e
        return acq_e * spe

    def launches(label, *rxs):
        """K1's launches since the last reset: one for each track-stage
        call of the run's receivers, and no plain-version call."""
        torch.cuda.synchronize()
        counts = _counts()
        calls = sum(r.profiler.stages["track"].calls for r in rxs)
        if (counts["track_scan"] != calls or counts["track_scan_plain"]
                or counts["epl"] or counts["epl_plain"]):
            fail(f"[rtcm] {label}: counts {counts} for {calls} track-stage "
                 "calls")
        return counts["track_scan"]

    n_k1 = {}
    _reset_counts()
    rx_a = Receiver(cfg)
    blocks(rx_a, start(rx_a))
    n_k1["carry"] = launches("carry", rx_a)
    _reset_counts()
    rx_c = Receiver(cfg)
    pos_cut = blocks(rx_c, start(rx_c), until=cut)
    rx_c._scan_carry_ref = None
    blocks(rx_c, pos_cut)
    n_k1["carry_dropped"] = launches("carry_dropped", rx_c)
    _reset_counts()
    rx_b0 = Receiver(cfg)
    pos = blocks(rx_b0, start(rx_b0), until=cut)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_receiver(os.path.join(tmp, "ck"), rx_b0)
        size = os.path.getsize(path)
        rx_b = load_receiver(path)
    if rx_b.device.type != "cuda" or not rx_b.track_state.doppler_hz.is_cuda:
        fail("[rtcm] load_receiver(path) did not put the receiver on the card")
    blocks(rx_b, pos)
    n_k1["resumed"] = launches("resumed", rx_b0, rx_b)
    for a, b in zip(rx_c.channels, rx_b.channels):
        if (a.prn, a.bit_count, a.framer.history, a.subframe_time_ms,
                a.eph.received_mask_proc) != (
                b.prn, b.bit_count, b.framer.history, b.subframe_time_ms,
                b.eph.received_mask_proc):
            fail(f"[rtcm] PRN {a.prn}: resumed run differs from the run "
                 "with the carry dropped at the cut")
        for f in ("week", "iode", "iodc", "A", "e", "M0", "toes", "f0"):
            if getattr(a.eph, f) != getattr(b.eph, f):
                fail(f"[rtcm] PRN {a.prn}: ephemeris {f} differs")
    if rx_b.rtcm_frames != rx_c.rtcm_frames:
        fail("[rtcm] resumed run's RTCM frames differ")
    sb, sc_ = (track_state_to_numpy(r.track_state) for r in (rx_b, rx_c))
    for f, tol in (("code_phase_chips", 5e-3), ("doppler_hz", 0.5),
                   ("snr_db", 0.1)):
        if np.abs(sb[f] - sc_[f]).max() > tol:
            fail(f"[rtcm] resumed {f} off by {np.abs(sb[f] - sc_[f]).max()}")
    for f in sb:
        if sb[f].dtype.kind in "ib" and not np.array_equal(sb[f], sc_[f]):
            fail(f"[rtcm] resumed {f} differs")
    kinds, eph_sats = [], set()
    for f in rx_a.rtcm_frames:
        p = deframe(f)
        if p is None:
            fail("[rtcm] a frame fails its CRC-24Q")
        kind = (p[0] << 4) | (p[1] >> 4)
        kinds.append(kind)
        if kind == 1019:
            d = decode_1019(p)
            ch = {c.prn: c for c in rx_a.channels}[d["sat"]]
            if (d["iode"], d["week"] % 1024) != (ch.eph.iode,
                                                 ch.eph.week % 1024) or \
                    abs(d["e"] - ch.eph.e) > 1e-9:
                fail(f"[rtcm] 1019 of PRN {d['sat']} is not its ephemeris")
            eph_sats.add(d["sat"])
    if eph_sats != set(sc.prns) or 1075 not in kinds:
        fail(f"[rtcm] 1019 for {sorted(eph_sats)}, kinds {set(kinds)}")
    errs = {}
    for label, rx in (("carry", rx_a), ("resumed", rx_b),
                      ("carry_dropped", rx_c)):
        if not rx.solutions:
            fail(f"[rtcm] {label}: no fix")
        errs[label] = float(np.linalg.norm(rx.solutions[-1].rr - sc.rr_true))
    spread, tow_ms, n_obs = _msm_vs_fix(rx_a, rx_a.solutions[-1])
    if spread > 100.0 or n_obs != len(sc.prns):
        fail(f"[rtcm] MSM5 pseudoranges {spread:.1f} m from the fix")
    print(f"[rtcm] {len(rx_a.rtcm_frames)} frames, all CRC-24Q valid: "
          f"{kinds.count(1019)} x 1019, {kinds.count(1075)} x 1075; MSM5 "
          f"at TOW {tow_ms} ms within {spread:.2f} m of the fix; checkpoint "
          f"at epoch {cut} ({size} bytes) resumed on the card = the run "
          f"with the carry dropped there; fixes {errs} m (resumed - carry "
          f"{errs['resumed'] - errs['carry']:+.2f} m); K1 launches "
          f"{n_k1}; phase 14 in {time.perf_counter() - t0:.1f} s")
    return {"launches": n_k1, "fix_error_m": errs,
            "frames": len(rx_a.rtcm_frames), "msm_vs_fix_m": spread}


def dft_products():
    """The matmul DFT's two products on the card at the acquisition's
    shape ((64, 2046) against the (2046, 2046) twiddle table), held
    against float64 products of the same inputs: "highest" within the
    float32 bound |err| <= K * 2^-24 * (|a| @ |b|) elementwise and under
    1 % of the error of the same product with TF32-rounded inputs (so no
    TF32 pass); "default" within the same bound of the float64 product of
    its bf16-rounded inputs, so its result is float32.  Returns the max
    errors (and the TF32 one) relative to max(|a| @ |b|)."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.ops.correlate import (dft_matmul,
                                                     dft_tables_device,
                                                     tf32_matmul_on)

    if tf32_matmul_on():
        fail("[dft] TF32 is on for CUDA matmuls")
    k = 2046
    a = torch.as_tensor(np.random.default_rng(15).standard_normal(
        (64, k)).astype(np.float32), device="cuda")
    wc, _ = dft_tables_device(k)

    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    def f64(x, y):
        return x.double() @ y.double()

    errs, scale = {}, None
    for name, (x, y) in (("highest", (a, wc)),
                         ("default", (bf16(a), bf16(wc)))):
        got = dft_matmul(a, wc, name)
        if got.dtype != torch.float32:
            fail(f"[dft] {name} product returned {got.dtype}")
        err = (got.double() - f64(x, y)).abs()
        bound = f64(x.abs(), y.abs())
        if (err > k * 2.0 ** -24 * bound).any():
            fail(f"[dft] {name} product past the float32 bound: max err "
                 f"{err.max().item():.3g}")
        errs[name] = err.max().item()
        scale = scale or bound.max().item()
    errs["tf32_inputs"] = (f64(tf32(a), tf32(wc)) - f64(a, wc)
                           ).abs().max().item()
    if errs["highest"] > 0.01 * errs["tf32_inputs"]:
        fail(f"[dft] highest product err {errs['highest']:.3g} is near a "
             f"TF32 product's {errs['tf32_inputs']:.3g}")
    rec = {k_: v / scale for k_, v in errs.items()}
    print(f"[dft] on the card, max |product - float64| / max(|a|@|b|): "
          f"{rec}")
    return rec


def acquisition_32(sc):
    """Phase 15: acquisition of PRNs 1-32 on phase 4's capture on the
    card.  The FFT cube and the matmul DFT at both precisions must detect
    the four planted PRNs and nothing else, in the same Doppler bins.  The
    epoch vote must equal its plain version on CPU copies (detections,
    bins, lag cells) and agree with the cube on every PRN it detects: it
    is the firmware's histogram detector, and a satellite whose per-epoch
    votes split between two Doppler bins (PRN 7 here, planted at
    -1269.6 Hz, 20 Hz off the midpoint of its two bins) is no detection
    for it, in the JAX package too.  Each one's CUDA-event time (median
    of 5 calls after a warm-up; the DFT products are torch.mm calls, not
    kernels of this port)."""
    from stm32f4_sdr_gps_torch.acquire.engine import (acquire,
                                                      acquire_epoch_vote)
    from stm32f4_sdr_gps_torch.config import AcqConfig, BASEBAND_PLAN

    x = sc.samples
    prns = list(range(1, 33))
    cfgs = {"fft": AcqConfig(),
            "dft_highest": AcqConfig(use_matmul_dft=True,
                                     dft_precision="highest"),
            "dft_default": AcqConfig(use_matmul_dft=True,
                                     dft_precision="default")}
    runs = {k: (lambda c=c: acquire(x, prns, BASEBAND_PLAN, c))
            for k, c in cfgs.items()}
    runs["epoch_vote"] = lambda: acquire_epoch_vote(x, prns, BASEBAND_PLAN,
                                                    AcqConfig())
    step = AcqConfig().doppler_step_hz
    res, times = {}, {}
    for k, fn in runs.items():
        res[k] = fn()
        times[k] = _median_ms(fn, 5, 1)

    def found(r):
        # the argmax bin: the interpolated Doppler is within half a bin
        return {a.prn: round(a.doppler_hz / step) for a in r if a.detected}

    want = found(res["fft"])
    if sorted(want) != sorted(sc.prns):
        fail(f"[acq32] FFT cube detections {sorted(want)}, planted "
             f"{sorted(sc.prns)}")
    for k in ("dft_highest", "dft_default"):
        if found(res[k]) != want:
            fail(f"[acq32] {k}: detections and bins {found(res[k])}, FFT "
                 f"cube {want}")
    vote = found(res["epoch_vote"])
    plain = acquire_epoch_vote(x, prns, BASEBAND_PLAN, AcqConfig(),
                               device="cpu")
    if [(a.prn, a.detected, a.doppler_hz, a.code_phase_chips)
            for a in plain] != [(a.prn, a.detected, a.doppler_hz,
                                 a.code_phase_chips)
                                for a in res["epoch_vote"]]:
        fail("[acq32] epoch vote on the card differs from its plain version")
    if not vote or any(want.get(p) != b for p, b in vote.items()):
        fail(f"[acq32] epoch vote {vote} against the FFT cube {want}")
    ratio = {k: {a.prn: round(a.peak_ratio, 3) for a in r if a.detected}
             for k, r in res.items()}
    print(f"[acq32] 32 PRNs x {len(AcqConfig().doppler_bins_hz)} bins: FFT "
          f"cube and matmul DFT (both precisions) detect {sorted(want)} in "
          f"bins {want}; epoch vote (= its plain version) {vote}, missing "
          f"{sorted(set(want) - set(vote))}; ms {times}; peak ratios "
          f"{ratio}")
    return {**times, "epoch_vote_missing": sorted(set(want) - set(vote)),
            "dft_product_rel_err": dft_products()}


def wire_format():
    """Phase 16: a REFERENCE_PLAN 1-bit capture of PRN 19 (1.2 s, 20 ms
    bits), packed into SPI words, conditioned on the card
    (reference_to_baseband_device) against the host conditioner within
    1e-5; then ``python -m stm32f4_sdr_gps_torch run <file> --format
    bits16`` as a subprocess on the card must exit 0 and track PRN 19."""
    import tempfile

    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import REFERENCE_PLAN
    from stm32f4_sdr_gps_torch.signal.capture import (
        pack_bits_lsb16, reference_to_baseband, reference_to_baseband_device,
        unpack_bits_lsb16)
    from stm32f4_sdr_gps_torch.signal.simulator import SimSat, \
        simulate_capture

    t0 = time.perf_counter()
    sat = SimSat(prn=19, doppler_hz=2500.0, cn0_dbhz=50.0, delay_ms=4.321)
    x, _ = simulate_capture([sat], num_epochs=1200, plan=REFERENCE_PLAN,
                            seed=17)
    words = pack_bits_lsb16(x)
    host = reference_to_baseband(unpack_bits_lsb16(words))
    dev = reference_to_baseband_device(words)
    if not dev.is_cuda:
        fail("[wire] reference_to_baseband_device did not run on the card")
    err = float(np.abs(dev.cpu().numpy() - host).max())
    if dev.shape[0] != len(host) or err > 1e-5:
        fail(f"[wire] card conditioner vs host: max |diff| {err}")
    wt = torch.as_tensor(words.astype(np.int32), device="cuda")
    ms = _median_ms(lambda: reference_to_baseband_device(wt), 5, 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cap.bin")
        words.tofile(path)
        t1 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "stm32f4_sdr_gps_torch", "run", path,
             "--format", "bits16"], cwd=HERE, capture_output=True,
            text=True, timeout=600, env={**os.environ, "PYTHONPATH": HERE})
        cli_s = time.perf_counter() - t1
    row = [ln for ln in res.stdout.splitlines() if ln.split()[:1] == ["19"]]
    if res.returncode != 0 or not row or "TRACKING" not in row[0]:
        fail(f"[wire] CLI exit {res.returncode}: {res.stdout[-2000:]}"
             f"{res.stderr[-2000:]}")
    print(f"[wire] {len(words)} words -> {dev.shape[0]} baseband samples on "
          f"the card, max |card - host| {err:.2e}, {ms:.3f} ms a call; CLI "
          f"run --format bits16 exit 0 in {cli_s:.1f} s: {row[0].strip()}; "
          f"phase 16 in {time.perf_counter() - t0:.1f} s")
    return {"card_vs_host_max_abs": err, "ms": ms, "cli_s": cli_s}


# ---------------------------------------------------------------- phase 17

def _mesh(devices=8):
    """A 2 x (devices / 2) (time, chan) mesh whose positions all name the
    card: it checks the sharding and the collectives on one card and
    measures no scaling."""
    import torch

    from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh

    return make_mesh(time=2, devices=[torch.device("cuda", 0)] * devices)


def mesh_k1_equal(scenario):
    """17a, first part: phase 3's scenario through StreamingTracker on 8
    positions of the card, K1 once a position a block against one K1
    launch over all the channels, bit for bit in every state plane and
    output: its 32 channels (4 a position) in two 500-epoch blocks, and
    its first 8 channels (1 a position, the shape of the MeshReceiver and
    the two-rank run) in one 1000-epoch block.  Returns the launches of
    each case."""
    import torch

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.parallel.streaming import StreamingTracker
    from stm32f4_sdr_gps_torch.probes.scan_time import CIB
    from stm32f4_sdr_gps_torch.track.scan import track_block
    from stm32f4_sdr_gps_torch.track.state import TrackState

    st, x, u2 = scenario
    cfg = TrackConfig(codes_in_bit=CIB)
    rec = {}
    for c, blocks in ((32, (x[:500], x[500:])), (8, (x,))):
        st_c = TrackState(*(v[:c] for v in st))
        tracker = StreamingTracker(st_c, u2[:c], _mesh(), BASEBAND_PLAN, cfg)
        one = st_c
        _reset_counts()
        for blk in blocks:
            got = tracker.process(blk)
            one, want = track_block(one, blk, u2[:c], BASEBAND_PLAN, cfg)
            torch.cuda.synchronize()
            for f, g, w in zip(want._fields, got, want):
                if not torch.equal(g, w):
                    fail(f"mesh K1 at {c // 8} ch a position: output {f} "
                         "differs from the unsharded run")
            for f, g, w in zip(one._fields, tracker.gather_state(x.device),
                               one):
                if not torch.equal(g, w):
                    fail(f"mesh K1 at {c // 8} ch a position: state plane "
                         f"{f} differs from the unsharded run")
        by_mode = dict(ts.track_scan_cuda.by_mode)
        # each block: once a position at c / 8 channels, once unsharded
        want_modes = {("default", c // 8): 8 * len(blocks),
                      ("default", c): len(blocks)}
        if by_mode != want_modes or ts.track_scan_reference.calls:
            fail(f"mesh K1 at {c // 8} ch a position: K1 {_launched(by_mode)}"
                 f", plain {ts.track_scan_reference.calls}; want "
                 f"{_launched(want_modes)}")
        rec[f"{c // 8}ch_a_position"] = by_mode[("default", c // 8)]
        print(f"[mesh] K1 once a position, 8 positions x {c // 8} ch of the "
              f"card, {len(blocks)} block(s) of {len(blocks[0])} epochs: "
              f"{by_mode[('default', c // 8)]} launches, every output and "
              f"state plane bit for bit one {c}-channel launch")
    return rec


def mesh_phase(sc, scenario, fix_rr):
    """Phase 17: the mesh and multi-process runtime on the card.
    17a: K1 once a position against one launch (mesh_k1_equal), then
    ``dryrun_multichip(8)``; 17b: the MeshReceiver on phase 4's capture
    on a 2 x 4 grid of the card (4 PRNs and 4 ghost channels) to a fix
    within 500 m, |vel| < 10 m/s, K1 launched once a position a block and
    no plain version; 17c: two ranks x 4 positions of the card over gloo
    (``probes/multiprocess_run.py --device cuda --slow``), each within
    its time limit, the distributed 29 s fix within 150 m.  Returns its
    record."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.entry import dryrun_multichip
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import multiprocess_run
    from stm32f4_sdr_gps_torch.runtime.mesh_receiver import MeshReceiver

    rec = {"mesh_k1_launches_bit_equal": mesh_k1_equal(scenario)}
    _reset_counts()
    t0 = time.perf_counter()
    dry = dryrun_multichip(8, device="cuda")
    torch.cuda.synchronize()
    rec["dryrun"] = {
        "wall_s": time.perf_counter() - t0,
        "fix_agreement_m": dry["fix_agreement_m"],
        "acq_rel_err": dry["acq_rel_err"],
        "solutions": dry["solutions"],
        "subframe_time_ms": dry["subframe_time_ms"],
        "k1_launches": {f"{m} x {c} ch": n for (m, c), n
                        in sorted(ts.track_scan_cuda.by_mode.items())},
        "track_scan_plain": ts.track_scan_reference.calls}
    if ts.track_scan_reference.calls:
        fail(f"dryrun_multichip on the card called K1's plain version "
             f"{ts.track_scan_reference.calls} times")
    print(f"[mesh] 17a dryrun_multichip(8) on the card: mesh-vs-single fix "
          f"{dry['fix_agreement_m']:.3f} m, K1 {rec['dryrun']['k1_launches']}"
          f", {rec['dryrun']['wall_s']:.1f} s")

    # 17b: the MeshReceiver on the 29 s capture
    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000)
    rx = MeshReceiver(cfg, _mesh())
    _reset_counts()
    t0 = time.perf_counter()
    report = rx.run(sc.samples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    by_mode = dict(ts.track_scan_cuda.by_mode)
    blocks = rx.profiler.stages["track"].calls
    if (counts["track_scan"] != 8 * blocks or set(by_mode) != {("default", 1)}
            or counts["track_scan_plain"] or counts["epl"]
            or counts["epl_plain"]):
        fail(f"17b: {counts}, K1 {_launched(by_mode)} for {blocks} blocks "
             "(want K1 once a position a block, 1 channel each)")
    if not report.solutions:
        fail("17b: the MeshReceiver made no fix")
    sol = report.solutions[-1]
    err = float(np.linalg.norm(sol.rr - sc.rr_true))
    vel = float(np.linalg.norm(sol.vel))
    from_p4 = float(np.linalg.norm(sol.rr - fix_rr))
    if not (err < 500.0 and vel < 10.0 and from_p4 < 5.0):
        fail(f"17b: fix error {err:.1f} m / |vel| {vel:.2f} m/s / "
             f"{from_p4:.2f} m from phase 4's fix (bands 500 m, 10 m/s, 5 m)")
    if "gather" in rx.profiler.stages:
        fail("17b: the default config gathered the tracker's state "
             f"{rx.profiler.stages['gather'].calls} times")
    rec["mesh_receiver_29s"] = {
        "fix_error_m": err, "vel_mps": vel, "from_phase4_fix_m": from_p4,
        "wall_s": wall, "blocks": blocks,
        "track_ms_per_block": rx.profiler.stages["track"].mean_s * 1e3,
        "k1_launches": counts["track_scan"]}
    print(f"[mesh] 17b MeshReceiver, 4 PRNs + 4 ghosts on 2 x 4 positions of "
          f"the card: fix {err:.2f} m, |vel| {vel:.2f} m/s, "
          f"{rec['mesh_receiver_29s']['from_phase4_fix_m']:.2f} m from phase "
          f"4's fix; {wall:.2f} s wall, track "
          f"{rec['mesh_receiver_29s']['track_ms_per_block']:.2f} ms a block; "
          f"K1 {_launched(by_mode)}")
    print(rx.profiler.report())

    # 17c: two ranks x 4 positions of the card over gloo
    t0 = time.perf_counter()
    ranks = multiprocess_run.launch("cuda", fix=sc, timeout_s=300.0)
    # each rank checked its own counts (K1 once a position a block, no
    # plain call, from 0 each stage); held here again on its record
    for r in ranks:
        for stage in ("tracking", "decode", "fix"):
            got = r[stage]["launches"]
            want = len(r["positions"]) * r[stage]["blocks"]
            if (got["k1"] != want or got["plain"]
                    or set(got["k1_by_mode"]) != {"default x 1 ch"}):
                fail(f"17c rank {r['rank']} {stage}: {got}, want {want} K1 "
                     "launches at 1 ch and no plain call")
    rec["two_ranks"] = {
        "wall_s": time.perf_counter() - t0,
        "fix_error_m": ranks[0]["fix"]["fix_error_m"],
        "k1_launches": {f"rank{r['rank']}_{stage}": r[stage]["launches"]["k1"]
                        for r in ranks for stage in ("tracking", "decode",
                                                     "fix")},
        "ranks": ranks}
    for r in ranks:
        print(f"[mesh] 17c rank {r['rank']}: {r}")
    print(f"[mesh] 17c two ranks x 4 positions of the card over gloo: "
          f"distributed fix {ranks[0]['fix']['fix_error_m']:.2f} m, "
          f"{rec['two_ranks']['wall_s']:.1f} s with the captures' simulation")
    return rec


# ---------------------------------------------------------------- phases 18-21

# the final fix on phase 4's capture of the reference scan on the CPU, in
# each package (printed by RUN_SLOW=1 pytest -s tests/
# test_torch_entry_jnp_scan.py::test_reference_scan_fix_matches_jax),
# printed beside phase 18's card run
REFSCAN_CPU_FIX_M = {"jax": 83.77, "port": 88.50}

# phase 20's soak: 30 s of wire capture at twice real time (the JAX
# package's round-5 pace, tests/test_soak_smoke.py:3-5)
SOAK = dict(capture_s=30, rate_x=2.0, cn0=48.0, seed=9)


# phase 23's wire capture: tools/tpu_e2e.py's defaults
WIRE = dict(cib=20, duration_ms=29_000, cn0=48, seed=5)

# phase 25's deep chain: tests/test_e2e_slow.py:70-90 at 29 dBHz on the two
# seeds of tools/ext_pll_tune.py's set besides phase 12's seed 21 (the JAX
# package's tools/deep_cold_probe.py fixes at 259.9 m on 7 and 194.1 m on
# 42 on the CPU)
DEEP_COLD_CN0 = 29.0
DEEP_COLD_SEEDS = (7, 42)


def _simulated(procs, directory, name, save, *args):
    """A fix_scenario simulated in ``procs``, a pool of spawned processes
    (the main process keeps its cores for the card's phases): ``save`` (a
    probes module's save function) writes it to ``name``.npz in
    ``directory`` with ``args``; returns {"samples", "rr_true", "prns",
    "seconds"}."""
    import numpy as np

    t0 = time.perf_counter()
    path = os.path.join(directory, f"{name}.npz")
    procs.submit(save, path, *args).result(timeout=900)
    with np.load(path) as z:
        rec = {"samples": z["samples"], "rr_true": z["rr_true"],
               "prns": tuple(int(p) for p in z["prns"])}
    os.remove(path)
    return {**rec, "seconds": time.perf_counter() - t0}


def _prepare_native(pool, procs):
    """Phases 19-20's, 22-23's and 25's inputs, made in the background from
    phase 18 on: native/ rebuilt on this machine (make -B: never a library
    built elsewhere), then the wire captures of the three parity suites,
    the soak and phase 23, one capture_gen each, phase 22's impaired
    fix_scenario and phase 25's two deep-chain fix_scenarios (each in a
    process of ``procs``), all at once in ``pool``.  Returns when phases 19-20's captures are ready: {name:
    (words, truth)} under "captures", and the futures of phase 23's
    capture ("wire"), phase 22's ("impaired_fix") and phase 25's
    ("deep_cold_<seed>") under "later"."""
    import tempfile

    from stm32f4_sdr_gps_torch.probes import deep_cold
    from stm32f4_sdr_gps_torch.probes import firmware_parity as fp
    from stm32f4_sdr_gps_torch.probes import soak, stress
    from stm32f4_sdr_gps_torch.runtime import native

    t0 = time.perf_counter()
    subprocess.run(["make", "-B", "-s", "-C", native.NATIVE_DIR,
                    "libsdr_native.so", "capture_gen"], check=True,
                   capture_output=True, timeout=300)
    build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
    later = {"wire": pool.submit(native.capture_gen, tmp, "wire_e2e", **WIRE),
             "impaired_fix": pool.submit(_simulated, procs, tmp,
                                         "impaired_fix",
                                         stress.save_impaired_fix),
             **{f"deep_cold_{seed}": pool.submit(
                 _simulated, procs, tmp, f"deep_cold_{seed}",
                 deep_cold.save_scenario, DEEP_COLD_CN0, seed)
                for seed in DEEP_COLD_SEEDS}}
    jobs = {s: pool.submit(fp.generate, s, tmp) for s in fp.SUITES}
    jobs["soak"] = pool.submit(
        soak.capture, SOAK["capture_s"], SOAK["cn0"], SOAK["seed"], tmp)
    caps = {s: j.result() for s, j in jobs.items()}
    return {"captures": caps, "dir": tmp, "build_s": build_s,
            "seconds": time.perf_counter() - t0, "later": later}


def reference_scan_phase(sc, k1_fix_err):
    """Phase 18: the reference scan on the card.  ``entry_jnp_scan()`` on
    the card against ``entry_jnp_scan(device="cpu")`` under _compare's
    rules, then ``Receiver.run`` with ``in_kernel_scan=False`` on phase
    4's capture to a fix within 500 m, |vel| < 10 m/s, with full
    ephemerides and no launch of K1 or K2 (nor of a plain version) in
    either.  Returns its record."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.config import TrackConfig
    from stm32f4_sdr_gps_torch.entry import entry_jnp_scan
    from stm32f4_sdr_gps_torch.ops.track_scan import state_from_track_state

    fn, args = entry_jnp_scan()
    if args[1].device.type != "cuda":
        fail(f"entry_jnp_scan() chose {args[1].device}, not the card")
    _reset_counts()
    t0 = time.perf_counter()
    st_k, out_k = fn(*args)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    counts = _counts()
    if any(counts.values()):
        fail(f"entry_jnp_scan on the card launched {counts}")
    fn_c, args_c = entry_jnp_scan(device="cpu")
    for a, b in zip(args, args_c):
        same = (all(torch.equal(x.cpu(), y) for x, y in zip(a, b))
                if isinstance(a, tuple) else torch.equal(a.cpu(), b))
        if not same:
            fail("entry_jnp_scan: the card's and the CPU's inputs differ")
    t0 = time.perf_counter()
    st_r, out_r = fn_c(*args_c)
    cpu_s = time.perf_counter() - t0
    err = _compare(state_from_track_state(st_k), out_k,
                   state_from_track_state(st_r), out_r,
                   "entry_jnp_scan 32 ch x 100 epochs, card vs CPU")
    print(f"[refscan] entry_jnp_scan 32 ch x 100 epochs: card {card_s:.2f} s"
          f", CPU {cpu_s:.2f} s; counts on the card {counts}")
    report, rx, counts, tracked, wall = _run_receiver(
        sc, TrackConfig(in_kernel_scan=False), "refscan")
    if any(counts.values()):
        fail(f"refscan: the reference-scan path launched {counts}")
    sol = report.solutions[-1]
    err_m = float(np.linalg.norm(sol.rr - sc.rr_true))
    print(f"[refscan] fix {err_m:.2f} m on the reference scan on the card, "
          f"beside phase 4's {k1_fix_err:.2f} m through K1, and the CPU's "
          f"reference scans on this capture: the JAX package's "
          f"{REFSCAN_CPU_FIX_M['jax']} m, the port's "
          f"{REFSCAN_CPU_FIX_M['port']} m; {wall:.1f} s wall, track "
          f"{rx.profiler.stages['track'].mean_s * 1e3:.1f} ms a block")
    return {"entry_jnp_scan": {"max_abs_err": err, "card_s": card_s,
                               "cpu_s": cpu_s},
            "fix_error_m": err_m, "vel_mps": float(np.linalg.norm(sol.vel)),
            "k1_fix_error_m": k1_fix_err, "wall_s": wall,
            "tracked_epochs": tracked,
            "track_ms_per_block": rx.profiler.stages["track"].mean_s * 1e3}


def firmware_oracle_phase(native_caps):
    """Phase 19: the firmware oracle against K1 on the card.  Each suite's
    capture (generated in the background since phase 18) through the
    oracle and the port's Receiver on the card (the default backend: K1
    on every tracking block, no plain version, no K2), with the suite's
    own bars (probes/firmware_parity.py); then the wire-format suite's
    2.3 s PRN 19 capture to decoded subframes.  Returns its record."""
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import firmware_parity as fp
    from stm32f4_sdr_gps_torch.runtime import native

    if native.get_lib() is None:
        fail("native library (native/libsdr_native.so) unavailable")
    rec = {"native_build_s": native_caps["build_s"],
           "native_prepare_s": native_caps["seconds"]}
    for suite in [*fp.SUITES, "wire_format"]:
        _reset_counts()
        try:
            r = fp.run_suite(suite, "cuda",
                             capture=native_caps["captures"].get(suite))
        except fp.ParityError as e:
            fail(f"[oracle] {suite}: a bar failed: {e.args}")
        counts = _counts()
        rx = r.pop("receiver")
        blocks = rx.profiler.stages["track"].calls
        by_mode = dict(ts.track_scan_cuda.by_mode)
        if (counts["track_scan"] != blocks or counts["track_scan_plain"]
                or counts["epl"] or counts["epl_plain"]
                or {m for m, _ in by_mode} != {"default"}):
            fail(f"[oracle] {suite}: {counts}, K1 {_launched(by_mode)} for "
                 f"{blocks} blocks (want K1 on every block and nothing else)")
        r["launches"] = counts["track_scan"]
        r["blocks"] = blocks
        print(f"[oracle] {suite} on the card through K1 ({_launched(by_mode)}"
              f"): every bar holds; {json.dumps(r, default=str)}")
        rec[suite] = r
    return rec


def soak_phase(native_caps):
    """Phase 20: the streaming soak on the card at SOAK's pace: zero
    dropped epochs, all but at most 1000 epochs consumed, 4 channels
    tracking, K1 on every block and nothing else; what it decoded (each
    PRN's subframe ledger, subframes and bits, and every fix) equal to a
    direct ``Receiver.run`` of the same capture on the card.  Its fixes
    are printed: on this capture the JAX kernel makes none (PERF.md)."""
    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.probes import soak
    from stm32f4_sdr_gps_torch.runtime import native
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
    from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband

    _reset_counts()
    out = soak.run_soak(capture_s=SOAK["capture_s"], rate_x=SOAK["rate_x"],
                        cn0=SOAK["cn0"], seed=SOAK["seed"], device="cuda",
                        state_dir=native_caps["dir"])
    counts = _counts()
    print(f"[soak] {json.dumps(out)}")
    print(f"[soak] {out['capture_s']:.0f} s at {out['rate_x']}x real time on "
          f"the card: sustained {out['sustained_rt_x']:.2f}x, ring high-water"
          f" {out['ring_high_water_ms']:.0f} of {out['ring_capacity_ms']} ms,"
          f" consumer stall {out['consumer_stall_s']:.2f} s, dropped "
          f"{out['dropped_epochs']} epochs, {out['fixes']} fixes; counts "
          f"{counts}")
    if not (out["ok"] and out["channels_tracking"] == 4):
        fail(f"[soak] {out}")
    if (counts["track_scan"] != out["blocks"] or counts["track_scan_plain"]
            or counts["epl"] or counts["epl_plain"]):
        fail(f"[soak] counts {counts} for {out['blocks']} blocks")
    words, truth = native_caps["captures"]["soak"]
    rx = Receiver(ReceiverConfig(prns=tuple(s["prn"] for s in truth["sats"]),
                                 track_block_epochs=500))
    rx.run(reference_to_baseband(native.unpack_bits16(words)))
    direct = soak.ledger(rx)
    if {k: out[k] for k in direct} != direct:
        fail(f"[soak] the streamed run decoded {[out[k] for k in direct]}, "
             f"a direct Receiver.run of the capture {direct}")
    print(f"[soak] decoded exactly what a direct Receiver.run of the capture "
          f"does: ledgers {direct['channels']}, "
          f"{len(direct['fixes_ecef_m'])} fixes")
    return {**out, "launches": counts["track_scan"]}


def _busy_share(trace_path, window_name):
    """From a Chrome trace: the window (the span of the host's user
    annotation ``window_name``), the union of the card's kernel and
    memcpy / memset intervals inside it, and the device operations' time
    inside it by name (microseconds)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e["name"] == window_name
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        fail(f"[trace] {len(win)} events named {window_name} in the trace")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev = sorted((max(float(e["ts"]), lo),
                  min(float(e["ts"]) + float(e["dur"]), hi), e["name"])
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, lo
    by_name = {}
    for a, b, name in dev:
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if b > end:
            busy += b - max(a, end)
            end = b
    return hi - lo, busy, by_name


def trace_phase(sc):
    """Phase 21: Profiler.device_trace around 3 warm process_block calls of
    phase 4's main path (K1 on the card); prints the card's busy share
    of the window of those calls (a profiler annotation) and the top 5
    device operations by time (not gated).  Returns its record."""
    import tempfile

    import torch

    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

    cfg = ReceiverConfig(prns=sc.prns, track_block_epochs=1000)
    rx = Receiver(cfg)
    spe = cfg.plan.samples_per_epoch
    acq = cfg.acq.noncoherent_epochs
    rx.acquire_all(sc.samples)
    rx.start_tracking(sc.samples[acq * spe:], start_epoch=acq)
    rx.epoch_cursor = acq
    blocks = [sc.samples[(acq + 1000 * k) * spe:(acq + 1000 * (k + 1)) * spe]
              for k in range(5)]
    for b in blocks[:2]:                  # warm: the first blocks' calls
        rx.process_block(b)
    torch.cuda.synchronize()
    _reset_counts()
    with tempfile.TemporaryDirectory() as logdir:
        with rx.profiler.device_trace(logdir):
            with torch.profiler.record_function("chip_smoke.blocks"):
                t0 = time.perf_counter()
                for b in blocks[2:]:
                    rx.process_block(b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        window, busy, by_name = _busy_share(
            os.path.join(logdir, "trace.json"), "chip_smoke.blocks")
    counts = _counts()
    if counts["track_scan"] != 3:
        fail(f"[trace] 3 traced blocks launched {counts}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    share = busy / window if window > 0 else None
    print(f"[trace] 3 warm process_block calls of the main path: window "
          f"{window / 1e3:.2f} ms, the card busy {busy / 1e3:.2f} ms ("
          + (f"{100 * share:.1f} %" if by_name else "no device event in the "
             "trace: not measured")
          + f"), {wall * 1e3:.1f} ms host wall with the profiler on; top 5 "
          f"device operations (ms): "
          f"{ {n[:60]: round(t / 1e3, 4) for n, t in top} }")
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "busy_share": share if by_name else None,
            "top5_device_ms": {n: t / 1e3 for n, t in top},
            "launches": counts["track_scan"], "wall_ms": wall * 1e3}


# ---------------------------------------------------------------- phases 22-23

def _k1_only(label, counts, launches):
    """Fails unless ``counts`` holds ``launches`` K1 launches and no other
    kernel launch or plain-version call."""
    if (counts["track_scan"] != launches or counts["track_scan_plain"]
            or counts["epl"] or counts["epl_plain"]):
        fail(f"[stress] {label}: counts {counts}, want {launches} K1 "
             "launches and nothing else")


def stress_phase(impaired_fix):
    """Phase 22: every scenario of probes/stress.py through the port's
    default path on the card (the tracking-scan kernel K1) under its
    suite's bars; the three dynamics runs also held to K1's plain version
    on the CPU under _compare's rules; the 29 s impaired cold start to a
    fix with one K1 launch a block.  Returns its record."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.ops.track_scan import state_from_track_state
    from stm32f4_sdr_gps_torch.probes import stress

    rec = {"chirp_truth_diff": stress.check_chirp_truth()}

    def timed(label, fn):
        _reset_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
        except stress.StressError as e:
            fail(f"[stress] {label}: a bar failed: {e.args}")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _counts()

    for name, fn in (("impairments", stress.run_impairments),
                     ("boundary", stress.run_boundary),
                     ("eight", stress.run_eight)):
        (report, rx, bars), secs, counts = timed(name, lambda: fn("cuda"))
        blocks = rx.profiler.stages["track"].calls
        _k1_only(name, counts, blocks)
        rec[name] = {"launches": counts["track_scan"], "seconds": secs,
                     "bars": {str(k): v for k, v in
                              (bars.items() if isinstance(bars, dict)
                               else enumerate(bars))}}
        print(f"[stress] {name}: every bar holds through K1 on the card; "
              f"{counts['track_scan']} launches, {secs:.1f} s; {bars}")

    for name in stress.DYNAMICS:
        (st_k, out_k, bars), secs, counts = timed(
            name, lambda: stress.run_dynamics(name, "cuda"))
        _k1_only(name, counts, 1)
        st_r, out_r, _ = stress.run_dynamics(name, "cpu", in_kernel_scan=True)
        err = _compare(state_from_track_state(st_k), out_k,
                       state_from_track_state(st_r), out_r,
                       f"stress dynamics {name}, K1 vs plain", bits=False)
        rec[name] = {"launches": 1, "seconds": secs, "bars": bars,
                     "max_abs_err": err}
        print(f"[stress] dynamics {name}: the bar holds through K1 on the "
              f"card; 1 launch, {secs:.1f} s; {bars}")

    (_, pll), secs, counts = timed("coherent",
                                   lambda: stress.run_coherent("cuda"))
    _k1_only("coherent", counts, len(stress.COHERENT_RUNS))
    rec["coherent"] = {"launches": counts["track_scan"], "seconds": secs,
                       "pll": pll}
    print(f"[stress] coherent claims: every claim holds through K1 on the "
          f"card; {counts['track_scan']} launches, {secs:.1f} s; PLL runs "
          f"(errors, bits, Doppler p95 Hz) {pll}")

    cfg = stress.impaired_fix_config(impaired_fix["prns"])
    bit_epochs = {}
    (report, rx), secs, counts = timed(
        "impaired_fix", lambda: stress.run_receiver(
            impaired_fix["samples"], cfg, bit_epochs=bit_epochs))
    blocks = rx.profiler.stages["track"].calls
    _k1_only("impaired_fix", counts, blocks)
    if blocks != 29:
        fail(f"[stress] impaired_fix: {blocks} blocks, want 29")
    track_ms = rx.profiler.stages["track"].mean_s * 1e3
    ledger = {ch.prn: (ch.subframe_count, ch.eph.has_full_set,
                       ch.bit_count) for ch in report.channels}
    fix = {"launches": counts["track_scan"], "seconds": secs,
           "solutions": len(report.solutions), "track_ms_per_block": track_ms,
           "simulate_s": impaired_fix["seconds"],
           "ledger_subframes_full_bits": {str(k): v for k, v in
                                          ledger.items()}}
    try:
        if all(ch.eph.has_full_set for ch in report.channels):
            err, vel = stress.check_impaired_fix(report,
                                                 impaired_fix["rr_true"])
            fix.update(outcome="fix", fix_error_m=err, vel_mps=vel)
            said = (f"fix {err:.2f} m (bar {stress.FIX_BAR_M:.0f}), |vel| "
                    f"{vel:.3f} m/s, {len(report.solutions)} solutions")
        else:
            # the reference's own outcome on the other side of PRN 15's
            # fade (ROADMAP Queue 3, "The impaired fix turns on one fade")
            stress.check_fade_outcome(report, bit_epochs)
            fix["outcome"] = "fade"
            said = (f"no fix: PRN {stress.FADE_PRN}'s bit split at epochs "
                    f"{stress.FADE_SPLIT} on its fade, subframe 3 lost, the "
                    "other channels' sets full: the outcome of the JAX "
                    "Pallas kernel on its full-readback path")
    except stress.StressError as e:
        fail(f"[stress] impaired_fix: {e.args}; ledger {ledger}")
    rec["impaired_fix"] = fix
    print(f"[stress] impaired 29 s cold start: {said}; ledger (subframes, "
          f"full set, bits) {ledger}; {counts['track_scan']} K1 launches "
          f"for {blocks} blocks; {secs:.2f} s wall, track {track_ms:.3f} ms "
          "a block")
    print(rx.profiler.report())
    return rec


def wire_phase(words, truth):
    """Phase 23: probes/wire_e2e.py at tools/tpu_e2e.py's defaults on the
    card: the last fix within 500 m, every block a CUDA tensor conditioned
    on the card, no samples copied from the host (``epochs_on``'s numpy
    branch never taken), K1 on every block and nothing else.  Returns the
    run's result."""
    from stm32f4_sdr_gps_torch.probes import wire_e2e
    from stm32f4_sdr_gps_torch.utils import profiling

    _reset_counts()
    out, rx = wire_e2e.run(words, truth, cib=WIRE["cib"])
    counts = _counts()
    print(f"[wire] {json.dumps(out)}")
    if rx.device.type != "cuda":
        fail(f"[wire] the receiver ran on {rx.device}")
    if not out["pass"]:
        fail(f"[wire] no pass: {out}")
    copies = profiling.counters.get("upload.samples", 0)
    if out["blocks_on_device"] != out["blocks"] or copies:
        fail(f"[wire] {out['blocks_on_device']} of {out['blocks']} blocks "
             f"were CUDA tensors; {copies} host copies")
    _k1_only("wire", counts, out["blocks"])
    print(f"[wire] {WIRE['duration_ms'] / 1e3:.0f} s wire capture to a fix "
          f"on the card: last fix {out['fix_error_m_last']:.2f} m, "
          f"{out['blocks']} blocks, every one a CUDA tensor and through K1, "
          f"0 host copies; cold start {out['cold_start_s']:.2f} s, upload + "
          f"conditioning {out['upload_s']:.3f} s in {out['uploads']} chunks, "
          f"sustained {out['sustained_rt_x']:.1f}x real time")
    return {**out, "launches": counts["track_scan"]}


# ---------------------------------------------------------------- phase 24

# the subframes the JAX package's tools/host_cost_probe.py decodes with
# measure(C, 1000, 30) at each width (on the CPU); phase 24's host decode of
# the same digests must decode as many
JAX_HOST_SUBFRAMES = {32: 98, 64: 196, 128: 392, 256: 782, 512: 1564,
                      1024: 3128}
CAPACITY_BLOCKS = 20        # timed blocks a width (after 2 warm-up blocks)
HOST_BLOCKS = 30            # host_cost.measure's blocks (one warm-up)


def capacity_phase():
    """Phase 24: probes/capacity.py at 32-1024 channels on the card (the
    per-block program's K1, rest on the device and readback, each width's
    digest the 32-channel digest tiled, the 32-channel one the Receiver's
    own), the host decode at each width held to the JAX tool's subframe
    count, K1 in its default mode and nothing else; prints the table.
    Returns its record."""
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import capacity, host_cost

    _reset_counts()
    try:
        recs = capacity.measure(capacity.WIDTHS, CAPACITY_BLOCKS, HOST_BLOCKS)
    except capacity.CapacityError as e:
        fail(f"[capacity] {e}")
    counts = _counts()
    by_mode = dict(ts.track_scan_cuda.by_mode)
    want = {("default", c): CAPACITY_BLOCKS + 2 + (c == 32)
            for c in capacity.WIDTHS}
    if (by_mode != want or counts["track_scan_plain"] or counts["epl"]
            or counts["epl_plain"]):
        fail(f"[capacity] {counts}, K1 {_launched(by_mode)}; want "
             f"{_launched(want)} and nothing else")
    for r in recs:
        c, tiled = r["channels"], r["tiled"]
        if r["subframes_decoded"] != JAX_HOST_SUBFRAMES[c]:
            fail(f"[capacity] {c} ch: the host decoded "
                 f"{r['subframes_decoded']} subframes, the JAX tool "
                 f"{JAX_HOST_SUBFRAMES[c]}")
        print(f"[capacity] {c} ch (G = {r['G']}): digest == the 32-channel "
              f"digest tiled, {len(tiled['exact'])} leaves bit for bit"
              + (f", float leaves within {tiled['rel']} relative"
                 if tiled["rel"] else "")
              + f"; {r['subframes_decoded']} subframes decoded (JAX tool "
              f"{JAX_HOST_SUBFRAMES[c]})")
    print("[capacity] the 32-channel digest == the Receiver's "
          "_track_and_digest_carried + digest_to_host, bit for bit")
    print(capacity.table(recs))
    cpu = host_cost.cpu_model()
    print(f"[capacity] K1 {_launched(by_mode)}; host CPU: {cpu}")
    return {"widths": recs, "host_cpu": cpu,
            "launches": {f"{m}_{c}ch": n for (m, c), n in by_mode.items()}}


# ---------------------------------------------------------------- phase 25

# tools/ext_pll_tune.py's table (the JAX package's reference scan on the
# CPU, 75 bits on seeds 42, 7 and 21): the ext loop's bit errors of 222 at
# each C/N0.  The card's may exceed them by at most EXT_MARGIN (PERF.md).
JAX_EXT_ERRS = {26.0: 0, 25.0: 0, 24.0: 0, 23.0: 2}
EXT_MARGIN = 2


def _acq_text(r):
    return (f"{'detected' if r['detected'] else 'missed'} "
            f"{r['doppler_hz']:.1f} Hz {r['code_phase_chips']:.3f} chip, "
            f"peak ratio {r['peak_ratio']:.3f} (threshold "
            f"{r['detect_ratio']})")


def sensitivity_phase(deep):
    """Phase 25: the seven claims of probes/sensitivity.py on the card
    under their bars (the tracking claims through K1's default mode, one
    launch each; the acquisition claims with no K1 launch), then
    probes/ext_pll.py's sweep through K1's coherent_pll modes, the ext
    loop's errors within EXT_MARGIN of the JAX table, then the deep chain
    at 29 dBHz on DEEP_COLD_SEEDS (``deep``: {seed: the background
    capture}), every block through K1 with pll_ext_bits = 5 and held to
    K1's plain version on the CPU from the same entering state in worker
    processes (deep_cold.check_held: every part at a marginal decision),
    the run held to the bar or to exactly the seed's known miss
    (deep_cold.check_outcome).  Returns its record."""
    from types import SimpleNamespace

    from stm32f4_sdr_gps_torch.config import DEEP_COHERENT_TRACK
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.probes import deep_cold, ext_pll
    from stm32f4_sdr_gps_torch.probes import sensitivity as sens

    def k1_check(label, want, modes=None):
        """K1's launches by (mode, C) must be ``want`` or, given ``modes``,
        ``want`` launches in all, every one in a mode of ``modes``; no
        other kernel or plain version."""
        counts = _counts()
        by_mode = dict(ts.track_scan_cuda.by_mode)
        ok = (by_mode == want if modes is None else
              counts["track_scan"] == want
              and {m for m, _ in by_mode} == modes)
        if (not ok or counts["track_scan_plain"] or counts["epl"]
                or counts["epl_plain"]):
            wanted = (_launched(want) or "no launch" if modes is None
                      else f"{want} in {sorted(modes)}")
            fail(f"[sens] {label}: {counts}, K1 {_launched(by_mode)}; want "
                 f"{wanted} and nothing else")
        return {f"{m}_{c}ch": n for (m, c), n in by_mode.items()}

    rec = {}
    for name, fn in sens.CLAIMS.items():
        _reset_counts()
        t0 = time.perf_counter()
        try:
            out = fn("cuda")
        except sens.SensitivityError as e:
            fail(f"[sens] {name}: a bar failed: {e.args}")
        secs = time.perf_counter() - t0
        launches = k1_check(name, {("default", 1): 1}
                            if name in sens.TRACK_CLAIMS else {})
        rec[name] = {**out, "launches": launches, "seconds": secs}
        if "runs" in out:
            said = "; ".join(f"seed {k}: {_acq_text(r)}"
                             for k, r in out["runs"].items())
            if "hits" in out:
                said = f"{out['hits']} of 5 hits; {said}"
        elif name in sens.TRACK_CLAIMS:
            said = (f"Doppler {out['doppler_err_hz']:+.3f} Hz, code "
                    f"{out['code_err_chips']:+.4f} chip, K1 {launches}")
        else:
            said = "; ".join(f"{k}: {_acq_text(r)}" for k, r in out.items())
        print(f"[sens] {name}: holds on the card ({secs:.1f} s); {said}")

    _reset_counts()
    t0 = time.perf_counter()
    rows = ext_pll.sweep(device="cuda", ext=DEEP_COHERENT_TRACK)
    secs = time.perf_counter() - t0
    n = len(ext_pll.CN0S) * len(ext_pll.SEEDS)
    launches = k1_check("ext_pll", {("coherent_pll", 1): n,
                                    ("coherent_pll_ext5", 1): n})
    for r in rows:
        bar = (f" (JAX {JAX_EXT_ERRS[r['cn0']]}, bar "
               f"{JAX_EXT_ERRS[r['cn0']] + EXT_MARGIN})"
               if r["loop"] == "ext" else "")
        print(f"[sens] ext_pll cn0={r['cn0']:4.1f} {r['loop']:8s} errs="
              f"{r['errs']:4d}/{r['bits']}{bar} dop95={r['dop95_hz']:6.2f} Hz")
    for r in rows:
        if (r["loop"] == "ext"
                and r["errs"] > JAX_EXT_ERRS[r["cn0"]] + EXT_MARGIN):
            fail(f"[sens] ext_pll at {r['cn0']} dBHz: {r['errs']} bit "
                 f"errors, the JAX table {JAX_EXT_ERRS[r['cn0']]} + "
                 f"{EXT_MARGIN}")
    rec["ext_pll"] = {"rows": rows, "launches": launches, "seconds": secs}
    print(f"[sens] ext_pll: the ext loop within {EXT_MARGIN} bit errors of "
          f"the JAX table at every C/N0 through K1 ({launches}); "
          f"{secs:.1f} s")

    procs = ProcessPoolExecutor(
        max(1, (os.cpu_count() or 2) - 1),
        mp_context=multiprocessing.get_context("spawn"),
        initializer=deep_cold.worker_init)
    for seed, cap in deep.items():
        sc = SimpleNamespace(**{k: cap[k] for k in ("samples", "rr_true",
                                                     "prns")})
        _reset_counts()
        t0 = time.perf_counter()
        out = deep_cold.run_traced(sc, "cuda", procs=procs)
        held_s = time.perf_counter() - t0 - out["wall_s"]
        del out["trace"]
        blocks = out["stages"]["track"]["calls"]
        out["launches"] = k1_check(f"deep_cold seed {seed}", blocks,
                                   modes={"coherent_pll_ext5"})
        print("\n".join(f"[sens] deep_cold seed {seed}: {line.strip()}"
                        for line in deep_cold.report_lines(out)))
        label = f"[sens] deep chain at {DEEP_COLD_CN0} dBHz, seed {seed}"
        try:
            deep_cold.check_held(out["parts"])
        except deep_cold.DeepColdError as e:
            fail(f"{label}: {e.args[0]}")
        held = (f"K1 held to its plain version on the CPU on all {blocks} "
                f"blocks from the card's entering state ({held_s:.1f} s "
                "more): " + ("no part" if not out["parts"] else "parts "
                             + "; ".join(
                                 f"PRN {p['prn']} in the block at "
                                 f"{p['block']}, epoch {p['epoch']}, after a "
                                 f"{p['marginal']} decision at "
                                 f"{p['marginal_epoch']}"
                                 for p in out["parts"])))
        print(f"{label}: {held}")
        try:
            how = deep_cold.check_outcome(out, seed)
        except deep_cold.DeepColdError as e:
            fail(f"{label}: {e.args[0]} (ROADMAP Queue 3, \"The 29 dBHz "
                 "fix floor\")")
        out.update(simulate_s=cap["seconds"], outcome=how,
                   held_extra_s=held_s)
        rec[f"deep_cold_29dbhz_seed{seed}"] = out
        if how == "fix":
            said = (f"fix {out['fix_error_m']:.2f} m (bar "
                    f"{deep_cold.FIX_BAR_M:.0f}), every set full and every "
                    "channel synced")
        else:
            prn, n = deep_cold.KNOWN_MISS[seed]
            said = (f"BAR NOT MET: no fix, PRN {prn} short of a set with {n} "
                    "subframes, every other set full, every channel synced: "
                    "the known miss of this seed (deep_cold.KNOWN_MISS; "
                    "ROADMAP Queue 3, \"The 29 dBHz fix floor\")")
        print(f"{label}: {said}; K1 {out['launches']} for {blocks} blocks; "
              f"{out['wall_s']:.2f} s wall with the held blocks' copies "
              f"({out['x_real_time']:.1f}x real time)")
    procs.shutdown()
    return rec


# ---------------------------------------------------------------- phase 26

def graphs_phase():
    """Phase 26: the captured programs against their eager runs
    (probes/graph_replay.py, every check of ``check``), their per-block
    times, K1's program at 32 channels with its blocks on the card, and
    the card's busy share of two warm such blocks, eager and replayed, by
    phase 21's method.  Returns its record."""
    import contextlib
    import tempfile

    import torch

    from stm32f4_sdr_gps_torch.probes import graph_replay as gr
    from stm32f4_sdr_gps_torch.utils import graphs
    from stm32f4_sdr_gps_torch.utils.profiling import Profiler

    t0 = time.perf_counter()
    data = gr.scenario()
    print(f"[graphs] {len(data[0])} blocks of {gr.BLOCK} epochs of "
          f"{len(gr.PRNS)} satellites simulated in "
          f"{time.perf_counter() - t0:.1f} s")
    rec = {}
    for name, widths in gr.WIDTHS.items():
        for c in widths:
            try:
                eager = gr.run(name, c, data, True)
                replayed = gr.run(name, c, data, False)
                gr.check(name, c, eager, replayed)
            except gr.GraphCheckError as e:
                fail(f"[graphs] {e}")
            s = gr.summary(eager, replayed)
            rec[f"{name}_{c}ch"] = s

            def ms(v):
                return [round(x, 3) for x in v]

            print(f"[graphs] {name} {c} ch: replayed = eager bit for bit "
                  f"over {gr.BLOCKS} blocks and one at {c - 1} ch, block n "
                  f"unchanged by n + 1; launches {s['launches']}, "
                  f"{s['captures']} captures, warm-up launches "
                  f"{s['warmup_launches']}; host wall ms eager "
                  f"{ms(s['eager']['wall_ms'])}, replayed "
                  f"{ms(s['replayed']['wall_ms'])}; event span ms eager "
                  f"{ms(s['eager']['span_ms'])}, replayed "
                  f"{ms(s['replayed']['span_ms'])}")
    # K1's program again with the blocks already on the card (the wire
    # path's hand-over): its times without the block's host copy
    try:
        eager = gr.run("k1_carried", 32, data, True, device_blocks=True)
        replayed = gr.run("k1_carried", 32, data, False, device_blocks=True)
        gr.check("k1_carried", 32, eager, replayed)
    except gr.GraphCheckError as e:
        fail(f"[graphs] blocks on the card: {e}")
    s = gr.summary(eager, replayed)
    rec["k1_carried_32ch"]["device_blocks"] = s
    print(f"[graphs] k1_carried 32 ch, blocks on the card: replayed = "
          f"eager bit for bit; host wall ms eager "
          f"{[round(x, 3) for x in s['eager']['wall_ms']]}, replayed "
          f"{[round(x, 3) for x in s['replayed']['wall_ms']]}")
    busy = {}
    for label, eager in (("eager", True), ("replayed", False)):
        with tempfile.TemporaryDirectory() as logdir:
            @contextlib.contextmanager
            def trace():
                with Profiler().device_trace(logdir):
                    with torch.profiler.record_function("graph_replay.blocks"):
                        yield

            gr.run("k1_carried", 32, data, eager, trace=trace,
                   device_blocks=True)
            window, on, by_name = _busy_share(
                os.path.join(logdir, "trace.json"), "graph_replay.blocks")
        busy[label] = {"window_ms": window / 1e3, "busy_ms": on / 1e3,
                       "busy_share": on / window if by_name and window > 0
                       else None}
    print(f"[graphs] K1's program at 32 ch, two warm blocks on the card "
          "traced: "
          + "; ".join(f"{k} window {v['window_ms']:.3f} ms, the card busy "
                      f"{v['busy_ms']:.3f} ms ("
                      + (f"{100 * v['busy_share']:.1f} %" if v['busy_share']
                         is not None else "no device event: not measured")
                      + ")" for k, v in busy.items()))
    rec["k1_carried_32ch"]["busy"] = busy
    return rec


# ---------------------------------------------------------------- phase 27

def pretrack_phase():
    """Phase 27: the handoff search's kernels against the plain loops
    (probes/pretrack_kernels.py), with their times; and the handoff
    launches of the phases before.  Returns its record."""
    from stm32f4_sdr_gps_torch.probes import pretrack_kernels as pk

    try:
        cases = pk.run()
    except pk.PretrackCheckError as e:
        fail(f"[pretrack] {e}")
    print(f"[pretrack] handoff kernel launches of the Receiver runs and "
          f"re-acquisitions before, each with no plain-loop call: "
          f"{HANDOFF_LAUNCHES}")
    return {"cases": cases, "receiver_runs": dict(HANDOFF_LAUNCHES),
            "launches": (sum(c["launches"] for c in cases.values())
                         + sum(HANDOFF_LAUNCHES.values()))}


# ---------------------------------------------------------------- phase 28

def if_resample_phase():
    """Phase 28: the real-IF ingest kernel against its plain version, its
    host build and the float64 reference (probes/if_resample.py), with
    its times.  Returns its record."""
    from stm32f4_sdr_gps_torch.probes import if_resample as ir

    try:
        return ir.run()
    except ir.IfResampleCheckError as e:
        fail(f"[if_resample] {e}")


# ---------------------------------------------------------------- phase 29

#: the SoftGNSS front end (benchmark/configs/softgnss_fs38_int8.json)
INT8_FS, INT8_IF = 38192000.0, 9548000.0
#: its quantiser (benchmark/frontends/real_int8.py): unit noise at 8 LSB
INT8_SIGMA_LSB = 8.0
#: 8 satellites in view (the source's channel count), 32 PRNs searched
INT8_SATS = ((3, -3210.0, 101.3), (7, 1240.0, 877.9), (11, 4480.0, 12.6),
             (14, -520.0, 640.2), (19, 2290.0, 333.3), (23, -4870.0, 1010.4),
             (28, 150.0, 512.0), (31, -1760.0, 250.7))
#: each window's first epoch in the capture: three cold starts
INT8_OFFSETS = (0, 7, 20)
INT8_WINDOW = 266
#: planted acquired phases this far off the truth (chips): the second
#: Doppler search's case
INT8_PLANTED = (0.75, -0.75)


def _int8_capture():
    """The capture, int8 real IF at 38.192 MHz (the port's simulator at
    50 dBHz, quantised as the front end does), and its truth."""
    import numpy as np

    from stm32f4_sdr_gps_torch.config import SignalPlan
    from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture

    plan = SignalPlan(sample_rate_hz=INT8_FS, if_freq_hz=INT8_IF,
                      complex_input=False)
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=c, cn0_dbhz=50.0,
                   carrier_phase_cycles=0.1 * k)
            for k, (p, d, c) in enumerate(INT8_SATS)]
    x, truth = simulate_capture(sats, max(INT8_OFFSETS) + INT8_WINDOW, plan,
                                seed=29, chunk_epochs=50)
    q = np.clip(np.round(x * INT8_SIGMA_LSB), -127, 127).astype(np.int8)
    return q, truth


def _int8_errors(rx, truth, offset, lag_ms):
    """Each live channel's (Doppler error Hz, code error chips) at the
    handoff epoch, against the truth at the centre of the baseband
    sample (``lag_ms`` after the epoch's start: the resampler's delay);
    and the PRNs missed."""
    import numpy as np

    prns = [s.prn for s in truth.sats]
    ts = rx.track_state
    dop = ts.doppler_hz.cpu().double().numpy()
    cp = ts.code_phase_chips.cpu().double().numpy()
    errs = []
    for i, ch in enumerate(rx.channels):
        if ch.prn not in prns:
            continue
        k = prns.index(ch.prn)
        epoch = offset + rx.config.acq.noncoherent_epochs
        d = (cp[i] - truth.code_phase_at_epoch(k, epoch + lag_ms)) % 1023.0
        errs.append((abs(dop[i] - truth.apparent_doppler_hz(k, epoch * 1e-3)),
                     min(d, 1023.0 - d)))
    missed = sorted(set(prns) - {ch.prn for ch in rx.channels})
    return np.asarray(errs), missed


def int8_coldstart_phase(device="cuda"):
    """Phase 29: the SoftGNSS deployment's cold start on the main path,
    as ``benchmark/jobs.ColdStart`` drives it: each window's int8
    samples through ``if_to_baseband_device`` (one upload, one R1
    launch), then ``Receiver.acquire_all`` over the 32 PRNs and
    ``start_tracking``.  Each start must find the 8 satellites and hand
    them over within the benchmark's 32 Hz and 1.0 chip, through the
    handoff kernels alone (``_check_handoff``), with one R1 launch a
    window, counted from zero just before the run.  Then the planted
    starts: the acquired phases moved ``INT8_PLANTED`` chips off the
    truth, where the Doppler search's replica holds too little of the
    signal, must search the Doppler again (``pretrack.doppler_again``,
    one more squared-prompt launch a start) and still hand over within
    the limits.  Returns its record."""
    import numpy as np
    import torch

    from stm32f4_sdr_gps_torch.acquire import engine
    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
    from stm32f4_sdr_gps_torch.signal import capture as cap
    from stm32f4_sdr_gps_torch.utils import profiling

    card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    q, truth = _int8_capture()
    made_s = time.perf_counter() - t0
    spe_in = int(INT8_FS) // 1000
    lag_ms = cap.if_resample_plan(INT8_FS).lag_s * 1e3
    cfg = ReceiverConfig(prns=tuple(range(1, 33)))
    acq = cfg.acq.noncoherent_epochs
    spe = cfg.plan.samples_per_epoch

    def start(offset, planted=None):
        rx = Receiver(cfg, device=device)
        x = cap.if_to_baseband_device(
            q[offset * spe_in: (offset + INT8_WINDOW) * spe_in], INT8_FS,
            INT8_IF, device)
        rx.acquire_all(x)
        if planted is not None:
            prns = [s.prn for s in truth.sats]
            for ch in rx.channels:
                if ch.acq.detected and ch.prn in prns:
                    ch.acq.code_phase_chips = float(
                        (truth.code_phase_at_epoch(prns.index(ch.prn),
                                                   offset + lag_ms)
                         + planted) % 1023.0)
        rx.start_tracking(x[acq * spe:], start_epoch=acq)
        if card:
            torch.cuda.synchronize()
        return _int8_errors(rx, truth, offset, lag_ms)

    start(INT8_OFFSETS[0])                       # warm: builds and caches
    rec = {"capture_s": made_s, "starts": {}, "planted": {}}
    if card:
        _reset_counts()
    again0 = profiling.counters.get("pretrack.doppler_again", 0)
    for off in INT8_OFFSETS:
        errs, missed = start(off)
        rec["starts"][off] = {"missed": missed,
                              "doppler_max_hz": float(errs[:, 0].max()),
                              "code_max_chips": float(errs[:, 1].max())}
        if missed or errs[:, 0].max() > 32.0 or errs[:, 1].max() > 1.0:
            fail(f"[int8_coldstart] window at epoch {off}: missed {missed}, "
                 f"Doppler {errs[:, 0].max():.2f} Hz, code "
                 f"{errs[:, 1].max():.3f} chip (limits 32 Hz, 1.0 chip)")
    rec["doppler_again"] = (profiling.counters.get("pretrack.doppler_again", 0)
                            - again0)
    if card:
        rec["launches"] = cap.if_resample_cuda.launches
        if rec["launches"] != len(INT8_OFFSETS):
            fail(f"[int8_coldstart] {rec['launches']} R1 launches for "
                 f"{len(INT8_OFFSETS)} windows")
        _check_handoff("int8_coldstart", least=3 * len(INT8_OFFSETS))
        rec["handoff_launches"] = HANDOFF_LAUNCHES["int8_coldstart"]
        _reset_counts()
    for off in INT8_PLANTED:
        before = profiling.counters.get("pretrack.doppler_again", 0)
        sq = engine.squared_prompts_cuda.launches
        errs, missed = start(INT8_OFFSETS[0], planted=off)
        again = profiling.counters.get("pretrack.doppler_again", 0) - before
        r = {"doppler_again": again,
             "doppler_max_hz": float(errs[:, 0].max()),
             "code_max_chips": float(errs[:, 1].max())}
        if card:
            r["sq_prompt_launches"] = engine.squared_prompts_cuda.launches - sq
        rec["planted"][off] = r
        if (missed or not again or errs[:, 0].max() > 32.0
                or errs[:, 1].max() > 1.0
                or (card and r["sq_prompt_launches"] != 2)):
            fail(f"[int8_coldstart] acquired phases {off:+.2f} chip off: "
                 f"missed {missed}, {r}: want a second Doppler search (two "
                 "squared-prompt launches) and 32 Hz, 1.0 chip")
    if card:
        # each planted start: two squared-prompt and two power launches
        _check_handoff("int8_planted", least=4 * len(INT8_PLANTED))
        if cap.if_resample_cuda.launches != len(INT8_PLANTED):
            fail(f"[int8_coldstart] {cap.if_resample_cuda.launches} R1 "
                 f"launches for {len(INT8_PLANTED)} planted windows")
        rec["launches"] += cap.if_resample_cuda.launches
        rec["planted_handoff_launches"] = HANDOFF_LAUNCHES["int8_planted"]
    print(f"[int8_coldstart] {len(INT8_OFFSETS)} cold starts of 32 PRNs on "
          f"int8 real IF at 38.192 MHz ({made_s:.1f} s to make the "
          f"capture): {rec['starts']}; R1 launches "
          f"{rec.get('launches')}, handoff launches "
          f"{rec.get('handoff_launches')}, second searches "
          f"{rec['doppler_again']}; planted {rec['planted']}")
    return rec


# ---------------------------------------------------------------- phase 30

def acquire_replay_phase():
    """Phase 30: the captured acquisition against its eager run
    (probes/acquire_replay.py), with its times.  Returns its record."""
    from stm32f4_sdr_gps_torch.probes import acquire_replay as ar

    try:
        return ar.run()
    except ar.AcquireReplayCheckError as e:
        fail(f"[acq_replay] {e}")


def main():
    sys.path.insert(0, HERE)
    import stm32f4_sdr_gps_torch

    pkg_dir = os.path.dirname(os.path.abspath(stm32f4_sdr_gps_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"stm32f4_sdr_gps_torch imported from {pkg_dir}, not from this "
             "checkout")
    from stm32f4_sdr_gps_torch.config import (COHERENT_TRACK, DEEP_ACQ,
                                              DEEP_COHERENT_TRACK, ULTRA_ACQ)

    name, smi = card()
    ptxas = build()
    k1_err, k1_times, scenario, k1_modes = kernel_vs_plain()
    sc = _capture("main")
    k1_launches, fix_err, wall, track_ms, fix_rr = main_path(sc)
    cbv_launches, cbv_err, cbv_wall, cbv_track_ms, _ = main_path(
        sc, "main-cbv", coherent_bit_vote=True)
    k2_err, k2_times = epl_vs_plain()
    loop_err = closed_loop(scenario)
    k2_launches = half_chip_path(sc)
    p5 = corr_bank()
    forest_res = forest()
    roll_res, roll_errs, roll_launches, roll_sass_rec = roll_probes()
    phase_s = {}
    sc_weak = _capture("weak32")
    t0 = time.perf_counter()
    weak32 = weak_chain(sc_weak, DEEP_ACQ, COHERENT_TRACK, "weak32",
                        "coherent_pll")
    phase_s[11] = time.perf_counter() - t0
    sc_weak = _capture("weak29")
    t0 = time.perf_counter()
    weak29 = weak_chain(sc_weak, ULTRA_ACQ, DEEP_COHERENT_TRACK, "weak29",
                        "coherent_pll_ext5")
    del sc_weak
    phase_s[12] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reacq = reacquire()
    phase_s[13] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rtcm = rtcm_checkpoint(sc)
    phase_s[14] = time.perf_counter() - t0
    t0 = time.perf_counter()
    acq_ms = acquisition_32(sc)
    phase_s[15] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire = wire_format()
    phase_s[16] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = mesh_phase(sc, scenario, fix_rr)
    phase_s[17] = time.perf_counter() - t0
    # phases 19-20's and 22-23's native build and captures run meanwhile
    from stm32f4_sdr_gps_torch.probes import firmware_parity as fp

    prep_pool = ThreadPoolExecutor(len(fp.SUITES) + 4
                                   + len(DEEP_COLD_SEEDS))
    sim_procs = ProcessPoolExecutor(
        1 + len(DEEP_COLD_SEEDS), mp_context=multiprocessing.get_context(
            "spawn"))
    prep = prep_pool.submit(_prepare_native, prep_pool, sim_procs)
    t0 = time.perf_counter()
    refscan = reference_scan_phase(sc, fix_err)
    phase_s[18] = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_caps = prep.result()
    print(f"[oracle] native/ rebuilt in {native_caps['build_s']:.1f} s, the "
          f"captures ready {native_caps['seconds']:.1f} s after phase 18 "
          f"began ({time.perf_counter() - t0:.1f} s waited)")
    oracle = firmware_oracle_phase(native_caps)
    phase_s[19] = time.perf_counter() - t0
    t0 = time.perf_counter()
    soak_rec = soak_phase(native_caps)
    phase_s[20] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace = trace_phase(sc)
    phase_s[21] = time.perf_counter() - t0
    t0 = time.perf_counter()
    later = native_caps["later"]
    impaired, wire_cap = (later.pop(k).result()
                          for k in ("impaired_fix", "wire"))
    print(f"[stress] the wire capture and the impaired fix_scenario ready "
          f"({time.perf_counter() - t0:.1f} s waited; the fix_scenario "
          f"simulated in {impaired['seconds']:.1f} s)")
    stress_rec = stress_phase(impaired)
    del impaired
    phase_s[22] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire_rec = wire_phase(*wire_cap)
    del wire_cap
    phase_s[23] = time.perf_counter() - t0
    t0 = time.perf_counter()
    capacity_rec = capacity_phase()
    phase_s[24] = time.perf_counter() - t0
    t0 = time.perf_counter()
    deep = {seed: later.pop(f"deep_cold_{seed}").result()
            for seed in DEEP_COLD_SEEDS}
    prep_pool.shutdown()
    sim_procs.shutdown()
    shutil.rmtree(native_caps["dir"])
    print(f"[sens] the deep chain's captures ready "
          f"({time.perf_counter() - t0:.1f} s waited; simulated in "
          f"{ {s: round(c['seconds'], 1) for s, c in deep.items()} } s)")
    sens_rec = sensitivity_phase(deep)
    del deep
    phase_s[25] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs_rec = graphs_phase()
    phase_s[26] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pretrack_rec = pretrack_phase()
    phase_s[27] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ingest_rec = if_resample_phase()
    phase_s[28] = time.perf_counter() - t0
    t0 = time.perf_counter()
    int8_rec = int8_coldstart_phase()
    phase_s[29] = time.perf_counter() - t0
    t0 = time.perf_counter()
    acq_replay_rec = acquire_replay_phase()
    phase_s[30] = time.perf_counter() - t0
    from stm32f4_sdr_gps_torch.utils import graphs

    print(f"[phases] seconds of phases 11-30: "
          f"{ {k: round(v, 1) for k, v in phase_s.items()} }")
    print(f"[graphs] this run: {graphs.stats['captures']} captures, "
          f"{graphs.stats['replays']} replays, {graphs.stats['evictions']} "
          f"evictions, warm-up launches {graphs.stats['warmup_launches']}")
    src = "stm32f4_sdr_gps_torch/csrc/"
    k2_b4, k2_b32 = k2_bound(4), k2_bound(32)

    def roll_entry(name, wrapper, cases, replaces, kernel):
        """One kernel wrapper's record: its launches in the entry points,
        the max error over its cases, the first case's numbers at 8 rows
        on top and every case's at 8, 32 and 128 rows under ``cases``, its
        kernel's ptxas record and SASS counts."""
        return {
            "name": name, "route": "cuda", "source": src + "roll.cu",
            "replaces": replaces, "launches": roll_launches[wrapper],
            "max_abs_err": max(roll_errs[c] for c in cases),
            **roll_res[cases[0], 8],
            "cases": {f"{c}_{rows}rows": roll_res[c, rows]
                      for c in cases for rows in (8, 32, 128)},
            **ptxas[kernel], "sass": roll_sass_rec[kernel],
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
        "weak_chain_32dbhz": weak32,
        "weak_chain_29dbhz": weak29,
        "reacquire": reacq,
        "rtcm_checkpoint": rtcm,
        "acquisition_32prn_ms": acq_ms,
        "acquire_replay": acq_replay_rec,
        "wire_format": wire,
        "mesh": mesh,
        "reference_scan_path": refscan,
        "firmware_oracle": oracle,
        "soak": soak_rec,
        "trace": trace,
        "stress": stress_rec,
        "wire_e2e": wire_rec,
        "capacity": capacity_rec,
        "sensitivity": sens_rec,
        "graphs": {k: v for k, v in graphs_rec.items()
                   if not k.startswith("k2_")},
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
        "graphs": graphs_rec["k2_per_epoch_32ch"],
    }, {
        "name": "pretrack",
        "route": "cuda",
        "source": src + "pretrack.cu",
        "replaces": "none (the jax.jit lax.scan programs "
                    "stm32f4_sdr_gps_tpu/acquire/engine.py:484 and "
                    "stm32f4_sdr_gps_tpu/track/pretrack.py:25)",
        "launches": (pretrack_rec["launches"]
                     + HANDOFF_LAUNCHES["int8_coldstart"]
                     + HANDOFF_LAUNCHES["int8_planted"]),
        "max_rel_err": max(c["max_rel_err"]
                           for c in pretrack_rec["cases"].values()),
        **{k: pretrack_rec["cases"]["prompts_4x32"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "cases": pretrack_rec["cases"],
        "receiver_runs": dict(HANDOFF_LAUNCHES),
        **{k: ptxas[k] for k in ("sq_prompts", "pretrack_corr",
                                 "pretrack_sum")},
    }, {
        "name": "if_resample",
        "route": "cuda",
        "source": src + "if_resample.cu",
        "replaces": "none (no TPU kernel: the JAX package has no real-IF "
                    "ingest; signal/capture.py:if_to_baseband_device)",
        "launches": int8_rec["launches"],
        "probe_launches": sum(c["launches"] for c in ingest_rec.values()),
        "max_rel_err": max(c["max_rel_err"] for c in ingest_rec.values()),
        **{k: ingest_rec["sigma_8_a"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "roofline_pct", "ingest_ms", "ingest_registered_ms",
                     "ingest_gbps", "ingest_registered_gbps")},
        "library_ms": None,
        "cases": ingest_rec,
        "int8_coldstart": int8_rec,
        **ptxas["if_resample"],
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
        **ptxas[name],
    } for name, r in forest_res.items()] + [
        roll_entry("roll_dyn", "dyn_roll_cuda",
                   ["dynu2_neg", "dynu2_pos", "dynwin_neg", "dynwin_pos"],
                   "tools/tpu_roll_wide_probe.py:78", "roll_rows_kernel"),
        roll_entry("roll_static", "statwin_cuda", ["statwin"],
                   "tools/tpu_roll_wide_probe.py:115", "roll_rows_kernel"),
        roll_entry("barrel", "barrel_cuda", ["barrel"],
                   "tools/tpu_roll_wide_probe.py:157", "barrel_kernel"),
        roll_entry("roll_256", "roll_cuda", ["roll_neg", "roll_pos"],
                   "tools/tpu_mosaic_bisect.py:76", "roll_rows_kernel"),
    ]}
    import torch

    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
