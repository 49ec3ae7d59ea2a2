"""The receiver under stress: six robustness suites of the JAX package,
their scenarios and bars copied here (so the port needs nothing of it).

* ``impairments`` (tests/test_impairments.py): PRNs 2, 7, 15, 24 at
  49 dBHz, 3 codes a bit, seed 11, through a +2 ppm TCXO drifting at
  0.003 ppm/s, 0.5 rad^2/s phase noise, 1.8 MHz two-sided band-limiting
  and two-ray multipath on PRNs 2 and 7; 250-epoch blocks.  Every channel
  TRACKING within 10 Hz of the apparent Doppler, > 500 bits, subframes
  1-3 decoded, code within 0.25 chip (multipath) or 0.1 chip (clean) of
  the TCXO-scaled truth.
* ``impaired_fix`` (tests/test_e2e_slow.py::
  test_cold_start_fix_under_rf_impairments): the 29 s ``fix_scenario``
  at -2 ppm, 0.003 ppm/s, 0.5 rad^2/s, 1.8 MHz, multipath on PRNs 2 and
  15, 1000-epoch blocks.  Full ephemeris set on every channel, a fix,
  the last within 700 m.
* ``dynamics`` (tests/test_dynamics.py): one channel through
  ``track_block``: a 0.9 Hz/s Doppler ramp over 4000 epochs (Doppler
  within 5 Hz at epochs 1000, 2000 and 3900, code within 0.3 chip over
  the last 200); a 40 ms dropout and a 60 ms noise burst over 2000
  epochs (the last 200 epochs' mean Doppler within 10 Hz, the last code
  phase within 0.3 chip); the simulator's chirp bookkeeping.
* ``boundary`` (tests/test_boundary_timing.py): 7 PRNs whose bit edges
  sit 2 %, 25 %, 46 %, 54 %, 75 %, 98 % and 49.95 % (the razor) into an
  epoch, seed 13.  Each reconstructed subframe-boundary arrival at
  offset 0 and within 5 us of the planted one; the razor channel may sit
  at +/-1 ms, but only as a clean integer offset.
* ``eight`` (tests/test_8ch_receiver.py): 8 PRNs at 46 dBHz, seed 5,
  500-epoch blocks.  At least 7 full sets, A within 1 m, ``EPH UTC`` in
  the dashboard.
* ``coherent`` (tests/test_coherent_bits.py, test_coherent_pll.py): a
  mixed-sign bit fragmented in firmware mode and integrated in coherent
  mode; identical clean bit streams in both modes; coherent mode
  recovering the planted bits at 28 dBHz where firmware mode fragments;
  the 20 ms coherent PLL holding at 29 dBHz where the per-epoch loop
  slips, the 100 ms loop at 24 dBHz where the per-bit loop slips, both
  clean at 45 dBHz.

Every scenario comes from the port's simulator (the same samples as the
JAX package's, bit for bit).  The runners take a ``device`` and
TrackConfig overrides: chip_smoke.py runs them on the card through the
default path (the tracking-scan kernel), the CPU tests on the reference
scan and on the kernel's plain version.  The bars take a Receiver report
or ``track_block`` outputs as numpy arrays, of either package.  A failed
bar raises StressError.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .firmware_parity import TEST_EPH

CIB = 3                      # the compressed-time suites' codes a bit
FL1 = 1.57542e9


class StressError(AssertionError):
    """A bar of the robustness suites failed."""


def _require(ok, *msg) -> None:
    if not ok:
        raise StressError(msg)


def phase_err(a, b):
    """Code-phase difference wrapped to (-511.5, 511.5] chips."""
    return (a - b + 511.5) % 1023.0 - 511.5


def _compressed_bits(num_subframes, subframe_ids, prefix_bits=120):
    """The compressed-time suites' nav stream: an alternating run-in and
    subframes of TEST_EPH from TOW 58800 * 6 s."""
    from ..signal.nav_message import build_bitstream

    prefix = np.tile([0, 1], prefix_bits // 2).astype(np.int8)
    body = build_bitstream(dict(TEST_EPH), start_tow_6s=58800,
                           num_subframes=num_subframes,
                           subframe_ids=subframe_ids)
    return np.concatenate([prefix, body])


def compressed_config(prns, block, **track):
    """The ReceiverConfig the compressed-time suites give their Receiver
    (``track`` overrides the TrackConfig, e.g. ``in_kernel_scan``)."""
    from ..config import AcqConfig, ReceiverConfig, TrackConfig

    return ReceiverConfig(
        prns=tuple(prns), acq=AcqConfig(),
        track=TrackConfig(codes_in_bit=CIB, pll_bad_state_threshold=10**9,
                          **track),
        enable_position=False, track_block_epochs=block)


def run_receiver(samples, cfg, device="cuda", bit_epochs=None):
    """``Receiver(cfg, device).run(samples)``: (report, receiver).  With a
    dict ``bit_epochs``, the epoch of every nav bit pushed to a channel is
    recorded there ({prn: [epoch, ...]})."""
    from ..runtime.receiver import Receiver

    rx = Receiver(cfg, device=device)
    if bit_epochs is not None:
        push = rx._push_channel_bit

        def hook(ch, value, epoch):
            bit_epochs.setdefault(ch.prn, []).append(int(epoch))
            return push(ch, value, epoch)

        rx._push_channel_bit = hook
    return rx.run(samples), rx


# ------------------------------------------------------------ impairments

IMP_PRNS = (2, 7, 15, 24)
IMP_DELAYS_MS = (1.773, 6.402, 3.255, 9.911)
IMP_DOPPLERS = (-2500.0, 800.0, 3100.0, -400.0)
IMP_EPOCHS = 120 * CIB + 4 * 300 * CIB + 400
IMP_BLOCK = 250


def impairments():
    """test_impairments.IMP."""
    from ..signal.simulator import Impairments

    return Impairments(tcxo_offset_ppm=2.0, tcxo_drift_ppm_s=0.003,
                       phase_noise_rad2_s=0.5, frontend_bw_hz=1.8e6)


def impaired_capture(num_epochs=IMP_EPOCHS, seed=11):
    """test_impairments._impaired_capture: (samples, truth)."""
    from ..signal.simulator import SimSat, simulate_capture

    sats = []
    for i, (prn, delay, dop) in enumerate(zip(IMP_PRNS, IMP_DELAYS_MS,
                                              IMP_DOPPLERS)):
        mp = i < 2          # multipath on two of the four satellites
        sats.append(SimSat(
            prn=prn, doppler_hz=dop, cn0_dbhz=49.0,
            nav_bits=_compressed_bits(4, (5, 1, 2, 3)),
            codes_in_bit=CIB, delay_ms=delay,
            multipath_delay_chips=0.8 if mp else 0.0,
            multipath_amp=0.3 if mp else 0.0,
            multipath_phase_cycles=0.13 if mp else 0.0,
        ))
    return simulate_capture(sats, num_epochs=num_epochs, seed=seed,
                            impairments=impairments())


def check_impairments(report, truth) -> dict:
    """test_cold_acquisition_under_tcxo_offset and
    test_tracking_and_decode_under_impairments.  Returns {prn: (Doppler
    error Hz, code error chips)}."""
    rec = {}
    t = report.epochs_processed * 1e-3
    _require(len(report.channels) == len(IMP_PRNS),
             [ch.prn for ch in report.channels])
    for i, ch in enumerate(report.channels):
        _require(ch.state_name == "TRACKING", ch.prn, ch.state_name)
        dop_err = ch.doppler_hz - truth.apparent_doppler_hz(i, t)
        _require(abs(dop_err) < 10.0, ch.prn, "Doppler", dop_err)
        _require(ch.bit_count > 500, ch.prn, "bits", ch.bit_count)
        _require((ch.eph.received_mask_proc & 0x7) == 0x7, ch.prn,
                 "mask", ch.eph.received_mask_proc)
        cp_true = truth.code_phase_at_epoch(i, report.epochs_processed - 1)
        err = phase_err(ch.code_phase_chips, cp_true)
        bound = 0.25 if truth.sats[i].multipath_amp else 0.1
        _require(abs(err) < bound, ch.prn, "code", err, bound)
        rec[ch.prn] = (float(dop_err), float(err))
    return rec


def run_impairments(device="cuda", **track):
    """The impaired compressed-time Receiver under its bars: (report,
    receiver, {prn: (Doppler error, code error)})."""
    x, truth = impaired_capture()
    report, rx = run_receiver(
        x, compressed_config(IMP_PRNS, IMP_BLOCK, **track), device)
    return report, rx, check_impairments(report, truth)


# ------------------------------------------------- the impaired cold start

FIX_EPOCHS = 29_000
FIX_MULTIPATH = {2: (0.8, 0.3, 0.13), 15: (0.9, 0.3, 0.77)}
FIX_BAR_M = 700.0


def impaired_fix_scenario(num_epochs=FIX_EPOCHS):
    """The slow suite's impaired ``fix_scenario``."""
    from ..signal.scenarios import fix_scenario
    from ..signal.simulator import Impairments

    imp = Impairments(tcxo_offset_ppm=-2.0, tcxo_drift_ppm_s=0.003,
                      phase_noise_rad2_s=0.5, frontend_bw_hz=1.8e6)
    return fix_scenario(num_epochs=num_epochs, impairments=imp,
                        multipath=FIX_MULTIPATH)


def save_impaired_fix(path, num_epochs=FIX_EPOCHS) -> None:
    """The impaired ``fix_scenario``'s samples, planted position and PRNs
    to ``path`` (``.npz``), for a process that simulates it beside
    another's work."""
    sc = impaired_fix_scenario(num_epochs)
    np.savez(path, samples=sc.samples, rr_true=sc.rr_true,
             prns=np.asarray(sc.prns))


# The impaired fix turns on one fade of PRN 15 (ROADMAP Queue 3): its
# prompt at epoch 24267 lies within ~10 units of zero (against ~200), on
# every trajectory.  Where it comes out negative the firmware-mode bit sync
# ends a bit there, 15 epochs after the last (FADE_SPLIT), subframe 3
# fails parity and no fix is made; the JAX Pallas kernel lands there on
# its full-readback path, its reference scan on the other side.
FADE_PRN = 15
FADE_SPLIT = (24252, 24267)


def check_fade_outcome(report, bit_epochs) -> None:
    """The run ended in the fade's known outcome: PRN 15's bit split at
    FADE_SPLIT, every other channel's ephemeris set full, PRN 15's not,
    no fix.  ``bit_epochs`` as ``run_receiver`` records them."""
    full = sorted(ch.prn for ch in report.channels if ch.eph.has_full_set)
    want = sorted(ch.prn for ch in report.channels if ch.prn != FADE_PRN)
    _require(full == want, "full sets", full)
    eps = bit_epochs.get(FADE_PRN, [])
    i = eps.index(FADE_SPLIT[0]) if FADE_SPLIT[0] in eps else -1
    _require(i >= 0 and i + 1 < len(eps) and eps[i + 1] == FADE_SPLIT[1],
             "no bit split at", FADE_SPLIT)
    _require(not report.solutions, "a fix without PRN 15's set")


def impaired_fix_config(prns, **track):
    from ..config import ReceiverConfig, TrackConfig

    return ReceiverConfig(prns=tuple(prns), track=TrackConfig(**track),
                          track_block_epochs=1000)


def check_impaired_fix(report, rr_true) -> tuple:
    """Full ephemeris set on every channel, a fix, the last within
    700 m.  Returns (error m, |vel| m/s)."""
    for ch in report.channels:
        _require(ch.eph.has_full_set, ch.prn, "no full ephemeris set")
    _require(report.solutions, "no position fix under impairments")
    sol = report.solutions[-1]
    err = float(np.linalg.norm(sol.rr - rr_true))
    _require(np.all(np.isfinite(sol.rr)) and err < FIX_BAR_M,
             f"position error {err:.1f} m")
    return err, float(np.linalg.norm(sol.vel))


# --------------------------------------------------------------- dynamics

DYNAMICS = {
    # name: (SimSat keywords, epochs, capture seed, handoff code phase,
    #        handoff Doppler, fault or None)
    "ramp": (dict(prn=14, doppler_hz=-1000.0, code_phase_chips=200.0,
                  cn0_dbhz=46.0, doppler_rate_hz_s=0.9),
             4000, 12, 200.2, -980.0, None),
    "dropout": (dict(prn=6, doppler_hz=1500.0, code_phase_chips=100.0,
                     cn0_dbhz=46.0),
                2000, 7, 100.1, 1510.0,
                dict(start_ms=800.0, duration_ms=40.0, mode="dropout")),
    "burst": (dict(prn=6, doppler_hz=-700.0, code_phase_chips=512.0,
                   cn0_dbhz=46.0),
              2000, 8, 512.1, -690.0,
              dict(start_ms=900.0, duration_ms=60.0, mode="noise", seed=1)),
}


def dynamics_capture(name):
    """(samples, truth, sat) of one dynamics scenario."""
    from ..signal.simulator import SimSat, inject_fault, simulate_capture

    kw, e, seed, _, _, fault = DYNAMICS[name]
    sat = SimSat(**kw)
    x, truth = simulate_capture([sat], num_epochs=e, seed=seed)
    if fault is not None:
        x = inject_fault(x, **fault)
    return x, truth, sat


def check_dynamics(name, dop, cp, truth) -> dict:
    """The suite's bar on one channel's (T,) Doppler and code-phase
    outputs.  Returns the measured errors."""
    kw, e, _, _, _, _ = DYNAMICS[name]
    dop, cp = np.asarray(dop, np.float64), np.asarray(cp, np.float64)
    if name == "ramp":
        rate = kw["doppler_rate_hz_s"]
        rec = {}
        for t in (1000, 2000, 3900):
            want = kw["doppler_hz"] + rate * (t / 1000.0)
            got = float(np.mean(dop[t - 50: t + 50]) - want)
            _require(abs(got) < 5.0, name, t, got)
            rec[f"doppler_err_hz_{t}"] = got
        errs = [phase_err(cp[t], truth.code_phase_at_epoch(0, t))
                for t in range(e - 200, e)]
        rec["code_err_max"] = float(np.max(np.abs(errs)))
        _require(rec["code_err_max"] < 0.3, name, rec["code_err_max"])
        return rec
    dop_err = float(np.mean(dop[-200:]) - kw["doppler_hz"])
    code_err = float(phase_err(cp[-1], truth.code_phase_at_epoch(0, e - 1)))
    _require(abs(dop_err) < 10.0, name, "Doppler", dop_err)
    _require(abs(code_err) < 0.3, name, "code", code_err)
    return {"doppler_err_hz": dop_err, "code_err": code_err}


def check_chirp_truth() -> float:
    """test_simulator_chirp_truth_consistency: the code phase after one
    epoch equals the chirp's Doppler integral scaled by the code/carrier
    ratio.  Returns the difference."""
    from ..signal.simulator import SimSat, simulate_capture

    sat = SimSat(prn=4, doppler_hz=2000.0, code_phase_chips=0.0,
                 cn0_dbhz=60.0, doppler_rate_hz_s=0.5)
    _, truth = simulate_capture([sat], num_epochs=2, seed=0)
    t = 1e-3
    dop_int = 2000.0 * t + 0.25 * t * t
    want = (1.023e6 * (t + dop_int / FL1)) % 1023
    diff = truth.code_phase_at_epoch(0, 1) - want
    _require(abs(diff) < 1e-9, "chirp bookkeeping", diff)
    return float(diff)


def track_inputs(samples, prns, cp0, dop0, cfg, device, synced=False):
    """(TrackState, (T, S) epochs, code table) on ``device`` for
    ``track_block`` under ``cfg``: the doubled upsampled table where the
    tracking-scan kernel (or its plain version) runs, the raw bipolar
    table for the reference scan; with ``synced`` the bit grid already
    synced (the coherent suites' post-handoff state)."""
    import torch

    from ..config import BASEBAND_PLAN, resolve_in_kernel_scan
    from ..ops.epl import code_rows
    from ..track.state import init_state

    s = BASEBAND_PLAN.samples_per_epoch
    st = init_state(len(prns), np.asarray(cp0, np.float64),
                    np.asarray(dop0, np.float64), device=device,
                    window=cfg.pll_check_window)
    if synced:
        st = st._replace(
            period_sync_ok=torch.ones(len(prns), dtype=torch.bool,
                                      device=st.period_sync_ok.device),
            right_period_cnt=torch.full((len(prns),), 10,
                                        dtype=torch.int32,
                                        device=st.period_sync_ok.device))
    doubled = bool(cfg.use_pallas or resolve_in_kernel_scan(cfg, device))
    epochs = torch.as_tensor(
        np.ascontiguousarray(np.asarray(samples, np.complex64)
                             .reshape(-1, s)), device=device)
    return st, epochs, code_rows(tuple(prns), doubled, str(device))


def run_track(samples, prns, cp0, dop0, cfg, device="cuda", synced=False):
    """``track_block`` on ``device``: (final TrackState, TrackOutputs)."""
    from ..config import BASEBAND_PLAN
    from ..track.scan import track_block

    st, epochs, table = track_inputs(samples, prns, cp0, dop0, cfg, device,
                                     synced)
    return track_block(st, epochs, table, BASEBAND_PLAN, cfg)


def run_dynamics(name, device="cuda", **track):
    """One dynamics scenario through ``track_block`` with
    ``TrackConfig(**track)`` under its bar: (state, outputs, errors)."""
    from ..config import TrackConfig

    kw, _, _, cp0, dop0, _ = DYNAMICS[name]
    x, truth, _ = dynamics_capture(name)
    st, outs = run_track(x, [kw["prn"]], [cp0], [dop0], TrackConfig(**track),
                         device)
    rec = check_dynamics(name, outs.doppler_hz[:, 0].cpu().numpy(),
                         outs.code_phase_chips[:, 0].cpu().numpy(), truth)
    return st, outs, rec


# -------------------------------------------------------- boundary timing

BND_PRNS = (2, 5, 7, 13, 15, 20, 24)
#              2%     25%    46%    54%    75%    98%    razor 49.95%
BND_DELAYS = (1.020, 3.250, 5.460, 7.540, 9.750, 11.980, 13.4995)
BND_DOPPLERS = (-2200.0, 650.0, 2900.0, -350.0, 1500.0, -1800.0, 900.0)
BND_PREFIX = 120
BND_START_TOW6 = 58800
BND_EPOCHS = (BND_PREFIX + 2 * 300) * CIB + 300
BND_BLOCK = 250


def boundary_capture():
    """test_boundary_arrival_matches_planted_edges' capture."""
    from ..signal.simulator import SimSat, simulate_capture

    sats = [SimSat(prn=prn, doppler_hz=dop, cn0_dbhz=49.0,
                   nav_bits=_compressed_bits(2, (5, 1), BND_PREFIX),
                   codes_in_bit=CIB, delay_ms=delay)
            for prn, delay, dop in zip(BND_PRNS, BND_DELAYS, BND_DOPPLERS)]
    x, _ = simulate_capture(sats, num_epochs=BND_EPOCHS, seed=13)
    return x


def check_boundary(report) -> dict:
    """Each channel's reconstructed subframe-boundary arrival against the
    planted edge: offset 0 and < 5 us, or for the razor edge a clean
    +/-1 ms.  Returns {prn: (integer ms offset, sub-ms residual us)}."""
    from ..pvt.observables import boundary_arrival_ms

    _require(len(report.channels) == len(BND_PRNS),
             [ch.prn for ch in report.channels])
    rec = {}
    for ch, delay, dop in zip(report.channels, BND_DELAYS, BND_DOPPLERS):
        _require(ch.subframe_count >= 1, ch.prn, "no subframe")
        # the ledger boundary is the start of the subframe after the one
        # whose HOW labels it
        tow6 = int(round(ch.subframe_tow_s / 6.0))
        bit_index = BND_PREFIX + 300 * (tow6 - BND_START_TOW6)
        truth_ms = (delay + bit_index * CIB) / (1.0 + dop / FL1)
        err_ms = boundary_arrival_ms(ch.subframe_time_ms,
                                     ch.code_phase_chips) - truth_ms
        off = int(np.round(err_ms))
        sub_us = abs(err_ms - off) * 1e3
        if abs(delay % 1.0 - 0.5) < 0.01:
            # razor edge: either epoch, but a clean integer-ms offset
            _require(off in (-1, 0, 1), ch.prn, err_ms)
        else:
            _require(off == 0, ch.prn, err_ms, delay)
        _require(sub_us < 5.0, ch.prn, err_ms, delay)
        rec[ch.prn] = (off, float(sub_us))
    return rec


def run_boundary(device="cuda", **track):
    report, rx = run_receiver(
        boundary_capture(), compressed_config(BND_PRNS, BND_BLOCK, **track),
        device)
    return report, rx, check_boundary(report)


# ----------------------------------------------------------- eight channels

EIGHT_PRNS = (1, 4, 8, 11, 16, 21, 27, 31)
EIGHT_EPOCHS = 120 * CIB + 4 * 300 * CIB + 400
EIGHT_BLOCK = 500


def eight_capture(seed=5):
    """test_eight_channels_decode's capture (seeded Dopplers and
    delays)."""
    from ..signal.simulator import SimSat, simulate_capture

    rng = np.random.default_rng(seed)
    sats = []
    for prn in EIGHT_PRNS:
        sats.append(SimSat(
            prn=prn, doppler_hz=float(rng.uniform(-6000, 6000)),
            cn0_dbhz=46.0, nav_bits=_compressed_bits(4, (5, 1, 2, 3)),
            codes_in_bit=CIB, delay_ms=float(rng.uniform(1.0, 20.0))))
    x, _ = simulate_capture(sats, num_epochs=EIGHT_EPOCHS, seed=seed)
    return x


def check_eight(report, rx) -> list:
    """8 channels, at least 7 with subframes 1-3, their A within 1 m,
    ``EPH UTC`` on the dashboard.  Returns the full PRNs."""
    from ..io.status import render_status

    _require(len(report.channels) == 8, [ch.prn for ch in report.channels])
    full = [ch.prn for ch in report.channels
            if (ch.eph.received_mask_proc & 0x7) == 0x7]
    _require(len(full) >= 7, full)
    for ch in report.channels:
        _require(abs(ch.eph.A - TEST_EPH["A"]) < 1.0 or ch.prn not in full,
                 ch.prn, ch.eph.A)
    _require("EPH UTC" in render_status(rx), "no EPH UTC on the dashboard")
    return full


def run_eight(device="cuda", **track):
    report, rx = run_receiver(
        eight_capture(), compressed_config(EIGHT_PRNS, EIGHT_BLOCK, **track),
        device)
    return report, rx, check_eight(report, rx)


# ------------------------------------------------------ the coherent claims

COH_CIB = 20


def frozen_config(**kw):
    """test_coherent_bits._frozen_cfg: the loops frozen, only the bit
    extraction acts."""
    from ..config import TrackConfig

    return TrackConfig(codes_in_bit=COH_CIB, dll_c1=0.0, dll_c2=0.0,
                       pll_wide_c1=0.0, pll_wide_c2=0.0,
                       pll_narrow_c1=0.0, pll_narrow_c2=0.0,
                       fll_c1=0.0, fll_c2=0.0,
                       pll_bad_state_threshold=10**9, **kw)


def decided_bits(outs) -> tuple:
    """Channel 0's decided bits and their epochs from (T, C) outputs (of
    either package)."""
    ready = np.asarray(outs.bit_ready)[:, 0].astype(bool)
    return (np.asarray(outs.bit_value)[:, 0][ready].astype(int),
            np.asarray(outs.bit_epoch)[:, 0][ready].astype(int))


def mixed_sign_capture():
    """Bit 0 carries 11 weak wrong-sign epochs and 9 strong right-sign
    ones (coherent sum +7), then a +1 and a -1 bit: epoch e is PRN 9's
    code times amps[e], zero Doppler."""
    from ..signal.ca_code import ca_table_bipolar

    amps = [-1.0] * 11 + [2.0] * 9 + [1.0] * COH_CIB + [-1.0] * COH_CIB
    up = np.repeat(ca_table_bipolar([9])[0], 2).astype(np.float32)
    return np.concatenate([a * up for a in amps]).astype(np.complex64)


def check_mixed_sign(fw, co) -> None:
    """Firmware mode reports the 11-epoch fragment's majority (0);
    coherent mode the full bit's sum (1) on a held grid.  ``fw`` and
    ``co`` are decided_bits of the two modes."""
    _require(fw[0][0] == 0, "firmware mode", list(fw[0]))
    _require(co[0][0] == 1, "coherent mode", list(co[0]))
    _require(co[1][0] == 0 and co[1][1] == COH_CIB, "grid", list(co[1]))


def clean_stream_capture():
    """PRN 17 at 45 dBHz, 800 Hz, 40 random bits at 3 codes a bit: (samples,
    bits)."""
    from ..signal.simulator import SimSat, simulate_capture

    bits = list(np.random.default_rng(7).integers(0, 2, 40))
    sat = SimSat(prn=17, doppler_hz=800.0, code_phase_chips=0.0,
                 cn0_dbhz=45.0, codes_in_bit=3, nav_bits=bits)
    x, _ = simulate_capture([sat], num_epochs=3 * len(bits), seed=7)
    return x, bits


def check_clean_streams(streams) -> None:
    """{coherent: bit list}: at least 15 bits, equal in both modes."""
    _require(len(streams[False]) >= 15, len(streams[False]))
    _require(list(streams[False]) == list(streams[True]),
             list(streams[False]), list(streams[True]))


def low_cn0_capture():
    """PRN 23 at 28 dBHz, 60 random bits at 20 codes a bit: (samples,
    bits)."""
    from ..signal.simulator import SimSat, simulate_capture

    bits = list(np.random.default_rng(21).integers(0, 2, 60))
    sat = SimSat(prn=23, doppler_hz=0.0, code_phase_chips=0.0,
                 cn0_dbhz=28.0, codes_in_bit=COH_CIB, nav_bits=bits)
    x, _ = simulate_capture([sat], num_epochs=COH_CIB * len(bits), seed=21)
    return x, bits


def check_low_cn0(fw, co, bits) -> int:
    """Coherent mode one bit every 20 epochs and at most one error
    against the planted bits (up to polarity); firmware mode fragmented.
    Returns coherent mode's errors."""
    co_bits, co_epochs = co
    _require(np.all(np.diff(co_epochs) == COH_CIB), "coherent grid broke")
    planted = [bits[int(e) // COH_CIB] for e in co_epochs]
    if planted[0] != co_bits[0]:
        planted = [1 - b for b in planted]
    errs = int(sum(a != b for a, b in zip(co_bits, planted)))
    _require(errs <= 1, f"coherent BER too high: {errs}/{len(co_bits)}")
    _require(np.any(np.diff(fw[1]) != COH_CIB),
             "expected firmware-mode fragmentation at 28 dBHz")
    return errs


# test_coherent_pll's captures: (C/N0, bits, seed)
PLL_CAPTURES = {"29dbhz": (29.0, 37, 42), "24dbhz": (24.0, 37, 42),
                "45dbhz": (45.0, 25, 3)}


def pll_capture(name):
    """PRN 12 at 250 Hz, subframes 1-3 of CANONICAL_EPH at 20 codes a
    bit: (samples, bits)."""
    from ..signal.nav_message import build_bitstream
    from ..signal.scenarios import CANONICAL_EPH
    from ..signal.simulator import SimSat, simulate_capture

    cn0, n_bits, seed = PLL_CAPTURES[name]
    stream = build_bitstream(CANONICAL_EPH, start_tow_6s=40,
                             num_subframes=3, subframe_ids=(1, 2, 3))
    bits = list(stream[:n_bits])
    sat = SimSat(prn=12, doppler_hz=250.0, code_phase_chips=0.0,
                 cn0_dbhz=cn0, codes_in_bit=COH_CIB, nav_bits=bits)
    x, _ = simulate_capture([sat], num_epochs=COH_CIB * len(bits),
                            seed=seed)
    return x, bits


def pll_score(outs, bits) -> tuple:
    """test_coherent_pll._track_bits on (T, C) outputs: (bit errors up to
    polarity, bits, 95th percentile of |Doppler - 250 Hz|)."""
    vals, eps = decided_bits(outs)
    planted = np.array([bits[e // COH_CIB] for e in eps])
    errs = min(int(np.sum(vals != planted)),
               int(np.sum((1 - vals) != planted)))
    dop_err = np.abs(np.asarray(outs.doppler_hz)[:, 0] - 250.0)
    return errs, len(vals), float(np.percentile(dop_err, 95))


def check_pll_holds(loose, tight, ratio, dop_bar) -> None:
    """The better loop ``tight`` (errors, bits, Doppler p95) at most one
    error within ``dop_bar`` Hz; the worse ``loose`` over ``ratio`` times
    as many errors."""
    _require(tight[0] <= 1, "tight loop errors", tight)
    _require(tight[2] < dop_bar, "tight loop Doppler", tight)
    _require(loose[0] > ratio * max(tight[0], 1), "loose loop", loose, tight)


def check_pll_clean(res) -> None:
    """No error, >= 20 bits, Doppler p95 under 1 Hz."""
    _require(res[0] == 0 and res[1] >= 20, "clean", res)
    _require(res[2] < 1.0, "clean Doppler", res)


def coherent_configs():
    """{name: TrackConfig} of the coherent claims' runs."""
    from ..config import COHERENT_TRACK, DEEP_COHERENT_TRACK, TrackConfig

    return {
        "mixed_fw": frozen_config(),
        "mixed_co": frozen_config(coherent_bit_vote=True),
        "clean_fw": TrackConfig(codes_in_bit=3,
                                pll_bad_state_threshold=10**9),
        "clean_co": TrackConfig(codes_in_bit=3, coherent_bit_vote=True,
                                pll_bad_state_threshold=10**9),
        "low_fw": frozen_config(),
        "low_co": frozen_config(coherent_bit_vote=True),
        "per_epoch": TrackConfig(coherent_bit_vote=True),
        "coherent": COHERENT_TRACK,
        "ext5": DEEP_COHERENT_TRACK,
    }


# each coherent run: (config name, capture name, PRN, code phase, Doppler,
# synced at entry)
COHERENT_RUNS = {
    "mixed_fw": ("mixed_fw", "mixed", 9, 0.0, 0.0, True),
    "mixed_co": ("mixed_co", "mixed", 9, 0.0, 0.0, True),
    "clean_fw": ("clean_fw", "clean", 17, 0.0, 800.0, False),
    "clean_co": ("clean_co", "clean", 17, 0.0, 800.0, False),
    "low_fw": ("low_fw", "low", 23, 0.0, 0.0, True),
    "low_co": ("low_co", "low", 23, 0.0, 0.0, True),
    "pll29_per_epoch": ("per_epoch", "29dbhz", 12, 0.0, 250.0, True),
    "pll29_coherent": ("coherent", "29dbhz", 12, 0.0, 250.0, True),
    "pll45_coherent": ("coherent", "45dbhz", 12, 0.0, 250.0, True),
    "pll24_coherent": ("coherent", "24dbhz", 12, 0.0, 250.0, True),
    "pll24_ext5": ("ext5", "24dbhz", 12, 0.0, 250.0, True),
    "pll45_ext5": ("ext5", "45dbhz", 12, 0.0, 250.0, True),
}


def coherent_captures():
    """{capture name: (samples, planted bits or None)}."""
    caps = {"mixed": (mixed_sign_capture(), None),
            "clean": clean_stream_capture(), "low": low_cn0_capture()}
    for name in PLL_CAPTURES:
        caps[name] = pll_capture(name)
    return caps


def check_coherent(outs, caps) -> dict:
    """Every coherent claim on {run name: (T, C) outputs} (of either
    package).  Returns each PLL run's (errors, bits, Doppler p95)."""
    bits = {k: decided_bits(o) for k, o in outs.items()}
    check_mixed_sign(bits["mixed_fw"], bits["mixed_co"])
    check_clean_streams({False: bits["clean_fw"][0],
                         True: bits["clean_co"][0]})
    check_low_cn0(bits["low_fw"], bits["low_co"], caps["low"][1])
    pll = {k: pll_score(outs[k], caps[COHERENT_RUNS[k][1]][1])
           for k in COHERENT_RUNS if k.startswith("pll")}
    check_pll_holds(pll["pll29_per_epoch"], pll["pll29_coherent"], 5, 3.0)
    check_pll_clean(pll["pll45_coherent"])
    check_pll_holds(pll["pll24_coherent"], pll["pll24_ext5"], 3, 1.0)
    check_pll_clean(pll["pll45_ext5"])
    return pll


def run_coherent(device="cuda", **track):
    """Every coherent run through ``track_block`` on ``device`` (each
    config with ``track`` applied) under the claims' bars: ({run name:
    (state, outputs)}, PLL scores)."""
    caps = coherent_captures()
    cfgs = coherent_configs()
    res = {}
    for run, (cfg_name, cap, prn, cp0, dop0, synced) in COHERENT_RUNS.items():
        cfg = dataclasses.replace(cfgs[cfg_name], **track)
        res[run] = run_track(caps[cap][0], [prn], [cp0], [dop0], cfg, device,
                             synced)
    outs = {k: numpy_outputs(o) for k, (_, o) in res.items()}
    return res, check_coherent(outs, caps)


def numpy_outputs(outs):
    """TrackOutputs with numpy leaves."""
    return type(outs)(*(v.cpu().numpy() for v in outs))
