"""The port's Receiver held to the firmware oracle on the wire format.

``native/firmware_rx.cpp`` is a receiver with the reference firmware's
exact numerics (acquisition, pre-track, 4-of-17 TDM tracking, flip
counter bit sync and 20 ms majority vote, the subframe-time ledger and
relative pseudoranges).  Each suite generates an independent wire-format
capture with ``native/capture_gen`` (1-bit signs at 16.368 MHz packed in
SPI words), runs the oracle on the words and the port's Receiver on the
host-conditioned baseband, and applies the bars of the JAX package's
suite of the same name (copied here, so the port needs nothing of it):

* ``firmware_parity`` (tests/test_firmware_parity.py): 12 s at 48 dBHz,
  seed 11, PRNs 24 and 7 with 500 Hz-grid hints.  The oracle tracks and
  syncs; the nav bits are equal on the shared 20 ms grid up to one
  global polarity; Doppler within 5 Hz and code delay within 0.32 chip.
* ``master_parity`` (tests/test_master_parity.py): 38 s at 47 dBHz,
  seed 3, PRNs 2, 7, 15, 24 cold.  The found frequency bins within one
  500 Hz bin; the nav bits piecewise equal (a global inversion, at most
  5 slip segments, junk bits only at transitions); single-differenced
  relative pseudoranges in the {-1, 0, +1} light-ms classes with the 0
  class >= 25 %, sub-ms residuals < 160 m, overlap mean < 40 m and 2 s
  window means < 55 m.
* ``stress_cn0_45`` (tests/test_parity_stress.py's tier-1 point): 20 s at
  45 dBHz, seed 11, four hinted channels, code filter off, 100-epoch
  blocks.  All four channels synced in both pipelines; bits piecewise
  equal; code-delay trajectory bias < 0.32, jitter < 0.12 and drift
  < 0.1 chip.
* ``wire_format`` (tests/test_reference_format_e2e.py): 2.3 s of PRN 19
  at 52 dBHz, 3 codes a bit, simulated at the reference plan and packed
  to SPI words; tracking within 15 Hz, > 400 bits, >= 1 subframe.

chip_smoke.py runs every suite with the Receiver on the card (the
tracking-scan kernel); the CPU tests run the pipelines and the bars on
the CPU.  A failed bar raises ParityError.  The native library and the
generator must build (no fallback).
"""

from __future__ import annotations

import tempfile
import time

import numpy as np

SUITES = {
    "firmware_parity": dict(
        capture=dict(cib=20, duration_ms=12000, cn0=48, seed=11),
        channels=((24, 500), (7, -3000)), block=500, code_filter=True),
    "master_parity": dict(
        capture=dict(cib=20, duration_ms=38000, cn0=47, seed=3),
        channels=((2, None), (7, None), (15, None), (24, None)), block=500,
        code_filter=True),
    "stress_cn0_45": dict(
        capture=dict(cib=20, duration_ms=20000, cn0=45, seed=11),
        channels=((24, 500), (2, -2500), (15, -2200), (7, -3000)),
        block=100, code_filter=False),
}

# tests/test_nav.py's ephemeris, the wire-format suite's nav message
TEST_EPH = dict(
    week=2290, iodc=57, iode=57, sva=2, svh=0, tgd=-1.2107193470e-08,
    toc_s=352800.0, f0=2.5634365156e-04, f1=-3.5242919693e-12, f2=0.0,
    crs=-115.21875, deln=4.0465882771e-09, M0=-2.2314427737,
    cuc=-6.0573220253e-06, e=0.0110899875, cus=5.1585957408e-06,
    A=26560278.1, toes=352800.0, fit=0, cic=-1.1175870895e-08,
    OMG0=-0.5971402355, cis=1.1548399925e-07, i0=0.9884864476,
    crc=287.46875, omg=0.6811469216, OMGd=-8.1625543586e-09,
    idot=-4.8930396158e-10,
)


class ParityError(AssertionError):
    """A bar of the firmware-oracle suites failed."""


def _require(ok, *msg) -> None:
    if not ok:
        raise ParityError(msg)


def receiver_config(suite: str, in_kernel_scan=None):
    """The ReceiverConfig the JAX suite gives its Receiver."""
    from ..config import ReceiverConfig, TrackConfig

    s = SUITES[suite]
    hints = [h for _, h in s["channels"]]
    return ReceiverConfig(
        prns=tuple(p for p, _ in s["channels"]),
        doppler_hints_hz=(None if all(h is None for h in hints)
                          else tuple(float(h) for h in hints)),
        track=TrackConfig(pll_bad_state_threshold=10**9,
                          in_kernel_scan=in_kernel_scan),
        enable_position=False,
        enable_code_filter=s["code_filter"],
        track_block_epochs=s["block"],
    )


def generate(suite: str, directory: str):
    """(SPI words, truth) of the suite's capture."""
    from ..runtime import native

    return native.capture_gen(directory, suite, **SUITES[suite]["capture"])


def run_oracle(suite: str, words) -> dict:
    """The firmware pipeline as the suite runs it: {prn: channel dict}
    (per-channel runs with hints), or the master run for the cold suite
    (its channels under ``"channels"``)."""
    from ..runtime import native

    s = SUITES[suite]
    if native.get_lib() is None:
        raise RuntimeError("the native library (native/libsdr_native.so) "
                           "is unavailable")
    if suite == "master_parity":
        return native.firmware_master_run(words, [p for p, _ in s["channels"]])
    return {prn: native.firmware_receiver_run(words, prn, hint)
            for prn, hint in s["channels"]}


def run_receiver(baseband, cfg, device="cuda", observables=False):
    """``Receiver.run`` with every nav bit recorded as it is pushed
    ({prn: [(epoch, value)]}), the code delay at each block's end ({prn:
    [(epoch, delay chips)]}) and, with ``observables``, the observables
    formed at each block's end once every channel holds a subframe
    boundary ([(epoch, {prn: P m})]).  Returns (receiver, report, bits,
    trajectory, observables)."""
    from ..pvt.observables import ChannelObservables, form_observations
    from ..runtime.receiver import Receiver

    rx = Receiver(cfg, device=device)
    bits = {p: [] for p in cfg.prns}
    traj = {p: [] for p in cfg.prns}
    obs = []
    push = rx._push_channel_bit

    def hook(ch, value, epoch):
        bits[ch.prn].append((int(epoch), int(value)))
        return push(ch, value, epoch)

    def status(r):
        for c in r.channels:
            traj[c.prn].append((r.epoch_cursor - 1,
                                (1023.0 - c.code_phase_chips) % 1023.0))
        ready = [c for c in r.channels if c.subframe_time_ms > 0]
        if not observables or len(ready) < len(cfg.prns):
            return
        epoch = r.epoch_cursor - 1
        o = form_observations([ChannelObservables(
            prn=c.prn, subframe_time_ms=c.subframe_time_ms,
            tow_s=c.subframe_tow_s, week=c.eph.week or 2290,
            code_phase_chips=c.code_phase_chips, doppler_hz=c.doppler_hz,
            snr_db=c.snr_db) for c in ready], epoch)
        if o:
            obs.append((epoch, {x.sat: x.P for x in o}))

    rx._push_channel_bit = hook
    report = rx.run(baseband, status_callback=status)
    return rx, report, bits, traj, obs


# ---------------------------------------------------------------- the bars

def check_oracle_tracks(fw: dict, truth: dict) -> None:
    """test_firmware_pipeline_tracks_and_syncs."""
    by_prn = {s["prn"]: s for s in truth["sats"]}
    for prn, r in fw.items():
        _require(r["tracking"], prn)
        _require(r["sync_ms"] > 0, prn, "firmware bit sync never achieved")
        _require(len(r["bits"]) > 250, prn, len(r["bits"]))
        dop = float(np.mean(r["doppler_hz"][-20:]))
        _require(abs(dop - by_prn[prn]["doppler_hz"]) < 15.0, prn, dop)


def check_bits_exact(fw: dict, bits: dict) -> dict:
    """test_nav_bits_bit_exact_between_pipelines: every firmware bit on
    the shared 20 ms grid (its start within one epoch of a port bit's)
    equal to the port's up to one global polarity; >= 300 matched, at
    most 3 % unmatched.  Returns {prn: (agree, disagree, unmatched)}."""
    rec = {}
    for prn, r in fw.items():
        fb, fs = np.asarray(r["bits"]), np.asarray(r["bit_times"])
        tt = np.asarray([t for t, _ in bits[prn]])
        tb = np.asarray([v for _, v in bits[prn]])
        agree = disagree = unmatched = 0
        for v, s in zip(fb, fs):
            js = np.nonzero(np.abs(tt - s) <= 1)[0]
            if len(js) == 0:
                unmatched += 1
            elif v == tb[js[0]]:
                agree += 1
            else:
                disagree += 1
        matched = agree + disagree
        _require(matched >= 300, prn, matched)
        _require(unmatched <= 0.03 * len(fb), prn, unmatched, len(fb))
        _require(min(agree, disagree) == 0, prn,
                 f"bit mismatches: {min(agree, disagree)}/{matched}")
        rec[prn] = (agree, disagree, unmatched)
    return rec


def check_loop_states(fw: dict, channels: dict) -> dict:
    """test_loop_states_agree_between_pipelines: the last 20 oracle
    Dopplers' mean within 5 Hz of the port's, the code delay within 0.32
    chip.  Returns {prn: (Doppler difference Hz, delay difference
    chips)}."""
    rec = {}
    for prn, r in fw.items():
        ch = channels[prn]
        fw_dop = float(np.mean(r["doppler_hz"][-20:]))
        _require(abs(fw_dop - ch.doppler_hz) < 5.0, prn, fw_dop,
                 ch.doppler_hz)
        fw_delay = float(np.mean(r["code_phase_fine"][-20:])) / 16.0
        delay = (1023.0 - ch.code_phase_chips) % 1023.0
        err = (fw_delay - delay + 511.5) % 1023.0 - 511.5
        _require(abs(err) < 0.32, prn, fw_delay, delay, err)
        rec[prn] = (ch.doppler_hz - fw_dop, err)
    return rec


def _match_bits(fw_bits, fw_times, port_bits, max_offset=9):
    """tests/parity_util.match_bits: each firmware bit against its
    nearest port bit within 9 epochs; (xor stream, unmatched)."""
    tt = np.asarray([t for t, _ in port_bits])
    tb = np.asarray([v for _, v in port_bits])
    xs, unmatched = [], 0
    for v, s in zip(np.asarray(fw_bits), np.asarray(fw_times)):
        j = int(np.argmin(np.abs(tt - s)))
        if abs(int(tt[j]) - int(s)) > max_offset:
            unmatched += 1
            continue
        xs.append(int(v) ^ int(tb[j]))
    return np.asarray(xs, np.int64), unmatched


def _xor_runs(xs):
    runs, start = [], 0
    for i in range(1, len(xs)):
        if xs[i] != xs[start]:
            runs.append((int(xs[start]), i - start))
            start = i
    if len(xs):
        runs.append((int(xs[start]), len(xs) - start))
    return runs


def check_bits_piecewise(tag, prn, fw_ch, port_bits,
                         min_matched=150) -> dict:
    """tests/parity_util.assert_bits_piecewise: the streams equal up to a
    global inversion, at most 5 slip segments (runs >= 3) and junk bits
    (runs < 3) at most max(5, 1 %)."""
    xs, unmatched = _match_bits(fw_ch["bits"], fw_ch["bit_times"],
                                port_bits[prn])
    n, n_fw = len(xs), max(len(fw_ch["bits"]), 1)
    _require(n >= min(min_matched, int(0.8 * n_fw)), tag, prn, n)
    _require(unmatched <= max(2, 0.02 * n_fw), tag, prn, unmatched)
    runs = _xor_runs(xs)
    segments = [r for r in runs if r[1] >= 3]
    junk = sum(r[1] for r in runs if r[1] < 3)
    _require(len(segments) <= 5, tag, prn, runs[:20])
    _require(junk <= max(5, 0.01 * n), tag, prn, junk, runs[:20])
    return {"matched": n, "unmatched": unmatched,
            "segments": len(segments), "junk": junk}


def check_cold_bins(fw: dict, channels: dict, truth: dict) -> dict:
    """test_cold_frequency_search_parity: every oracle bin within 500 Hz
    of the truth, the port's acquisition within 500 Hz of the oracle's
    bin.  Returns {prn: (oracle bin, port acquisition Doppler)}."""
    by_prn = {s["prn"]: s for s in truth["sats"]}
    _require(fw["tracking_count"] == len(channels), fw["tracking_count"])
    rec = {}
    for chd in fw["channels"]:
        prn = chd["prn"]
        _require(chd["found_freq_hz"] > -100000, prn, "freq search failed")
        _require(abs(chd["found_freq_hz"] - by_prn[prn]["doppler_hz"])
                 <= 500.0, prn, chd["found_freq_hz"])
        dop = channels[prn].acq.doppler_hz
        _require(abs(dop - chd["found_freq_hz"]) <= 500.0, prn, dop,
                 chd["found_freq_hz"])
        rec[prn] = (chd["found_freq_hz"], dop)
    return rec


def check_relative_pseudoranges(fw: dict, obs: list) -> dict:
    """test_relative_pseudorange_parity: the port's single-differenced
    pseudoranges against the oracle's ledger (interpolated, intervals
    across an oracle light-ms step skipped), from 1.2 s after the ledger
    starts: only the {-1, 0, +1} light-ms classes, the 0 class >= 25 %,
    every sub-ms residual < 160 m, the 0 class's mean < 40 m and its 2 s
    window means < 55 m.  Returns the comparisons made and the worst
    sub-ms residual (m)."""
    from ..config import CLIGHT

    _require(len(obs) >= 10, "too few port observable epochs", len(obs))
    ft = np.asarray(fw["pr_times_ms"], np.float64)
    fpr = np.asarray(fw["pseudorange_m"])
    _require(fpr.shape[1] >= 10, "too few oracle pseudoranges")
    order = [chd["prn"] for chd in fw["channels"]]
    light_ms = CLIGHT / 1000.0
    t_ok = ft >= ft[0] + 1000.0
    fts = ft[t_ok]
    ref = order[0]
    checked, worst = 0, 0.0
    for i, prn in enumerate(order[1:], 1):
        d_fw = (fpr[i] - fpr[0])[t_ok]
        steps = [(fts[k], fts[k + 1]) for k in
                 np.nonzero(np.abs(np.diff(d_fw)) > 0.5 * light_ms)[0]]
        rows = []
        for epoch, pmap in obs:
            if epoch < ft[0] + 1200.0 or epoch > fts[-1]:
                continue
            if any(a < epoch < b for a, b in steps):
                continue
            rows.append((float(epoch), float(pmap[prn] - pmap[ref])
                         - float(np.interp(epoch, fts, d_fw))))
        checked += len(rows)
        _require(len(rows) >= 6, prn, len(rows))
        t = np.asarray([r[0] for r in rows])
        e = np.asarray([r[1] for r in rows])
        ms_class = np.round(e / light_ms)
        sub_ms = e - ms_class * light_ms
        vals, cnts = np.unique(ms_class, return_counts=True)
        _require(set(vals.tolist()) <= {-1.0, 0.0, 1.0}, prn, vals)
        frac0 = (cnts[vals == 0].sum() / len(e)) if 0 in vals else 0.0
        _require(frac0 >= 0.25, prn, dict(zip(vals.tolist(), cnts.tolist())))
        worst = max(worst, float(np.abs(sub_ms).max()))
        _require(np.abs(sub_ms).max() < 160.0, prn, np.abs(sub_ms).max())
        e0, t0 = e[ms_class == 0], t[ms_class == 0]
        _require(abs(e0.mean()) < 40.0, prn, e0.mean())
        for w0 in np.arange(t0[0], t0[-1], 2000.0):
            sel = (t0 >= w0) & (t0 < w0 + 2000.0)
            if sel.sum() >= 2:
                _require(abs(e0[sel].mean()) < 55.0, prn, w0,
                         e0[sel].mean())
    _require(checked >= 20, "too few comparable epochs", checked)
    return {"single_differences": checked, "worst_sub_ms_m": worst}


def check_trajectory(tag, prn, fw_ch, traj) -> dict:
    """tests/test_parity_stress._assert_trajectory: after both loops
    settle, the port's code delay against the oracle's (unwrapped,
    interpolated): bias < 0.32, jitter < 0.12, drift between the first
    and last thirds < 0.1 chip."""
    ft = np.asarray(fw_ch["traj_times"], np.float64)
    fd = np.asarray(fw_ch["code_phase_fine"], np.float64) / 16.0
    te = np.asarray([e for e, _ in traj[prn]], np.float64)
    td = np.asarray([d for _, d in traj[prn]], np.float64)
    keep = (te >= max(2000.0, ft[0] + 1500.0)) & (te <= ft[-1])
    _require(keep.sum() >= 30, tag, prn, int(keep.sum()))
    fd_un = np.unwrap(fd * (2 * np.pi / 1023.0)) * (1023.0 / (2 * np.pi))
    err = (td[keep] - np.interp(te[keep], ft, fd_un) + 511.5) % 1023.0 \
        - 511.5
    n = len(err)
    drift = err[: n // 3].mean() - err[-(n // 3):].mean()
    _require(abs(err.mean()) < 0.32, tag, prn, err.mean())
    _require(err.std() < 0.12, tag, prn, err.std())
    _require(abs(drift) < 0.1, tag, prn, drift)
    return {"bias": float(err.mean()), "jitter": float(err.std()),
            "drift": float(drift)}


def check_stress(fw: dict, bits: dict, traj: dict, channels,
                 min_fw_synced: int = 4) -> dict:
    """test_parity_under_stress at a non-cold point: at least
    ``min_fw_synced`` oracle channels synced with > 150 bits, every port
    channel synced with > 100 bits, and each oracle-synced channel's bits
    and trajectory held to the bars above."""
    fw_synced = [prn for prn, r in fw.items()
                 if r["tracking"] and r["sync_ms"] > 0
                 and len(r["bits"]) > 150]
    _require(len(fw_synced) >= min_fw_synced, fw_synced,
             "the firmware margin moved")
    synced = {c.prn: c.bit_synced and c.bit_count > 100 for c in channels}
    _require(all(synced.values()), synced)
    return {prn: {**check_bits_piecewise("stress", prn, fw[prn], bits),
                  **check_trajectory("stress", prn, fw[prn], traj)}
            for prn in fw_synced}


def check_wire_format(report) -> dict:
    """test_wire_format_to_subframes: PRN 19 tracking within 15 Hz of
    2500 Hz, > 400 bits, >= 1 subframe, the week decoded where subframe 1
    was."""
    ch = report.channels[0]
    _require(ch.state_name == "TRACKING", ch.state_name)
    _require(abs(ch.doppler_hz - 2500.0) < 15.0, ch.doppler_hz)
    _require(ch.bit_count > 400, ch.bit_count)
    _require(ch.subframe_count >= 1, ch.framer.words_decoded,
             ch.framer.polarity_found)
    if ch.eph.received_mask_proc & 0x1:
        _require(ch.eph.week == TEST_EPH["week"], ch.eph.week)
    return {"doppler_hz": ch.doppler_hz, "bits": ch.bit_count,
            "subframes": ch.subframe_count}


# ---------------------------------------------------------------- suites

def wire_format_capture():
    """test_reference_format_e2e's capture: (SPI words, signs)."""
    from ..config import REFERENCE_PLAN
    from ..signal.capture import pack_bits_lsb16
    from ..signal.nav_message import build_bitstream
    from ..signal.simulator import SimSat, simulate_capture

    prefix = np.tile([0, 1], 50).astype(np.int8)
    body = build_bitstream(dict(TEST_EPH), start_tow_6s=700,
                           num_subframes=2, subframe_ids=(5, 1))
    sat = SimSat(prn=19, doppler_hz=2500.0, cn0_dbhz=52.0,
                 nav_bits=np.concatenate([prefix, body]), codes_in_bit=3,
                 delay_ms=4.321)
    x, _ = simulate_capture([sat], num_epochs=2300, plan=REFERENCE_PLAN,
                            seed=17)
    return pack_bits_lsb16(x), x


def wire_format_config():
    from ..config import ReceiverConfig, TrackConfig

    return ReceiverConfig(
        prns=(19,), track=TrackConfig(codes_in_bit=3,
                                      pll_bad_state_threshold=10**9),
        enable_position=False, track_block_epochs=250)


def run_suite(suite: str, device="cuda", capture=None) -> dict:
    """Run both pipelines on the suite's capture (``capture`` = (words,
    truth), or generated here; the wire-format suite simulates its own)
    and apply the suite's bars (raises ParityError where one fails).
    Returns its record, with the Receiver under ``"receiver"``."""
    from ..runtime import native
    from ..signal.capture import reference_to_baseband

    t0 = time.perf_counter()
    if suite == "wire_format":
        words, _ = wire_format_capture()
        rx, report, *_ = run_receiver(
            reference_to_baseband(native.unpack_bits16(words)),
            wire_format_config(), device)
        return {"suite": suite, **check_wire_format(report),
                "seconds": time.perf_counter() - t0, "receiver": rx}
    if capture is None:
        with tempfile.TemporaryDirectory() as tmp:
            capture = generate(suite, tmp)
    words, truth = capture
    t_fw = time.perf_counter()
    fw = run_oracle(suite, words)
    t_fw = time.perf_counter() - t_fw
    cfg = receiver_config(suite)
    rx, report, bits, traj, obs = run_receiver(
        reference_to_baseband(native.unpack_bits16(words)), cfg, device,
        observables=suite == "master_parity")
    channels = {ch.prn: ch for ch in report.channels}
    rec = {"suite": suite, "oracle_s": t_fw}
    if suite == "firmware_parity":
        check_oracle_tracks(fw, truth)
        rec["bits"] = check_bits_exact(fw, bits)
        rec["loop"] = check_loop_states(fw, channels)
    elif suite == "master_parity":
        rec["bins"] = check_cold_bins(fw, channels, truth)
        rec["bits"] = {chd["prn"]: check_bits_piecewise(
            "cold", chd["prn"], chd, bits, min_matched=300)
            for chd in fw["channels"]}
        rec["pseudoranges"] = check_relative_pseudoranges(fw, obs)
    else:
        rec["channels"] = check_stress(fw, bits, traj, report.channels)
    rec["seconds"] = time.perf_counter() - t0
    rec["receiver"] = rx
    return rec
