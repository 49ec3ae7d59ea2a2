"""tests/test_impairments.py on the port, against the JAX package.

* The port's simulator equals the JAX simulator bit for bit under every
  impairment: the TCXO offset and drift, phase noise and 1.8 MHz
  band-limiting of test_impairments.IMP with multipath on two
  satellites, a 0.9 Hz/s Doppler ramp, ``inject_fault`` in both modes,
  ``fix_scenario`` with impairments and multipath, and the truth
  objects; with impairments off it is the capture it was before them.
* The impaired compressed-time Receiver on the port's reference scan
  against the JAX Receiver (the PRN set and states, ``bit_count`` and
  ``framer.history`` equal, Doppler and code phase within 0.05: the rules
  of tests/test_torch_receiver.py), both under the suite's bars
  (``probes/stress.py``); the tracking-scan kernel's plain version under
  the same bars.
* Behind RUN_SLOW, as in tests/test_e2e_slow.py: the 29 s impaired cold
  start in both packages, on the reference scans and on the kernels'
  semantics: where they part, and the one fade of PRN 15 on which the
  fix turns (test_impaired_cold_start_turns_on_one_fade).
"""

import os

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_tpu.signal import scenarios as j_scenarios
from stm32f4_sdr_gps_tpu.signal import simulator as j_simulator
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.probes import stress
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal import scenarios, simulator
from tests import test_impairments as j_suite

torch.set_num_threads(2)

slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="set RUN_SLOW=1 to run"
)


def jax_config(cfg):
    """The JAX ReceiverConfig of a port ReceiverConfig (the fields the
    suites set)."""
    t = cfg.track
    return JReceiverConfig(
        prns=cfg.prns,
        track=JTrackConfig(codes_in_bit=t.codes_in_bit,
                           pll_bad_state_threshold=t.pll_bad_state_threshold),
        enable_position=cfg.enable_position,
        track_block_epochs=cfg.track_block_epochs)


def assert_receivers_match(j_channels, channels):
    """The port's channels against the JAX Receiver's: the same PRNs and
    states, bit counts and subframe ledgers equal, final Doppler and code
    phase within 0.05 (tests/test_torch_receiver.py's rules)."""
    assert [c.prn for c in channels] == [c.prn for c in j_channels]
    for ch, jch in zip(channels, j_channels):
        assert ch.state_name == jch.state_name, ch.prn
        assert ch.bit_count == jch.bit_count, ch.prn
        assert ch.framer.history == jch.framer.history, ch.prn
        assert abs(ch.doppler_hz - jch.doppler_hz) < 0.05, ch.prn
        assert abs(ch.code_phase_chips - jch.code_phase_chips) < 0.05, ch.prn


def recorded_run(rx, samples):
    """``rx.run(samples)`` with every block's (T, C) outputs recorded (the
    Receiver's full-readback path, ``device_digest=False``): (report,
    TrackOutputs over the whole run as numpy arrays)."""
    blocks = []
    consume = rx._consume_outputs

    def hook(outs, n_epochs):
        blocks.append(outs)
        return consume(outs, n_epochs)

    rx._consume_outputs = hook
    report = rx.run(samples)
    outs = type(blocks[0])(*(
        np.concatenate([np.asarray(getattr(b, f)) for b in blocks])
        for f in blocks[0]._fields))
    return report, outs


def assert_receivers_part_only_where_marginal(j_run, run, parts):
    """Two recorded runs (``recorded_run``) of the JAX and the port's
    Receiver: their (T, C) outputs match under ``assert_scan_match``
    (tests/test_torch_dynamics.py) up to each channel's first marginal
    decision, which must be ``parts`` ({PRN: absolute epoch}).  A channel
    that parts decides the same bits before that epoch; every other
    channel is held to assert_receivers_match's rules."""
    from tests.test_torch_dynamics import assert_scan_match

    (j_report, j_outs), (report, outs) = j_run, run
    first = report.epochs_processed - outs.ip.shape[0]
    found = {report.channels[c].prn: first + t
             for c, t in assert_scan_match(j_outs, outs).items()}
    assert found == parts
    keep = [c for c in range(len(report.channels))
            if report.channels[c].prn not in parts]
    assert_receivers_match([j_report.channels[c] for c in keep],
                           [report.channels[c] for c in keep])
    for ch, jch in zip(report.channels, j_report.channels):
        if ch.prn in parts:
            assert [h for h in ch.framer.history if h[1] < parts[ch.prn]] \
                == [h for h in jch.framer.history if h[1] < parts[ch.prn]]


@pytest.fixture(scope="module")
def impaired():
    """The impaired capture in both packages: (port samples, port truth,
    JAX samples, JAX truth)."""
    x, truth = stress.impaired_capture()
    jx, jtruth = j_suite._impaired_capture(stress.IMP_EPOCHS)
    return x, truth, jx, jtruth


def test_impaired_capture_equals_jax(impaired):
    x, truth, jx, jtruth = impaired
    np.testing.assert_array_equal(x, jx)
    imp = stress.impairments()
    assert vars(imp) == vars(j_suite.IMP)
    for i in range(len(stress.IMP_PRNS)):
        for e in (0, 1, 1000, stress.IMP_EPOCHS - 1):
            assert truth.code_phase_at_epoch(i, e) == \
                jtruth.code_phase_at_epoch(i, e), (i, e)
            assert truth.apparent_doppler_hz(i, e * 1e-3) == \
                jtruth.apparent_doppler_hz(i, e * 1e-3), (i, e)


def test_doppler_ramp_capture_equals_jax():
    kw = dict(prn=14, doppler_hz=-1000.0, code_phase_chips=200.0,
              cn0_dbhz=46.0, doppler_rate_hz_s=0.9)
    a, ta = simulator.simulate_capture([simulator.SimSat(**kw)],
                                       num_epochs=50, seed=12)
    b, tb = j_simulator.simulate_capture([j_simulator.SimSat(**kw)],
                                         num_epochs=50, seed=12)
    np.testing.assert_array_equal(a, b)
    for e in (0, 7, 49):
        assert ta.code_phase_at_epoch(0, e) == tb.code_phase_at_epoch(0, e)
        assert ta.apparent_doppler_hz(0, e * 1e-3) == \
            tb.apparent_doppler_hz(0, e * 1e-3)


@pytest.mark.parametrize("mode", ["dropout", "noise"])
def test_inject_fault_equals_jax(mode):
    sat = dict(prn=6, doppler_hz=1500.0, code_phase_chips=100.0,
               cn0_dbhz=46.0)
    x, _ = simulator.simulate_capture([simulator.SimSat(**sat)],
                                      num_epochs=60, seed=7)
    fault = dict(start_ms=20.0, duration_ms=10.0, mode=mode, seed=1)
    a = simulator.inject_fault(x, **fault)
    b = j_simulator.inject_fault(x, **fault)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, x)


def test_fix_scenario_with_impairments_equals_jax():
    """fix_scenario(impairments=..., multipath=...) at 300 epochs: the
    samples, the planted position, the satellites and the truth."""
    kw = dict(num_epochs=300, multipath=stress.FIX_MULTIPATH)
    imp = dict(tcxo_offset_ppm=-2.0, tcxo_drift_ppm_s=0.003,
               phase_noise_rad2_s=0.5, frontend_bw_hz=1.8e6)
    sc = scenarios.fix_scenario(impairments=simulator.Impairments(**imp),
                                **kw)
    jsc = j_scenarios.fix_scenario(
        impairments=j_simulator.Impairments(**imp), **kw)
    np.testing.assert_array_equal(sc.samples, jsc.samples)
    np.testing.assert_array_equal(sc.rr_true, jsc.rr_true)
    assert sc.prns == jsc.prns
    for i, (s, js) in enumerate(zip(sc.truth.sats, jsc.truth.sats)):
        assert vars(s).keys() == vars(js).keys()
        for k, v in vars(s).items():
            np.testing.assert_array_equal(v, vars(js)[k])
        for e in (0, 150, 299):
            assert sc.truth.code_phase_at_epoch(i, e) == \
                jsc.truth.code_phase_at_epoch(i, e)
            assert sc.truth.apparent_doppler_hz(i, e * 1e-3) == \
                jsc.truth.apparent_doppler_hz(i, e * 1e-3)
    # the short stand-in for the slow suite's scenario is the same call
    short = stress.impaired_fix_scenario(num_epochs=300)
    np.testing.assert_array_equal(short.samples, sc.samples)


def test_impairments_off_is_bit_identical():
    """test_impairments_off_is_bit_identical in the port, and the same
    capture as the JAX simulator's."""
    sat = simulator.SimSat(prn=5, doppler_hz=1000.0, cn0_dbhz=45.0,
                           codes_in_bit=3)
    a, _ = simulator.simulate_capture([sat], num_epochs=5, seed=3)
    b, _ = simulator.simulate_capture([sat], num_epochs=5, seed=3,
                                      impairments=simulator.Impairments())
    np.testing.assert_array_equal(a, b)
    j, _ = j_simulator.simulate_capture(
        [j_simulator.SimSat(prn=5, doppler_hz=1000.0, cn0_dbhz=45.0,
                            codes_in_bit=3)], num_epochs=5, seed=3)
    np.testing.assert_array_equal(a, j)


def test_impaired_receiver_matches_jax(impaired):
    """The port's Receiver on its reference scan (the CPU default)
    against the JAX Receiver on the impaired capture; the suite's bars on
    both."""
    x, truth, _, jtruth = impaired
    cfg = stress.compressed_config(stress.IMP_PRNS, stress.IMP_BLOCK)
    j_rx = JReceiver(jax_config(cfg))
    j_report = j_rx.run(x)
    stress.check_impairments(j_report, jtruth)
    report, _ = stress.run_receiver(x, cfg, "cpu")
    stress.check_impairments(report, truth)
    assert_receivers_match(j_report.channels, report.channels)


def test_impaired_receiver_kernel_plain_version(impaired):
    """The tracking-scan kernel's plain version (the semantics of K1 on
    the card) under the suite's bars, one call a block."""
    x, truth, _, _ = impaired
    calls = ts.track_scan_reference.calls
    report, rx = stress.run_receiver(
        x, stress.compressed_config(stress.IMP_PRNS, stress.IMP_BLOCK,
                                    in_kernel_scan=True), "cpu")
    assert ts.track_scan_reference.calls - calls == \
        rx.profiler.stages["track"].calls
    stress.check_impairments(report, truth)


# the 29 s impaired fix's knife edge: PRN 15 (channel 2) fades at epoch
# FADE_EPOCH; where its prompt comes out negative there, the firmware-mode
# bit sync ends a bit there, 15 epochs after the last (SPLIT_EPOCHS), and
# subframe 3 fails parity
FADE_EPOCH = 24267
SPLIT_EPOCHS = (24252, 24267)
# where the port's runs part from the JAX package's (tracked epoch index:
# channel -> epoch), each at a half-chip replica cell
FIX_PARTS = {"reference": {0: 2537, 1: 7260, 2: 2959, 3: 1958},
             "kernel": {0: 1054, 1: 1994, 2: 890, 3: 793}}


def _split(outs, c=2):
    ready = np.asarray(outs.bit_ready)[:, c].astype(bool)
    eps = np.asarray(outs.bit_epoch)[:, c][ready]
    i = np.nonzero(eps == SPLIT_EPOCHS[0])[0]
    return bool(i.size and eps[i[0] + 1] == SPLIT_EPOCHS[1])


@slow
def test_impaired_cold_start_turns_on_one_fade():
    """tests/test_e2e_slow.py::test_cold_start_fix_under_rf_impairments
    in both packages on the same capture, each on its reference scan and
    on its kernel semantics (the JAX Pallas kernel in interpret mode, the
    port's plain version), recorded on the full-readback path.  The
    port's runs part from the JAX package's only at marginal decisions
    (FIX_PARTS) and every run decodes PRNs 2, 7 and 24 in full.  PRN 15
    fades at FADE_EPOCH (|ip| < 10 against ~200): the JAX reference
    scan's prompt there is positive and it makes the fix within 700 m;
    on the three other trajectories it is negative, the bit sync splits
    a bit 15/5 and subframe 3 fails, so there is no fix.  The JAX kernel
    on its default block-digest path (which carries its scan state
    between blocks) lands on the positive side and makes the fix: the
    outcome turns on one fade, inside the reference (ROADMAP Queue 3)."""
    from tests.test_torch_dynamics import assert_scan_match

    sc = stress.impaired_fix_scenario()
    x = sc.samples
    first = 10
    kw = dict(prns=sc.prns, track_block_epochs=1000)
    kernel = JTrackConfig(in_kernel_scan=True, pallas_interpret=True)
    runs = {
        "jax_reference": recorded_run(JReceiver(JReceiverConfig(
            device_digest=False, **kw)), x),
        "jax_kernel": recorded_run(JReceiver(JReceiverConfig(
            device_digest=False, track=kernel, **kw)), x),
        "reference": recorded_run(Receiver(stress.impaired_fix_config(
            sc.prns).replace(device_digest=False), device="cpu"), x),
        "kernel": recorded_run(Receiver(stress.impaired_fix_config(
            sc.prns, in_kernel_scan=True).replace(device_digest=False),
            device="cpu"), x),
    }
    for port, jax in (("reference", "jax_reference"),
                      ("kernel", "jax_kernel")):
        assert assert_scan_match(runs[jax][1], runs[port][1]) == \
            FIX_PARTS[port]
    for name, (report, outs) in runs.items():
        full = [ch.prn for ch in report.channels if ch.eph.has_full_set]
        ip = float(np.asarray(outs.ip)[FADE_EPOCH - first, 2])
        assert abs(ip) < 10.0, (name, ip)
        if name == "jax_reference":
            assert ip > 0 and not _split(outs), name
            ref_err, _ = stress.check_impaired_fix(report, sc.rr_true)
        else:
            assert ip < 0 and _split(outs), (name, ip)
            assert full == [2, 7, 24] and not report.solutions, name
    j_report = JReceiver(JReceiverConfig(track=kernel, **kw)).run(x)
    err, _ = stress.check_impaired_fix(j_report, sc.rr_true)
    print(f"impaired 29 s fix: the JAX reference scan {ref_err:.2f} m, the "
          f"JAX kernel on its digest path {err:.2f} m; no fix on the other "
          "kernel and port trajectories")
