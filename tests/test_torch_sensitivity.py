"""tests/test_sensitivity.py's claims on the port, against the JAX package,
on the CPU (``ultra_acq_28`` and the deep chain are in
test_torch_sensitivity_deep.py).

* Acquisition (``probes.sensitivity``'s acquisition claims): each
  claim's bar on the port, and every acquisition against the JAX
  package's ``acquire`` on the same capture: detection flags equal,
  Doppler within one bin, code phase within 0.01 chip, peak ratio within
  2 % (tests/test_torch_acquire_modes.py:159-164).
* Tracking (``lock_38``, ``weak_track_29``): the bar on the port's
  reference scan and on the tracking-scan kernel's plain version (the
  card's arithmetic), and the reference scan against the JAX reference
  scan with the tolerances of tests/test_pallas_scan.py:68-117 and exact
  integer decisions (tests/test_torch_dynamics.py::assert_scan_match:
  a channel may part only at a marginal epoch, and PARTS names each).
* ``probes.deep_cold.check_fix``, the 29 dBHz cold start's bar, and
  ``check_outcome`` (the bar or a seed's known miss, exactly), on given
  records; ``scan_parts`` (two runs of a block held to each other up to
  a named marginal decision) on given slot streams, ``held_block`` in a
  spawned worker process and ``check_held`` on its parts, and
  ``compare_traces`` (two whole runs) on given traces.

The captures come from the port's simulator; both packages get them as
numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu import config as jcfg
from stm32f4_sdr_gps_tpu.acquire.engine import acquire as j_acquire
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.probes import deep_cold
from stm32f4_sdr_gps_torch.probes import sensitivity as sens
from tests.test_torch_dynamics import assert_scan_match

torch.set_num_threads(2)

J_PLAN = jcfg.BASEBAND_PLAN


def _jax_acq(x, prn, cfg):
    """The JAX package's acquisition under the port config's fields."""
    jc = jcfg.AcqConfig(**{f: getattr(cfg, f) for f in (
        "doppler_span_hz", "doppler_step_hz", "noncoherent_epochs",
        "coherent_epochs", "edge_hypotheses", "detect_ratio")})
    return j_acquire(x, [prn], J_PLAN, jc)[0], jc


def _same_acq(rec, x, prn, cfg):
    """One of the port's acquisition records against the JAX package's on
    the same capture."""
    r, jc = _jax_acq(x, prn, cfg)
    assert rec["detected"] == bool(r.detected), (rec, r)
    assert abs(rec["doppler_hz"] - r.doppler_hz) <= jc.doppler_step_hz, (
        rec, r)
    cp = abs(rec["code_phase_chips"] - r.code_phase_chips) % 1023
    assert min(cp, 1023 - cp) < 0.01, (rec, r)
    assert abs(rec["peak_ratio"] - r.peak_ratio) < 0.02 * r.peak_ratio, (
        rec, r)


def test_detect_36():
    rec = sens.detect_36("cpu")
    assert rec["hits"] >= 4
    for seed, x in sens.detect_36_captures().items():
        _same_acq(rec["runs"][seed], x, 23, jcfg.AcqConfig())


def test_no_false_alarms():
    rec = sens.no_false_alarms("cpu")
    for seed, x in sens.no_false_alarms_captures().items():
        _same_acq(rec["runs"][seed], x, 22, jcfg.AcqConfig())


def test_integration_33():
    rec = sens.integration_33("cpu")
    _same_acq(rec["r40"], sens.integration_33_capture(), 6,
              sens.INTEGRATION_33)


def test_deep_acq_31():
    rec = sens.deep_acq_31("cpu")
    x = sens.deep_acq_31_capture()
    _same_acq(rec["noncoherent"], x, 5, sens.DEEP_NC)
    _same_acq(rec["deep"], x, 5, sens.DEEP_ACQ)


JAX_TRACK = {"lock_38": jcfg.TrackConfig(),
             "weak_track_29": jcfg.WEAK_SIGNAL_TRACK}
# where the port's reference scan parts from the JAX one: {claim: {channel:
# epoch}}.  lock_38 at 1414: the code phase sits at 400.9999 chip (1.2e-4
# chip apart in the two scans), a half-chip cell boundary that the two
# replicas straddle (ROADMAP Queue 3, "Half-chip cell at a boundary")
PARTS = {"lock_38": {0: 1414}, "weak_track_29": {}}


@pytest.mark.parametrize("name", list(sens.TRACK_CLAIMS))
def test_tracking_claim_matches_jax(name):
    """The port's reference scan (the CPU default) under the claim's bar
    and against the JAX reference scan, as tests/test_sensitivity.py runs
    it, up to the named marginal epoch (PARTS)."""
    st, outs, rec = sens.track_claim(name, "cpu")
    _, e, dop0 = sens.TRACK_CLAIMS[name][:3]
    x, _ = sens.track_capture(name)
    st_ref, out_ref = j_track_block(
        j_init_state(1, np.array([400.2]), np.array([dop0])),
        jnp.asarray(x.reshape(e, 2046)), jnp.asarray(ca_table_bipolar([9])),
        J_PLAN, JAX_TRACK[name])
    assert assert_scan_match(out_ref, outs, st_ref, st) == PARTS[name]


@pytest.mark.parametrize("name", list(sens.TRACK_CLAIMS))
def test_tracking_claim_on_the_kernel_plain_version(name):
    """The claim's bar on the tracking-scan kernel's plain version: the
    arithmetic K1 runs on the card (half-chip replica, polynomial
    Costas)."""
    rec = sens.track_claim(name, "cpu", in_kernel_scan=True)[2]
    assert set(rec) == {"doppler_err_hz", "code_err_chips"}


def _deep_record(fix_m, short=(), unsynced=(), short_subframes=0):
    chans = [{"prn": p, "bit_synced": p not in unsynced,
              "eph_full": p not in short, "mask": 0 if p in short else 31,
              "snr_db": 2.0,
              "subframes": short_subframes if p in short else 8}
             for p in (2, 7, 15, 24)]
    return {"channels": chans, "fix_error_m": fix_m,
            "solutions": 0 if fix_m is None else 11}


@pytest.mark.parametrize("rec, ok", [
    (_deep_record(204.8), True),
    (_deep_record(259.9), True),
    (_deep_record(499.9), True),
    (_deep_record(None, short=(15,)), False),
    (_deep_record(None, short=(7,)), False),
    (_deep_record(None), False),
    (_deep_record(None, short=(7, 15)), False),
    (_deep_record(204.8, unsynced=(24,)), False),
    (_deep_record(612.0), False),
    (_deep_record(150.0, short=(15,)), False),
])
def test_deep_cold_check_fix(rec, ok):
    """deep_cold.check_fix: tests/test_e2e_slow.py:83-90's bar (every set
    full, every channel synced, a fix within 500 m); anything else
    raises."""
    if ok:
        deep_cold.check_fix(rec)
    else:
        with pytest.raises(deep_cold.DeepColdError):
            deep_cold.check_fix(rec)
    lines = deep_cold.report_lines(rec)
    assert len(lines) == 5 and ("NO FIX" in lines[-1]) == (
        rec["fix_error_m"] is None)


@pytest.mark.parametrize("rec, seed, want", [
    (_deep_record(204.8), 21, "fix"),
    (_deep_record(257.6), 7, "fix"),
    (_deep_record(194.1), 42, "fix"),
    (_deep_record(None, short=(15,)), 7, "known miss"),
    (_deep_record(None, short=(15,)), 42, "known miss"),
    # no miss is known on seed 21
    (_deep_record(None, short=(15,)), 21, None),
    # another PRN short, two short, none short
    (_deep_record(None, short=(7,)), 7, None),
    (_deep_record(None, short=(7, 15)), 42, None),
    (_deep_record(None), 42, None),
    # PRN 15 with a subframe, a channel not synced, a fix far off
    (_deep_record(None, short=(15,), short_subframes=1), 42, None),
    (_deep_record(None, short=(15,), unsynced=(24,)), 7, None),
    (_deep_record(612.0, short=(15,)), 7, None),
])
def test_deep_cold_check_outcome(rec, seed, want):
    """deep_cold.check_outcome: the bar, or on a seed of KNOWN_MISS
    exactly that miss (the one PRN short, its subframes, no fix, every
    channel synced); anything else raises."""
    if want is None:
        with pytest.raises(deep_cold.DeepColdError):
            deep_cold.check_outcome(rec, seed)
    else:
        assert deep_cold.check_outcome(rec, seed) == want


def test_deep_cold_check_held():
    """deep_cold.check_held: parts at a marginal decision pass, a part
    with none is a kernel fault."""
    parts = [{"block": 120, "channel": 1, "epoch": 401,
              "marginal": "half_chip", "marginal_epoch": 99},
             {"block": 52120, "channel": 2, "epoch": 476,
              "marginal": "prompt_sign", "marginal_epoch": 130}]
    deep_cold.check_held([])
    deep_cold.check_held(parts)
    with pytest.raises(deep_cold.DeepColdError):
        deep_cold.check_held(parts + [{"block": 1120, "channel": 0,
                                       "epoch": 30, "marginal": None,
                                       "marginal_epoch": None}])


def test_held_block_in_a_worker_process():
    """deep_cold.held_block, as run_traced submits it to spawned worker
    processes: a block of the plain version held to itself has no part;
    with a Doppler 2 Hz off in the held stream and no decision near it,
    the part has no marginal decision (a kernel fault)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
    from stm32f4_sdr_gps_torch.ops import track_scan as ts
    from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
    from stm32f4_sdr_gps_torch.signal.ca_code import \
        ca_table_bipolar as t_ca_table
    from stm32f4_sdr_gps_torch.signal.simulator import (SimSat,
                                                        simulate_capture)
    from stm32f4_sdr_gps_torch.track.state import init_state

    x, _ = simulate_capture([SimSat(prn=3, doppler_hz=1200.0,
                                    code_phase_chips=300.0, cn0_dbhz=45.0)],
                            num_epochs=30, seed=5)
    epochs = torch.as_tensor(x.reshape(30, BASEBAND_PLAN.samples_per_epoch))
    u2 = torch.as_tensor(upsampled_code_doubled(t_ca_table([3])))
    st = ts.state_from_track_state(init_state(
        1, np.array([300.1]), np.array([1210.0]), device="cpu"))
    tcfg = TrackConfig()
    _, raw = ts.track_scan_reference(st, epochs, u2, BASEBAND_PLAN, tcfg)
    bad = raw.clone()
    bad[20, 3, 0] += 2.0
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
            "spawn"), initializer=deep_cold.worker_init) as procs:
        jobs = [procs.submit(deep_cold.held_block, st, epochs, u2,
                             BASEBAND_PLAN, tcfg, r) for r in (raw, bad)]
        same, fault = (j.result(timeout=120) for j in jobs)
    assert same == {}
    assert {c: (p["epoch"], p["marginal"]) for c, p in fault.items()} == {
        0: (20, None)}
    with pytest.raises(deep_cold.DeepColdError):
        deep_cold.check_held([{"block": 0, "channel": 0, **fault[0]}])


def _raw(t_cnt=40, c_cnt=2, seed=3):
    """A (T, NOUT, C) slot stream with prompt sums well away from zero."""
    from stm32f4_sdr_gps_torch.ops.track_scan import NOUT

    rng = np.random.default_rng(seed)
    raw = np.zeros((t_cnt, NOUT, c_cnt), np.float32)
    raw[:, 0] = rng.choice([-1.0, 1.0], (t_cnt, c_cnt)) * rng.uniform(
        50.0, 100.0, (t_cnt, c_cnt))
    raw[:, 1] = rng.uniform(-20.0, 20.0, (t_cnt, c_cnt))
    raw[:, 2] = 100.1 + 1e-3 * np.arange(t_cnt)[:, None]
    raw[:, 3] = 250.0
    raw[:, 8], raw[:, 10] = 900.0, 300.0
    return raw


@pytest.mark.parametrize("edit, want", [
    (None, {}),
    # a prompt sum of the other sign, near zero in both runs, and the bit
    # sync that follows from it: marginal
    (lambda k, r: (k.__setitem__((20, 0, 1), 0.3),
                   r.__setitem__((20, 0, 1), -0.2),
                   k.__setitem__((slice(21, None), 7, 1), 1.0)),
     {1: (21, "prompt_sign")}),
    # a Doppler 2 Hz off with no decision near it: a kernel fault
    (lambda k, r: k.__setitem__((30, 3, 0), 252.0), {0: (30, None)}),
    # the code phase on a half-chip boundary, both within 5e-3 chip
    (lambda k, r: (k.__setitem__((12, 2, 0), 100.49998),
                   r.__setitem__((12, 2, 0), 100.50002),
                   k.__setitem__((12, 0, 0), 500.0)),
     {0: (12, "half_chip")}),
    # a half-chip cell straddled, then a Doppler 1 Hz off ten epochs later
    (lambda k, r: (k.__setitem__((5, 2, 1), 100.49998),
                   r.__setitem__((5, 2, 1), 100.50002),
                   k.__setitem__((15, 3, 1), 251.0)),
     {1: (15, "half_chip")}),
])
def test_scan_parts(edit, want):
    """deep_cold.scan_parts names each channel's first part and the first
    marginal decision at or before it, or None where there is none."""
    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN

    k, r = _raw(), _raw()
    if edit is not None:
        edit(k, r)
    parts = deep_cold.scan_parts(torch.from_numpy(k), torch.from_numpy(r),
                                 BASEBAND_PLAN)
    assert {c: (p["epoch"], p["marginal"]) for c, p in parts.items()} \
        == want
    assert all(p["doppler_diff_before"] == 0.0 for p in parts.values()
               if p["marginal"])


def test_compare_traces():
    """deep_cold.compare_traces: each channel's first block where two runs
    part, with their entering state there, and the first aided-sync
    window whose engagement differs."""
    from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN

    def trace(shift):
        blocks = []
        for i in range(3):
            raw = _raw(seed=i)
            if shift and i == 2:
                raw[7, 3, 1] += 3.0
            blocks.append({"epoch": 120 + 1000 * i, "raw": raw,
                           "code_phase": np.array([10.0, 20.0]),
                           "doppler": np.array([100.0, 200.0 + shift])})
        windows = [{"phases": np.array([3, 4]), "confs": np.array([5.0, 6.0]),
                    "engaged": None},
                   {"phases": np.array([3, 4]),
                    "confs": np.array([7.0 - shift, 6.0]),
                    "engaged": np.array([not shift, True]), "epoch": 8120}]
        return {"blocks": blocks, "windows": windows}

    out = deep_cold.compare_traces(trace(0), trace(1), [15, 24],
                                   BASEBAND_PLAN)
    assert set(out) == {15, 24} and "part" not in out[15]
    assert out[24]["part"]["block"] == 2120
    assert out[24]["part"]["epoch"] == 7
    assert out[24]["part"]["entering"]["doppler"] == [200.0, 201.0]
    assert out[15]["engagement"] == {"window": 1, "engaged": [True, False],
                                     "confidence": [7.0, 6.0],
                                     "phase": [3, 3]}
    assert "engagement" not in out[24]
    assert out[15]["engaged_at"] == [[8120], []]
    assert out[24]["engaged_at"] == [[8120], [8120]]
