"""The port's Receiver held to the firmware oracle under stress: the
points of tests/test_parity_stress.py, on the CPU reference scan, with
that suite's own bars (the oracle synced on at least the point's count
of channels; every port channel synced with > 100 bits; for each
oracle-synced channel the nav bits piecewise equal, tests/parity_util.py,
and the code-delay trajectory within bias 0.32, jitter 0.12 and drift
0.1 chip).  ``cn0_45`` runs in tier-1; the other points run behind
RUN_SLOW, exactly as in the JAX file.  The bars are applied by the JAX
suite's own functions and, at the tier-1 point, also by the port's copy
in probes/firmware_parity.py (what chip_smoke.py applies on the card)."""

import os

import pytest
import torch

import tests.test_parity_stress as jax_suite
from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig, \
    TrackConfig
from stm32f4_sdr_gps_torch.probes import firmware_parity as fp
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband

torch.set_num_threads(2)

CHANNELS = jax_suite.CHANNELS
# the JAX file's per-point Receiver depth, in the port's config types
TPU_PRESETS = {
    "cn0_42": (dict(acq=AcqConfig(noncoherent_epochs=60)),
               dict(coherent_bit_vote=True)),
    "cn0_38": (dict(acq=AcqConfig(noncoherent_epochs=60)),
               dict(coherent_bit_vote=True)),
}


def _gen_capture(tmp_path, cn0, duration_ms, extra):
    flags = dict(cib=20, duration_ms=duration_ms, cn0=cn0, seed=11)
    for k, v in zip(extra[::2], extra[1::2]):
        flags[k.lstrip("-")] = v
    words, _ = native.capture_gen(str(tmp_path), "cap", **flags)
    return words


def _run_port(words, cold, acq_kwargs, track_kwargs):
    cfg = ReceiverConfig(
        prns=tuple(p for p, _ in CHANNELS),
        doppler_hints_hz=None if cold else tuple(
            float(h) for _, h in CHANNELS),
        track=TrackConfig(pll_bad_state_threshold=10**9,
                          in_kernel_scan=False, **track_kwargs),
        enable_position=False,
        enable_code_filter=False,
        track_block_epochs=100,
        **acq_kwargs,
    )
    _, report, bits, traj, _ = fp.run_receiver(
        reference_to_baseband(native.unpack_bits16(words)), cfg,
        device="cpu")
    return report, bits, traj


@pytest.mark.parametrize(
    "point_id,cn0,duration_ms,extra,min_fw_synced,slow",
    jax_suite.POINTS, ids=[p[0] for p in jax_suite.POINTS])
def test_parity_under_stress(tmp_path, point_id, cn0, duration_ms, extra,
                             min_fw_synced, slow):
    if slow and os.environ.get("RUN_SLOW") != "1":
        pytest.skip("set RUN_SLOW=1 to run")
    assert native.get_lib() is not None, "native library unavailable"
    words = _gen_capture(tmp_path, cn0, duration_ms, extra)
    cold = point_id in jax_suite.COLD_POINTS
    if cold:
        m = native.firmware_master_run(words, [p for p, _ in CHANNELS])
        fw = {c["prn"]: dict(c, tracking=c["track_start_ms"] > 0)
              for c in m["channels"]}
    else:
        fw = {prn: native.firmware_receiver_run(words, prn, hint)
              for prn, hint in CHANNELS}
    acq_kwargs, track_kwargs = TPU_PRESETS.get(point_id, ({}, {}))
    report, bits, traj = _run_port(words, cold, acq_kwargs, track_kwargs)
    synced = {c.prn: c.bit_synced and c.bit_count > 100
              for c in report.channels}

    fw_synced = [prn for prn, r in fw.items()
                 if r["tracking"] and r["sync_ms"] > 0
                 and len(r["bits"]) > 150]
    assert len(fw_synced) >= min_fw_synced, (point_id, fw_synced)
    assert all(synced.values()), (point_id, synced)
    for prn in fw_synced:
        jax_suite._assert_bits_match(point_id, prn, fw[prn], bits)
        jax_suite._assert_trajectory(point_id, prn, fw[prn], traj)
    if point_id == "cn0_45":
        # the same point through the bars chip_smoke.py applies
        assert (fp.SUITES["stress_cn0_45"]["capture"]
                == dict(cib=20, duration_ms=duration_ms, cn0=cn0, seed=11))
        rec = fp.check_stress(fw, bits, traj, report.channels,
                              min_fw_synced)
        assert sorted(rec) == sorted(fw_synced)
