"""The port's MeshReceiver and dryrun_multichip against the JAX package's,
on the CPU.

``dryrun_multichip(8, device="cpu")`` runs the whole sharded step on 8
positions of ``cpu`` and its MeshReceiver to a fix on a compressed-bit
fix_scenario (2800 epochs, 3 codes a bit, injected ephemerides) held to
the single-process Receiver (equal subframe ledgers, fixes within
100 m).  Its MeshReceiver's channels are held to the JAX MeshReceiver's
on the same capture on the JAX package's 2x4 virtual-device mesh: the
same PRNs, bit counts, framer histories and subframe ledgers, Doppler
within 0.05 Hz and code phase within 0.05 chip (the tolerances of
tests/test_torch_receiver.py).  Channel-set changes and the aided bit
sync on the mesh: tests/test_torch_mesh_channels.py.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.entry import dryrun_multichip

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(8, device="cpu")


@pytest.fixture(scope="module")
def jax_report():
    """The JAX MeshReceiver on dryrun_multichip's capture and config."""
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig, TrackConfig
    from stm32f4_sdr_gps_tpu.parallel.mesh import make_mesh
    from stm32f4_sdr_gps_tpu.runtime.mesh_receiver import MeshReceiver
    from stm32f4_sdr_gps_tpu.signal.scenarios import fix_scenario

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    sc = fix_scenario(num_epochs=2800, codes_in_bit=3)
    cfg = ReceiverConfig(
        prns=sc.prns,
        track=TrackConfig(codes_in_bit=3, pll_bad_state_threshold=10**9),
        track_block_epochs=200,
        max_resid_rms_m=0.0, min_altitude_m=0.0, max_altitude_m=0.0,
        grid_fault_search=False,
    )
    rx = MeshReceiver(cfg, make_mesh(time=2, chan=4))
    for ch in rx.channels:
        ch.eph = copy.deepcopy(sc.eph_map[ch.prn])
    return rx.run(sc.samples)


def test_dryrun_multichip_on_cpu(dryrun):
    assert dryrun["positions"] == 8
    assert dryrun["acq_rel_err"] < 2e-4
    assert dryrun["fix_agreement_m"] < 100.0
    assert dryrun["solutions"] >= 1 and dryrun["epochs"] == 2800
    mesh, one = dryrun["mesh_report"], dryrun["single_report"]
    assert [c.subframe_time_ms for c in mesh.channels] == \
        [c.subframe_time_ms for c in one.channels]
    assert all(c.subframe_count >= 1 for c in mesh.channels)


def test_mesh_receiver_matches_jax(dryrun, jax_report):
    got = dryrun["mesh_report"]
    assert [c.prn for c in got.channels] == \
        [c.prn for c in jax_report.channels]
    for ch, jch in zip(got.channels, jax_report.channels):
        assert ch.state_name == jch.state_name == "TRACKING"
        assert ch.bit_count == jch.bit_count, ch.prn
        assert ch.framer.history == jch.framer.history, ch.prn
        assert ch.subframe_time_ms == jch.subframe_time_ms, ch.prn
        assert abs(ch.doppler_hz - jch.doppler_hz) < 0.05, ch.prn
        assert abs(ch.code_phase_chips - jch.code_phase_chips) < 0.05, ch.prn
    assert len(got.solutions) == len(jax_report.solutions)
    d = np.linalg.norm(got.solutions[-1].rr - jax_report.solutions[-1].rr)
    assert d < 100.0, d
