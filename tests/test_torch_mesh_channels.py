"""The port's MeshReceiver when the channel set or the tracking state
changes between blocks, against the JAX package's MeshReceiver, on the
CPU.

* Late rise and drop (tests/test_32ch.py:183-245, with the captures of
  tests/test_torch_reacquire.py): the channel set after every block
  equal to the JAX MeshReceiver's on a mesh of the same shape, so the
  same join and drop epochs, on a 1x2 mesh: in the rise one live
  channel and a ghost, then two live; in the drop, at a 35 dBHz C/N0
  floor, two live, then one and a ghost, then two.  The tracker stays
  padded to a mesh multiple.  The
  bit counts and Doppler are held to the JAX MeshReceiver on a 1x1
  mesh: on the CPU, XLA compiles the JAX mesh's scan for its shard shape
  and rounds otherwise with one channel a device than with two, and in
  the drop run, where PRN 18 tracks noise through its gap, its 1x2 mesh
  ends 3 bits and 0.16 Hz (PRN 5) away from its 1x1 mesh and its
  Receiver; the port's scan is one torch program whatever the shard.

The aided bit sync on the mesh: tests/test_torch_mesh_aided.py.
"""

import jax
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.parallel.mesh import make_mesh as j_make_mesh
from stm32f4_sdr_gps_tpu.runtime.mesh_receiver import (
    MeshReceiver as JMeshReceiver,
)
from stm32f4_sdr_gps_torch.config import ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
from stm32f4_sdr_gps_torch.runtime.mesh_receiver import MeshReceiver
from tests.test_torch_reacquire import (CIB, _late_rise_capture,
                                        _setting_capture,
                                        assert_rows_follow_channels)

torch.set_num_threads(2)

MESH = (1, 2)


def _run(pkg, x, shape, **cfg):
    """MeshReceiver.run with the late-rise config on a ``shape`` mesh;
    returns the receiver, its report and the live PRNs after every
    block (and for the port, checks its padded code rows after every
    block)."""
    kw = dict(prns=(5, 18), enable_position=False, track_block_epochs=250,
              reacquire_period_ms=500, device_digest=True, **cfg)
    trk = dict(codes_in_bit=CIB, pll_bad_state_threshold=10**9)
    n = shape[0] * shape[1]
    if pkg == "jax":
        if len(jax.devices()) < n:
            pytest.skip(f"needs {n} virtual devices")
        rx = JMeshReceiver(JReceiverConfig(track=JTrackConfig(**trk), **kw),
                           j_make_mesh(*shape, devices=jax.devices()[:n]))
    else:
        rx = MeshReceiver(ReceiverConfig(track=TrackConfig(**trk), **kw),
                          make_mesh(*shape, devices=["cpu"] * n))
    live = []

    def status(r):
        live.append((r.epoch_cursor, tuple(ch.prn for ch in r.channels)))
        if pkg != "jax":
            assert_rows_follow_channels(r)

    report = rx.run(x, status_callback=status)
    return rx, report, live


@pytest.mark.parametrize("case", ["late_rise", "setting_floor35"])
def test_mesh_channel_set_matches_jax(case):
    x, truth_b = (_late_rise_capture() if case == "late_rise"
                  else _setting_capture())
    cfg = dict(cn0_floor_dbhz=35.0) if case == "setting_floor35" else {}
    _, _, j_live = _run("jax", x, MESH, **cfg)
    jrx, _, j_live1 = _run("jax", x, (1, 1), **cfg)
    rx, report, live = _run("torch", x, MESH, **cfg)
    assert live == j_live == j_live1
    by = {ch.prn: ch for ch in report.channels}
    assert 5 in by and by[5].state_name == "TRACKING"
    assert 18 in by, "PRN 18 never (re)joined on the mesh"
    assert by[18].state_name == "TRACKING"
    assert abs(by[18].doppler_hz + 2400.0) < 15.0
    if case == "late_rise":
        assert live[0][1] == (5,)
        cp_true = truth_b.code_phase_at_epoch(0, report.epochs_processed - 1)
        err = (by[18].code_phase_chips - cp_true + 511.5) % 1023 - 511.5
        assert abs(err) < 0.5
        assert not rx.standby_channels
    else:
        gone = [t for t, prns in live if prns == (5,)]
        assert gone and 2500 <= gone[0] and gone[-1] < 3500, live
    # the tracker stays padded to a mesh multiple, its rows sharded
    n_pos = MESH[0] * MESH[1]
    shards = rx.tracker.shards
    assert len(shards) == n_pos and rx._n_live == 2
    assert sum(s.doppler_hz.shape[0] for s in shards) % n_pos == 0
    assert rx.code_table.shape[0] == rx.track_state.doppler_hz.shape[0]
    jby = {c.prn: c for c in jrx.channels}
    for ch in report.channels:
        assert ch.bit_count == jby[ch.prn].bit_count, ch.prn
        assert abs(ch.doppler_hz - jby[ch.prn].doppler_hz) < 0.05, ch.prn
