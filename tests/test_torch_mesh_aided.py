"""The aided bit sync on the port's MeshReceiver, on the CPU, on a
2-position mesh (tests/test_32ch.py:112-142): COHERENT_TRACK turns off
the run-time counters, so sync comes only from the histogram search
(Receiver._aided_sync_step) acting on the tracking state the
MeshReceiver gathers from its shards where the step acts and shards back.
With the default config no block gathers the state: it is gathered when
read, as a checkpoint reads it.
"""

import numpy as np
import torch

from stm32f4_sdr_gps_torch.config import (COHERENT_TRACK, ReceiverConfig,
                                          TrackConfig)
from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
from stm32f4_sdr_gps_torch.runtime.checkpoint import (load_receiver,
                                                      save_receiver)
from stm32f4_sdr_gps_torch.runtime.mesh_receiver import MeshReceiver
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture

torch.set_num_threads(2)


def test_mesh_aided_sync_engages():
    rng = np.random.default_rng(2)
    prns = (5, 29)
    sats = [SimSat(prn=p, doppler_hz=float(d), code_phase_chips=float(cp),
                   cn0_dbhz=45.0, codes_in_bit=20,
                   nav_bits=list(rng.integers(0, 2, 40)))
            for p, d, cp in zip(prns, (900.0, -1400.0), (100.0, 700.0))]
    x, _ = simulate_capture(sats, num_epochs=4800, seed=2)
    cfg = ReceiverConfig(prns=prns, track=COHERENT_TRACK,
                         enable_position=False, track_block_epochs=100)
    rx = MeshReceiver(cfg, make_mesh(time=1, chan=2, devices=["cpu"] * 2))
    report = rx.run(x)
    for ch in report.channels:
        assert ch.bit_synced, ch.prn
        assert ch.bit_count > 5, ch.prn
        assert rx.aided_engagements.get(ch.prn, 0) >= 1, ch.prn
    # the engaged state went back to the shards
    st = rx.tracker.gather_state("cpu")
    assert bool(st.period_sync_ok.all())
    # gathered only in the blocks where the step acted
    assert 0 < rx.profiler.stages["gather"].calls \
        < rx.profiler.stages["track"].calls


def test_state_gathered_when_read(tmp_path):
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=cp, cn0_dbhz=48.0,
                   codes_in_bit=3)
            for p, d, cp in ((5, 900.0, 100.0), (29, -1400.0, 700.0))]
    x, _ = simulate_capture(sats, num_epochs=1200, seed=3)
    cfg = ReceiverConfig(prns=(5, 29), track=TrackConfig(codes_in_bit=3),
                         enable_position=False, track_block_epochs=300)
    rx = MeshReceiver(cfg, make_mesh(time=1, chan=2, devices=["cpu"] * 2))
    rx.run(x)
    assert rx.profiler.stages["track"].calls > 1
    assert "gather" not in rx.profiler.stages
    want = rx.tracker.gather_state("cpu")
    for f, g, w in zip(want._fields, rx.track_state, want):
        assert torch.equal(g, w), f
    assert rx.profiler.stages["gather"].calls == 1
    # the checkpoint holds the tracker's last state
    back = load_receiver(save_receiver(str(tmp_path / "ck"), rx),
                         device="cpu")
    for f, g, w in zip(want._fields, back.track_state, want):
        assert torch.equal(g, w), f
    assert rx.profiler.stages["gather"].calls == 1
