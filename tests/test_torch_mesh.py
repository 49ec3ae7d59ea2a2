"""The port's mesh functions and StreamingTracker against the JAX
package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py), its
Pallas kernel K1 in interpret mode; the port on an 8-position mesh whose
positions all name ``cpu``.  Inputs are seeded numpy arrays given to
both packages.

* the acquisition cube, FFT and matmul DFT, ``gather_output`` both ways:
  rtol 2e-4, atol 1e-2 (tests/test_parallel.py, tests/multihost_worker.py);
* the halo: exact;
* ``acquire_sharded`` with and without hints: the same detections, lag
  and Doppler bin;
* ``StreamingTracker.process`` on the reference scan: the tolerances of
  tests/test_pallas_scan.py:68-117, integer decisions exact;
* K1's plain version once a position: equal to the unsharded plain run
  bit for bit, and held to the JAX in-kernel tracker;
* ``process_digest``: integer leaves exact, float leaves to the same
  tolerances (a sum over T epochs T times the per-epoch one, a moment of
  the prompt power twice the prompt's rtol);
* the divisibility and ``make_mesh`` errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import AcqConfig as JAcqConfig
from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.ops.correlate import code_fft_conj as j_cfc
from stm32f4_sdr_gps_tpu.ops.correlate import dft_tables as j_dft_tables
from stm32f4_sdr_gps_tpu.ops.wipeoff import doppler_rotations as j_rot
from stm32f4_sdr_gps_tpu.parallel import mesh as jmesh
from stm32f4_sdr_gps_tpu.parallel.streaming import (
    StreamingTracker as JStreamingTracker,
)
from stm32f4_sdr_gps_tpu.parallel.streaming import (
    acquire_sharded as j_acquire_sharded,
)
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as T_PLAN
from stm32f4_sdr_gps_torch.config import TrackConfig
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.ops.correlate import code_fft_conj, dft_tables
from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
from stm32f4_sdr_gps_torch.ops.wipeoff import doppler_rotations
from stm32f4_sdr_gps_torch.parallel.mesh import (
    halo_extend_blocks,
    make_mesh,
    shard_track_state,
    sharded_acquisition_power,
)
from stm32f4_sdr_gps_torch.parallel.streaming import (
    StreamingTracker,
    acquire_sharded,
)
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.track.scan import track_block
from stm32f4_sdr_gps_torch.track.state import init_state
from tests.test_32ch import PRESENT
from tests.test_pallas_scan import (
    CIB,
    PLAN,
    PRNS,
    _assert_outputs_match,
    _assert_states_match,
    _scenario,
)

torch.set_num_threads(2)

S = PLAN.samples_per_epoch
CPU8 = ["cpu"] * 8


def _meshes(time=2, chan=4):
    if len(jax.devices()) < time * chan:
        pytest.skip(f"needs {time * chan} virtual devices")
    return (jmesh.make_mesh(time=time, chan=chan),
            make_mesh(time=time, chan=chan, devices=["cpu"] * (time * chan)))


@pytest.fixture(scope="module")
def capture32():
    """tests/test_32ch.py's capture: 8 of 32 PRNs present, 60 epochs."""
    sats = [SimSat(prn=p, doppler_hz=d, code_phase_chips=c, cn0_dbhz=44.0)
            for p, (d, c) in PRESENT.items()]
    x, _ = simulate_capture(sats, num_epochs=60, seed=9)
    return x


@pytest.mark.parametrize("gather", [False, True], ids=["chan", "gathered"])
@pytest.mark.parametrize("dft", [False, True], ids=["fft", "matmul_dft"])
def test_cube_matches_jax(gather, dft):
    jm, tm = _meshes()
    sat = SimSat(prn=3, doppler_hz=1500.0, code_phase_chips=222.0,
                 cn0_dbhz=46.0)
    x, _ = simulate_capture([sat], num_epochs=4, seed=1)
    epochs = x.reshape(4, S).astype(np.complex64)
    prns = list(range(1, 9))
    bins = np.arange(-2000.0, 2001.0, 500.0, dtype=np.float32)
    j_tables = t_tables = None
    if dft:
        wc, ws = dft_tables(S)
        j_tables = tuple(jnp.asarray(w) for w in j_dft_tables(S))
        t_tables = (torch.as_tensor(wc), torch.as_tensor(ws))
    with jax.sharding.set_mesh(jm):
        want = jmesh.sharded_acquisition_power(
            jnp.asarray(epochs), j_cfc(prns, PLAN),
            j_rot(jnp.asarray(bins), S, PLAN.sample_rate_hz), jm,
            gather_output=gather, dft=j_tables)
    got = sharded_acquisition_power(
        torch.as_tensor(epochs), code_fft_conj(prns, T_PLAN, device="cpu"),
        doppler_rotations(torch.as_tensor(bins), S, T_PLAN.sample_rate_hz),
        tm, gather_output=gather, dft=t_tables)
    assert got.shape == (8, len(bins), S) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=1e-2)


def test_halo_matches_jax():
    jm, tm = _meshes()
    blocks = np.random.default_rng(3).standard_normal((6, 10)) \
        .astype(np.float32)
    with jax.sharding.set_mesh(jm):
        want = jmesh.halo_extend_blocks(jnp.asarray(blocks), 3, jm)
    got = halo_extend_blocks(torch.as_tensor(blocks), 3, tm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # over the chan axis too (4 shards)
    blocks = blocks[:4]
    with jax.sharding.set_mesh(jm):
        want = jmesh.halo_extend_blocks(jnp.asarray(blocks), 2, jm, "chan")
    got = halo_extend_blocks(torch.as_tensor(blocks), 2, tm, "chan")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _acq_key(r, cfg):
    """(detected, integer lag, Doppler bin) of an AcqResult."""
    cps = PLAN.chips_per_sample
    lag = int(round((S - r.code_phase_chips / cps) % S)) % S
    dbin = int(round((r.doppler_hz - cfg.doppler_bins_hz[0])
                     / cfg.doppler_step_hz))
    return r.detected, lag, dbin


@pytest.mark.parametrize("hints", [None, {2: -3800.0, 21: 0.0}],
                         ids=["cold", "hinted"])
def test_acquire_sharded_matches_jax(capture32, hints):
    jm, tm = _meshes()
    x = capture32
    want = j_acquire_sharded(x, range(1, 33), jm, PLAN, JAcqConfig(),
                             doppler_hints_hz=hints)
    got = acquire_sharded(x, range(1, 33), tm, T_PLAN, AcqConfig(),
                          doppler_hints_hz=hints)
    cfg = AcqConfig()
    assert [r.prn for r in got] == [r.prn for r in want]
    for g, w in zip(got, want):
        assert _acq_key(g, cfg) == _acq_key(w, cfg), (g, w)
        if w.detected:
            assert abs(g.doppler_hz - w.doppler_hz) < 1.0, (g, w)
            assert abs(g.code_phase_chips - w.code_phase_chips) < 0.01
    detected = {r.prn for r in got if r.detected}
    if hints is None:
        assert detected == set(PRESENT)
    else:  # PRN 21's hint is 3.3 kHz off: its confined search misses it
        assert detected == set(PRESENT) - {21}


def _tracking_setup(num_epochs):
    x, sats = _scenario(num_epochs)
    cp0 = np.array([s.code_phase_chips + 0.1 for s in sats])
    dop0 = np.array([s.doppler_hz + 15.0 for s in sats])
    return x, ca_table_bipolar(PRNS), cp0, dop0


def _stack(outs):
    """Per-block TrackOutputs (JAX or torch) as one numpy TrackOutputs."""
    return type(outs[0])(*(np.concatenate([np.asarray(a) for a in f])
                           for f in zip(*outs)))


def test_streaming_tracker_matches_jax():
    """8 channels on the 2x4 mesh, two blocks: the reference scan once a
    position against the JAX tracker's GSPMD-partitioned scan."""
    jm, tm = _meshes()
    x, table, cp0, dop0 = _tracking_setup(90)
    jt = JStreamingTracker(j_init_state(8, cp0, dop0), table, jm, PLAN,
                           JTrackConfig(codes_in_bit=CIB))
    tt = StreamingTracker(init_state(8, cp0, dop0, device="cpu"), table,
                          tm, T_PLAN, TrackConfig(codes_in_bit=CIB))
    blocks = (x[: 45 * S], x[45 * S:])
    want = [jt.process(b) for b in blocks]
    got = [tt.process(b) for b in blocks]
    assert got[0].ip.shape == (45, 8)
    _assert_outputs_match(_stack(want), _stack(got))
    _assert_states_match(jt.state, tt.gather_state("cpu"))


def test_kernel_plain_version_per_shard():
    """K1's plain version once a position, two blocks of 8 ch x 20
    epochs: bit for bit the unsharded plain run (channels are
    independent), and held to the JAX in-kernel tracker (Pallas
    interpret mode)."""
    jm, tm = _meshes()
    x, table, cp0, dop0 = _tracking_setup(40)
    u2 = upsampled_code_doubled(table)
    cfg = TrackConfig(codes_in_bit=CIB, in_kernel_scan=True)
    tt = StreamingTracker(init_state(8, cp0, dop0, device="cpu"), u2, tm,
                          T_PLAN, cfg)
    st_one = init_state(8, cp0, dop0, device="cpu")
    jt = JStreamingTracker(
        j_init_state(8, cp0, dop0), u2, jm, PLAN,
        JTrackConfig(codes_in_bit=CIB, in_kernel_scan=True,
                     pallas_interpret=True))
    got, want = [], []
    for blk in (x[: 20 * S], x[20 * S:]):
        calls = ts.track_scan_reference.calls
        got.append(tt.process(blk))
        assert ts.track_scan_reference.calls - calls == 8
        st_one, one = track_block(st_one, torch.as_tensor(blk.reshape(20, S)),
                                  torch.as_tensor(u2), T_PLAN, cfg)
        for f, g, w in zip(one._fields, got[-1], one):
            assert torch.equal(g, w), f
        for f, g, w in zip(st_one._fields, tt.gather_state("cpu"), st_one):
            assert torch.equal(g, w), f
        want.append(jt.process(blk))
    _assert_outputs_match(_stack(want), _stack(got))
    _assert_states_match(jt.state, tt.gather_state("cpu"))


def _assert_digests_match(want, got, t_cnt):
    out_atol = {"code_phase_chips": 5e-3, "code_phase_filtered": 5e-3,
                "code_phase_first": 5e-3, "doppler_hz": 0.5,
                "snr_db": 0.1, "doppler_sum": 0.5 * t_cnt}
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.shape == w.shape, f
        if f in out_atol:
            np.testing.assert_allclose(g, w, atol=out_atol[f], err_msg=f)
        elif f in ("cn0_m2", "cn0_m4"):
            rtol = 4e-2 if f == "cn0_m2" else 8e-2
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64), err_msg=f)


@pytest.mark.parametrize("code_filter", [True, False])
def test_process_digest_matches_jax(code_filter):
    jm, tm = _meshes()
    x, table, cp0, dop0 = _tracking_setup(90)
    jt = JStreamingTracker(j_init_state(8, cp0, dop0), table, jm, PLAN,
                           JTrackConfig(codes_in_bit=CIB))
    tt = StreamingTracker(init_state(8, cp0, dop0, device="cpu"), table,
                          tm, T_PLAN, TrackConfig(codes_in_bit=CIB))
    j_rcfg = JReceiverConfig(prns=PRNS, enable_code_filter=code_filter)
    rcfg = ReceiverConfig(prns=PRNS, enable_code_filter=code_filter)
    for blk in (x[: 45 * S], x[45 * S:]):
        want = jt.process_digest(blk, j_rcfg)
        got = tt.process_digest(blk, rcfg)
        _assert_digests_match(want, got, 45)
    assert int(got.bit_count.sum()) > 0


def test_shards_own_their_storage():
    """Each position's state and code rows are copies: writing one
    shard's planes leaves its neighbours' rows and the source alone."""
    _, tm = _meshes()
    st = init_state(8, np.arange(8.0), np.zeros(8), device="cpu")
    shards = shard_track_state(st, tm)
    assert len(shards) == 8 and shards[0].doppler_hz.shape == (1,)
    shards[0].doppler_hz.fill_(7.0)
    assert float(shards[1].doppler_hz[0]) == 0.0
    assert float(st.doppler_hz[0]) == 0.0
    ptrs = {s.code_phase_chips.data_ptr() for s in shards}
    assert len(ptrs) == 8


def test_tracker_rejects_indivisible_channels():
    _, tm = _meshes()
    with pytest.raises(ValueError, match="3 channels do not divide"):
        StreamingTracker(init_state(3, np.zeros(3), np.zeros(3),
                                    device="cpu"),
                         ca_table_bipolar([1, 2, 3]), tm, T_PLAN,
                         TrackConfig())


def test_make_mesh_errors():
    with pytest.raises(ValueError, match=r"mesh 2x3 != 8 devices"):
        make_mesh(time=2, chan=3, devices=CPU8)
    m = make_mesh(time=2, devices=CPU8)
    assert m.shape == {"time": 2, "chan": 4} and m.size == 8
    assert list(m.positions) == list(range(8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"make_mesh.*CUDA"):
            make_mesh(devices=["cuda"] * 2)
