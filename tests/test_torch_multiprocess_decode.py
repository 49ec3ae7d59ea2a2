"""The port's runtime/multiprocess.py against the JAX package's, in one
process on the CPU.

* ``local_digest_block``: the JAX tracker's digest sharded over its 8
  virtual devices and the port's over an 8-position ``cpu`` mesh give the
  same local columns from column 0 (tests/test_torch_mesh.py's digest
  tolerances);
* ``ShardDecoder``: the same numpy digests (blocks of 500 epochs of a
  4-satellite fix scenario with 3 codes a bit, 4 real channels and 4
  ghost copies, tracked by the port on one position and read through the
  port's ``local_digest_block``) fed to both packages' decoders, with the
  code filter on and off, leave equal channel states: bit and subframe
  counts, the framer's history, the boundary ledger, the decoded
  ephemeris, Doppler, code phase, SNR and C/N0;
* ``encode_shard``: equal rows;
* ``allgather_blobs`` / ``gather_and_solve``: the JAX package's
  ``process_allgather`` in one process against the port's all-gather over
  a one-rank gloo group on loopback TCP: equal blobs, the same
  observations after the ghost dedupe, and the same solution.

Every check is exact: both decoders run the same host code on the same
numbers.
"""

import copy
import dataclasses
import json
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.parallel.streaming import (
    StreamingTracker as JStreamingTracker,
)
from stm32f4_sdr_gps_tpu.runtime import multiprocess as jmp
from stm32f4_sdr_gps_tpu.runtime.checkpoint import _encode as j_encode
from stm32f4_sdr_gps_tpu.runtime.digest import BlockDigest as JBlockDigest
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as T_PLAN
from stm32f4_sdr_gps_torch.config import ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
from stm32f4_sdr_gps_torch.parallel.streaming import StreamingTracker
from stm32f4_sdr_gps_torch.runtime import multiprocess as tmp
from stm32f4_sdr_gps_torch.runtime.checkpoint import _encode as t_encode
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario
from stm32f4_sdr_gps_torch.track.state import init_state
from tests.test_pallas_scan import CIB, PLAN, PRNS
from tests.test_torch_mesh import (
    _assert_digests_match,
    _meshes,
    _tracking_setup,
)

torch.set_num_threads(2)

BLOCK = 500
EPOCHS = 4000      # 3 codes a bit: subframes 5, 1, 2, 3 decode by ~3900
S = T_PLAN.samples_per_epoch


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo process group on loopback TCP, torn down after."""
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def digests():
    """Per-block numpy digests of the 4-satellite fix scenario, 4 real
    channels and their 4 ghost copies, with and without the code
    filter's column (the digest carries both; the decoders choose)."""
    sc = fix_scenario(num_epochs=EPOCHS, codes_in_bit=3)
    n = len(sc.prns)
    prns = list(sc.prns) * 2
    phases = np.array([sc.truth.code_phase_at_epoch(i % n, 0)
                       for i in range(2 * n)])
    dops = np.array([sc.truth.sats[i % n].doppler_hz for i in range(2 * n)])
    cfg = TrackConfig(codes_in_bit=3, pll_bad_state_threshold=10**9)
    rcfg = ReceiverConfig(prns=tuple(sc.prns), track=cfg,
                          enable_position=False)
    mesh = make_mesh(1, 1, devices=["cpu"])
    tracker = StreamingTracker(
        init_state(2 * n, phases, dops, window=cfg.pll_check_window,
                   device="cpu"),
        torch.as_tensor(ca_table_bipolar(prns)), mesh, T_PLAN, cfg)
    blocks = []
    for i in range(0, EPOCHS - BLOCK + 1, BLOCK):
        d, col0 = tmp.local_digest_block(tracker.process_digest(
            sc.samples[i * S:(i + BLOCK) * S], rcfg), mesh)
        assert col0 == 0
        blocks.append(d)
    return sc, prns, blocks


def _decoders(digests, code_filter):
    """Both packages' ShardDecoders fed the same digests."""
    sc, prns, blocks = digests
    track = dict(codes_in_bit=3, pll_bad_state_threshold=10**9)
    kw = dict(prns=tuple(sc.prns), enable_position=False,
              enable_code_filter=code_filter)
    jdec = jmp.ShardDecoder(prns, JReceiverConfig(
        track=JTrackConfig(**track), **kw))
    tdec = tmp.ShardDecoder(prns, ReceiverConfig(
        track=TrackConfig(**track), **kw))
    assert JBlockDigest._fields == blocks[0]._fields
    for d in blocks:
        jdec.consume_digest(JBlockDigest(*(np.array(v) for v in d)), BLOCK)
        tdec.consume_digest(d, BLOCK)
    return jdec, tdec


def test_local_digest_block_matches_jax():
    """One process: both packages' local columns are the whole digest,
    from column 0."""
    jm, tm = _meshes()
    x, table, cp0, dop0 = _tracking_setup(45)
    jt = JStreamingTracker(j_init_state(8, cp0, dop0), table, jm, PLAN,
                           JTrackConfig(codes_in_bit=CIB))
    tt = StreamingTracker(init_state(8, cp0, dop0, device="cpu"), table,
                          tm, T_PLAN, TrackConfig(codes_in_bit=CIB))
    want, jcol = jmp.local_digest_block(
        jt.process_digest(x, JReceiverConfig(prns=PRNS)))
    got, tcol = tmp.local_digest_block(
        tt.process_digest(x, ReceiverConfig(prns=PRNS)), tm)
    assert jcol == tcol == 0
    assert all(isinstance(v, np.ndarray) for v in got)
    _assert_digests_match(
        want, type(got)(*(torch.as_tensor(v) for v in got)), 45)


SCALARS = ("prn", "bit_count", "subframe_count", "subframe_time_ms",
           "subframe_tow_s", "boundary_residues", "snr_db", "cn0_dbhz",
           "doppler_hz", "code_phase_chips", "carrier_cycles", "bit_synced",
           "half_cycle", "half_cycle_known", "state_name")


@pytest.mark.parametrize("code_filter", [True, False],
                         ids=["code_filter", "raw_code_phase"])
def test_shard_decoder_matches_jax(digests, code_filter):
    jdec, tdec = _decoders(digests, code_filter)
    assert jdec.epoch_cursor == tdec.epoch_cursor == EPOCHS
    for jc, tc in zip(jdec.channels, tdec.channels, strict=True):
        for f in SCALARS:
            assert getattr(tc, f) == getattr(jc, f), (jc.prn, f)
        assert tc.framer.history == jc.framer.history, jc.prn
        assert t_encode(tc.eph) == j_encode(jc.eph), jc.prn
    # the code phase is the column the config chose
    last = digests[2][-1]
    col = last.code_phase_filtered if code_filter else last.code_phase_chips
    assert [ch.code_phase_chips for ch in tdec.channels] == col.tolist()
    # the scenario decodes: every channel framed its ephemeris
    assert all(ch.subframe_count >= 3 and ch.eph.has_full_set
               for ch in tdec.channels)


@pytest.mark.parametrize("code_filter", [True, False],
                         ids=["code_filter", "raw_code_phase"])
def test_encode_shard_matches_jax(digests, code_filter):
    jdec, tdec = _decoders(digests, code_filter)
    jrows = json.loads(jdec.encode_shard())
    trows = json.loads(tdec.encode_shard())
    assert len(trows) == 8
    assert trows == jrows


def test_allgather_blobs_matches_jax(group):
    for blob in (b"", b"\x00\xffobservables", bytes(range(256)) * 9):
        want = jmp.allgather_blobs(blob)
        got = tmp.allgather_blobs(blob, group=group)
        assert got == want == [blob]
    with pytest.raises(ValueError, match="shard blob 9 > max_len 8"):
        jmp.allgather_blobs(b"123456789", max_len=8)
    with pytest.raises(ValueError, match="shard blob 9 > max_len 8"):
        tmp.allgather_blobs(b"123456789", group=group, max_len=8)


def _as_dict(x):
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray)
                else v) for k, v in dataclasses.asdict(x).items()}


@pytest.mark.parametrize("code_filter", [True, False],
                         ids=["code_filter", "raw_code_phase"])
def test_gather_and_solve_matches_jax(digests, group, code_filter):
    sc, _, _ = digests
    jdec, tdec = _decoders(digests, code_filter)
    meas = EPOCHS - 1
    jobs, jsol = jmp.gather_and_solve(jdec, meas)
    tobs, tsol = tmp.gather_and_solve(tdec, meas, group=group)
    # the 4 ghosts dedupe away: one observation a PRN, in channel order
    assert [o.sat for o in tobs] == [o.sat for o in jobs] == list(sc.prns)
    assert [_as_dict(o) for o in tobs] == [_as_dict(o) for o in jobs]
    assert jsol is not None and tsol is not None and tsol.ok == jsol.ok
    assert _as_dict(tsol) == _as_dict(jsol)
    # solve=False returns the observations alone, in both packages
    obs, sol = tmp.gather_and_solve(copy.deepcopy(tdec), meas, solve=False,
                                    group=group)
    assert sol is None and [_as_dict(o) for o in obs] == \
        [_as_dict(o) for o in jobs]
