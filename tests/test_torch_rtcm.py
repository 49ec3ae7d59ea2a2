"""The port's RTCM3 path against the JAX package's.

* every case of tests/test_rtcm.py and tests/test_rtcm_golden.py, run
  with the port's ``io.rtcm3`` in place of the JAX package's (its
  encoders, decoders, framing and MsmObs);
* ``enable_rtcm`` through the Receiver in both packages on
  tests/test_runtime.py's RTCM capture (4400 epochs: the shortest of that
  file's captures on which ephemerides complete): the same frames in
  the same order, the 1019 frames byte-identical, the MSM5 fields equal
  within one resolution step of their data field (pseudorange DF400,
  phaserange DF401; integers exact), the range rate within 0.01 Hz of
  carrier Doppler (the float32 agreement of the two tracking loops,
  ~19 steps of DF404).
"""

import inspect

import numpy as np
import pytest
import torch

import tests.test_rtcm as j_rtcm_cases
import tests.test_rtcm_golden as j_golden_cases
from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_torch.config import CLIGHT, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.io import rtcm3
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from tests.test_receiver import CIB, PRNS, _make_capture

torch.set_num_threads(2)

_PORTED = ("MsmObs", "crc24q", "decode_1019", "decode_msm", "deframe",
           "encode_1019", "encode_msm", "frame")


def _cases():
    """(module, test name, kwargs) for every case of the two files; the
    receiver-status smoke test is the JAX Receiver's, not RTCM's."""
    out = []
    for mod in (j_rtcm_cases, j_golden_cases):
        for name, fn in sorted(vars(mod).items()):
            if not name.startswith("test_") or name == "test_status_render_smoke":
                continue
            marks = getattr(fn, "pytestmark", [])
            params = [m for m in marks if m.name == "parametrize"]
            if params:
                argname, values = params[0].args[:2]
                out += [(mod, name, {argname: v}) for v in values]
            else:
                out.append((mod, name, {}))
    return out


CASES = _cases()


@pytest.mark.parametrize(
    "mod,name,kw", CASES,
    ids=[f"{m.__name__.split('.')[-1]}::{n}{''.join(map(str, k.values()))}"
         for m, n, k in CASES])
def test_rtcm_case_on_the_port(mod, name, kw, monkeypatch):
    fn = getattr(mod, name)
    assert not set(inspect.signature(fn).parameters) - set(kw)
    for attr in _PORTED:
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, getattr(rtcm3, attr))
    fn(**kw)


def test_every_case_runs_the_port():
    assert len(CASES) >= 9
    for mod in (j_rtcm_cases, j_golden_cases):
        assert any(hasattr(mod, a) for a in _PORTED)


def _run(pkg, x):
    kw = dict(prns=PRNS, enable_position=False, track_block_epochs=200,
              enable_rtcm=True)
    trk = dict(codes_in_bit=CIB, pll_bad_state_threshold=10**9)
    if pkg == "jax":
        rx = JReceiver(JReceiverConfig(track=JTrackConfig(**trk), **kw))
    else:
        rx = Receiver(ReceiverConfig(track=TrackConfig(**trk), **kw),
                      device="cpu")
    rx.run(x)
    return rx


def test_receiver_rtcm_matches_jax():
    x, _ = _make_capture(4400, seed=13)
    jrx, rx = _run("jax", x), _run("torch", x)
    assert len(rx.rtcm_frames) == len(jrx.rtcm_frames)
    kinds = []
    pr_lsb = CLIGHT * 1e-3 * 2.0 ** -24       # DF400, m
    ph_lsb = CLIGHT * 1e-3 * 2.0 ** -29       # DF401, m
    rr_tol = 0.01 * CLIGHT / 1.57542e9        # 0.01 Hz of Doppler, m/s
    for fa, fb in zip(jrx.rtcm_frames, rx.rtcm_frames):
        pa, pb = rtcm3.deframe(fa), rtcm3.deframe(fb)
        assert pa is not None and pb is not None
        kind = (pb[0] << 4) | (pb[1] >> 4)
        assert kind == (pa[0] << 4) | (pa[1] >> 4)
        kinds.append(kind)
        if kind == 1019:
            assert fb == fa
            assert rtcm3.decode_1019(pb)["sat"] in PRNS
            continue
        da, db = rtcm3.decode_msm(pa), rtcm3.decode_msm(pb)
        assert db["tow_ms"] == da["tow_ms"]
        assert len(db["obs"]) == len(da["obs"])
        for oa, ob in zip(da["obs"], db["obs"]):
            for k in ("sat", "cn0_dbhz", "lock", "half_cycle_ambiguous"):
                assert ob[k] == oa[k], k
            assert abs(ob["pseudorange_m"] - oa["pseudorange_m"]) <= pr_lsb
            assert abs(ob["phaserange_m"] - oa["phaserange_m"]) <= ph_lsb
            assert abs(ob["range_rate_ms"] - oa["range_rate_ms"]) <= rr_tol
    assert kinds.count(1019) == len(PRNS) and 1075 in kinds
    for ch, jch in zip(rx.channels, jrx.channels):
        assert (ch.lock_start_ms, ch.half_cycle) == \
            (jch.lock_start_ms, jch.half_cycle)
        assert ch.rtcm_phase_align_m == pytest.approx(
            jch.rtcm_phase_align_m, abs=ph_lsb)
    assert np.isfinite([ch.rtcm_phase_align_m for ch in rx.channels]).all()
