"""The port's on-device block digest against the JAX package's: the same
TrackOutputs (one JAX tracking block) through both ``digest_block``s.
Integer leaves must match exactly, float leaves to rtol 1e-5 (float32
reductions over the block run in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.runtime.digest import digest_block as j_digest
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch import convert
from stm32f4_sdr_gps_torch.config import TrackConfig
from stm32f4_sdr_gps_torch.runtime.digest import (cn0_from_moments,
                                                  digest_block,
                                                  digest_to_host)
from stm32f4_sdr_gps_torch.track.state import TrackOutputs
from tests.test_pallas_scan import CIB, PLAN, PRNS, _scenario

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def block():
    e = 120
    x, sats = _scenario(e, seed=19)
    st0 = j_init_state(len(PRNS),
                       np.array([s.code_phase_chips + 0.1 for s in sats]),
                       np.array([s.doppler_hz + 15.0 for s in sats]),
                       start_epoch=37)
    cfg = JTrackConfig(codes_in_bit=CIB)
    st, outs = j_track_block(st0, jnp.asarray(x.reshape(e, -1)),
                             jnp.asarray(ca_table_bipolar(PRNS)), PLAN, cfg)
    return st, outs


@pytest.mark.parametrize("code_filter", [True, False])
def test_digest_matches_jax(block, code_filter):
    st, outs = block
    want = j_digest(outs, st, JTrackConfig(codes_in_bit=CIB), 50,
                    code_filter)
    t_outs = TrackOutputs(*(torch.as_tensor(np.array(v)) for v in outs))
    t_st = convert.track_state_from_numpy([np.asarray(v) for v in st])
    got = digest_to_host(digest_block(t_outs, t_st,
                                      TrackConfig(codes_in_bit=CIB), 50,
                                      code_filter))
    assert int(np.asarray(want.bit_count).sum()) > 0
    assert got._fields == want._fields
    for f, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, f
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    for c in range(len(PRNS)):
        assert cn0_from_moments(got.cn0_m2[c], got.cn0_m4[c],
                                got.cn0_n[c]) == pytest.approx(
            cn0_from_moments(float(want.cn0_m2[c]), float(want.cn0_m4[c]),
                             int(want.cn0_n[c])), abs=0.01)
