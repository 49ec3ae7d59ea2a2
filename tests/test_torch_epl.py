"""The per-epoch half-chip E/P/L correlator (the JAX package's kernel K2)
in the port, on the CPU.

* the plain torch version against the JAX Pallas kernel in interpret
  mode, on random phases and on the code-phase wrap edges of
  tests/test_pallas.py:57;
* the g++ host build of the CUDA kernel's arithmetic (csrc/epl.cu via
  csrc/kernels_host.cpp) against the plain version, and the per-epoch
  tracking loop driven through it;
* the dispatcher: CPU tensors run the plain version, the CUDA wrapper
  refuses CPU tensors, and the use_pallas branch of track_epoch_step
  goes through the dispatcher.

Tolerance on the sums, rtol 1e-4 and atol 1e-3: the float32 sums over the
2046 samples run in other orders on the two sides (about 2046 * 6e-8 of
a unit-variance term, 1e-4), and the carrier is cos/sin(2 pi a) on one
side and sincospif(2 a) on the other (a few ulp of a unit rotation); a
sum can sit near zero, where only the absolute bound means anything.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.ops.pallas_epl import epl_correlate_pallas
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
from stm32f4_sdr_gps_torch.ops import epl
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.track.scan import track_block
from stm32f4_sdr_gps_torch.track.state import init_state
from tests.test_pallas_scan import CIB, PRNS, _scenario

torch.set_num_threads(2)

S = BASEBAND_PLAN.samples_per_epoch
FS = BASEBAND_PLAN.sample_rate_hz
RTOL, ATOL = 1e-4, 1e-3
WRAP_EDGES = (0.0, 0.2, 0.49, 0.51, 1022.6, 1022.99)


def _inputs(c, seed, edges=False):
    """Epoch, doubled codes of PRNs 1..c and (cp, dop, ph) as numpy; the
    wrap-edge case takes code phases from WRAP_EDGES in turn."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(S) + 1j * rng.standard_normal(S)).astype(
        np.complex64)
    u2 = epl.upsampled_code_doubled(ca_table_bipolar(list(range(1, c + 1))))
    if edges:
        cp = np.resize(np.array(WRAP_EDGES, np.float32), c)
    else:
        cp = rng.uniform(0, 1023, c).astype(np.float32)
    dop = rng.uniform(-5000, 5000, c).astype(np.float32)
    ph = rng.uniform(0, 1, c).astype(np.float32)
    return x, u2, cp, dop, ph


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


CASES = [(1, False), (6, False), (32, False), (6, True), (32, True)]
IDS = ["1ch", "6ch", "32ch", "edges_6ch", "edges_32ch"]


@pytest.mark.parametrize("c,edges", CASES, ids=IDS)
def test_plain_version_matches_jax_kernel(c, edges):
    x, u2, cp, dop, ph = _inputs(c, seed=100 + c, edges=edges)
    want = np.asarray(epl_correlate_pallas(
        jnp.asarray(x), jnp.asarray(u2), jnp.asarray(cp), jnp.asarray(dop),
        jnp.asarray(ph), FS, interpret=True))
    got = epl.epl_correlate_halfchip(*_torch(x, u2, cp, dop, ph), FS)
    assert got.shape == (c, 3) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("c,edges", [(6, False), (32, True)],
                         ids=["6ch", "edges_32ch"])
def test_host_build_matches_plain_version(c, edges):
    """csrc/epl.cu's arithmetic (track_epoch.cuh epl_sample, summed in the
    kernel's thread and warp order) against the plain version."""
    args = _torch(*_inputs(c, seed=200 + c, edges=edges))
    got = epl.epl_correlate_host(*args, FS)
    want = epl.epl_correlate_halfchip(*args, FS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_host_build_refuses_what_the_kernel_refuses():
    x, u2, cp, dop, ph = _torch(*_inputs(4, seed=3))
    with pytest.raises(ValueError, match="float32"):
        epl.epl_correlate_host(x, u2, cp.double(), dop, ph, FS)
    with pytest.raises(ValueError, match="contiguous"):
        epl.epl_correlate_host(x, u2, torch.stack([cp, cp], 1)[:, 0], dop,
                               ph, FS)
    with pytest.raises(ValueError, match="complex64"):
        epl.epl_correlate_host(x[:-1], u2, cp, dop, ph, FS)


def test_dispatcher_runs_plain_version_on_cpu():
    args = _torch(*_inputs(6, seed=5))
    calls = epl.epl_correlate_halfchip.calls
    launches = epl.epl_correlate_cuda.launches
    got = epl.epl_correlate(*args, FS)
    assert epl.epl_correlate_halfchip.calls == calls + 1
    assert epl.epl_correlate_cuda.launches == launches
    assert torch.equal(got, epl.epl_correlate_halfchip(*args, FS))
    with pytest.raises(ValueError, match="CUDA"):
        epl.epl_correlate_cuda(*args, FS)
    assert epl.epl_correlate_cuda.launches == launches


def _track(num_epochs, monkeypatch=None):
    x, sats = _scenario(num_epochs, seed=11)
    epochs = torch.as_tensor(x.reshape(num_epochs, S))
    u2 = torch.as_tensor(epl.upsampled_code_doubled(ca_table_bipolar(PRNS)))
    st = init_state(len(PRNS),
                    np.array([s.code_phase_chips + 0.1 for s in sats]),
                    np.array([s.doppler_hz + 15.0 for s in sats]))
    cfg = TrackConfig(codes_in_bit=CIB, use_pallas=True,
                      in_kernel_scan=False, pll_bad_state_threshold=10**6)
    return track_block(st, epochs, u2, BASEBAND_PLAN, cfg)


def test_track_epoch_step_goes_through_dispatcher(monkeypatch):
    seen = []
    dispatch = epl.epl_correlate

    def spy(*args):
        seen.append(args[0].device)
        return dispatch(*args)

    monkeypatch.setattr(epl, "epl_correlate", spy)
    calls = epl.epl_correlate_halfchip.calls
    _track(6)
    assert seen == [torch.device("cpu")] * 6
    assert epl.epl_correlate_halfchip.calls == calls + 6


def test_per_epoch_loop_on_host_build_matches_plain_version(monkeypatch):
    """The per-epoch half-chip loop with every epoch's E/P/L taken from the
    host build of the kernel: the loop feeds the kernel tensors it takes
    (its checks pass every epoch), and the closed loop agrees with the
    plain version's, integer decisions exactly."""
    st_p, out_p = _track(60)
    monkeypatch.setattr(epl, "epl_correlate", epl.epl_correlate_host)
    calls = epl.epl_correlate_halfchip.calls
    st_h, out_h = _track(60)
    assert epl.epl_correlate_halfchip.calls == calls
    for f in ("bit_ready", "bit_value", "bit_epoch", "period_sync_ok",
              "code_wrapped"):
        assert torch.equal(getattr(out_h, f), getattr(out_p, f)), f
    assert out_p.bit_ready.any(), "scenario never produced a nav bit"
    np.testing.assert_allclose(out_h.ip.numpy(), out_p.ip.numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(out_h.doppler_hz.numpy(),
                               out_p.doppler_hz.numpy(), atol=1e-2)
    np.testing.assert_allclose(st_h.code_phase_chips.numpy(),
                               st_p.code_phase_chips.numpy(), atol=1e-3)
