"""The closed-loop claims of tests/test_coherent_bits.py and
tests/test_coherent_pll.py on the port, against the JAX package.

Each run of ``probes/stress.py``'s coherent suite (``COHERENT_RUNS``: the
mixed-sign bit, the clean streams and the 28 dBHz capture in firmware and
coherent bit modes, the per-epoch, 20 ms and 100 ms PLLs at 29, 24 and
45 dBHz) goes through one channel of ``track_block``:

* the port's reference scan against the JAX reference scan (as the JAX
  suites run it), under ``assert_scan_match`` (tests/
  test_torch_dynamics.py: test_pallas_scan's tolerances, exact integer
  decisions, each channel up to a named marginal epoch);
* the tracking-scan kernel's plain version against the JAX Pallas kernel
  K1 in interpret mode, the same way;
* every claim (``stress.check_coherent``) on both reference scans and on
  the kernel's plain version.

The captures are the port's simulator's; the test first holds them to
the JAX simulator's, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import BASEBAND_PLAN as J_PLAN
from stm32f4_sdr_gps_tpu.config import COHERENT_TRACK as J_COHERENT
from stm32f4_sdr_gps_tpu.config import DEEP_COHERENT_TRACK as J_DEEP
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.ops.pallas_epl import upsampled_code_doubled
from stm32f4_sdr_gps_tpu.ops.pallas_track_scan import track_block_pallas
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.probes import stress
from tests.test_coherent_bits import _frozen_cfg as j_frozen_cfg
from tests.test_coherent_bits import _run as j_mixed_run
from tests.test_coherent_pll import _capture as j_pll_capture
from tests.test_torch_dynamics import assert_scan_match

torch.set_num_threads(2)

RUNS = tuple(stress.COHERENT_RUNS)

# the JAX suites' configs, by the names of stress.coherent_configs()
J_CONFIGS = {
    "mixed_fw": j_frozen_cfg(),
    "mixed_co": j_frozen_cfg(coherent_bit_vote=True),
    "clean_fw": JTrackConfig(codes_in_bit=3, pll_bad_state_threshold=10**9),
    "clean_co": JTrackConfig(codes_in_bit=3, coherent_bit_vote=True,
                             pll_bad_state_threshold=10**9),
    "low_fw": j_frozen_cfg(),
    "low_co": j_frozen_cfg(coherent_bit_vote=True),
    "per_epoch": JTrackConfig(coherent_bit_vote=True),
    "coherent": J_COHERENT,
    "ext5": J_DEEP,
}

# runs that part from the JAX run on a marginal decision:
# {(kernel, run): {channel: epoch}}
PARTS = {}


@pytest.fixture(scope="module")
def captures():
    return stress.coherent_captures()


@pytest.fixture(scope="module")
def kernel_runs(captures):
    """Every run on the tracking-scan kernel's plain version: {run: (state,
    outputs)}, one plain-version call each."""
    calls = ts.track_scan_reference.calls
    runs = {run: _port_run(run, captures, in_kernel_scan=True)
            for run in RUNS}
    assert ts.track_scan_reference.calls == calls + len(RUNS)
    return runs


def _jax_run(run, caps, kernel):
    """One run in the JAX package: its reference scan, or its Pallas kernel
    in interpret mode."""
    cfg_name, cap, prn, cp0, dop0, synced = stress.COHERENT_RUNS[run]
    x = caps[cap][0]
    st0 = j_init_state(1, np.array([cp0]), np.array([dop0]))
    if synced:
        st0 = st0._replace(period_sync_ok=jnp.ones(1, bool),
                           right_period_cnt=jnp.full((1,), 10, jnp.int32))
    epochs = jnp.asarray(x.reshape(-1, J_PLAN.samples_per_epoch))
    table = ca_table_bipolar([prn])
    cfg = J_CONFIGS[cfg_name]
    if kernel:
        return track_block_pallas(
            st0, epochs, jnp.asarray(upsampled_code_doubled(table)), J_PLAN,
            dataclasses.replace(cfg, pallas_interpret=True), interpret=True)
    return j_track_block(st0, epochs, jnp.asarray(table), J_PLAN, cfg)


def _port_run(run, caps, **track):
    cfg_name, cap, prn, cp0, dop0, synced = stress.COHERENT_RUNS[run]
    cfg = dataclasses.replace(stress.coherent_configs()[cfg_name], **track)
    return stress.run_track(caps[cap][0], [prn], [cp0], [dop0], cfg, "cpu",
                            synced)


def test_captures_equal_jax(captures):
    """The port's captures and configs are the JAX suites': the mixed-sign
    epochs through the JAX suite's own runner decide what the port's
    capture does; the PLL captures equal test_coherent_pll._capture's."""
    for name in stress.PLL_CAPTURES:
        cn0, n_bits, seed = stress.PLL_CAPTURES[name]
        epochs, bits = j_pll_capture(cn0, n_bits, seed)
        x, pbits = captures[name]
        np.testing.assert_array_equal(
            np.asarray(epochs).reshape(-1), x)
        assert list(bits) == list(pbits)
    amps = [-1.0] * 11 + [2.0] * 9 + [1.0] * 20 + [-1.0] * 20
    for co in (False, True):
        bits, eps = j_mixed_run(j_frozen_cfg(coherent_bit_vote=co), amps)
        st, out = _jax_run("mixed_co" if co else "mixed_fw", captures, False)
        got = stress.decided_bits(out)
        assert list(got[0]) == list(bits) and list(got[1]) == list(eps)
    for name, cfg in stress.coherent_configs().items():
        jcfg = J_CONFIGS[name]
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name,
                                                                   f.name)


def test_reference_scan_matches_jax(captures):
    """Every run on the port's reference scan against the JAX reference
    scan, and every claim on both packages' results."""
    outs, j_outs = {}, {}
    for run in RUNS:
        st_ref, out_ref = _jax_run(run, captures, kernel=False)
        st, out = _port_run(run, captures)
        assert assert_scan_match(out_ref, out, st_ref, st) == \
            PARTS.get((False, run), {}), run
        outs[run] = stress.numpy_outputs(out)
        j_outs[run] = out_ref
    stress.check_coherent(j_outs, captures)
    stress.check_coherent(outs, captures)


@pytest.mark.parametrize("run", RUNS)
def test_kernel_plain_version_matches_jax_kernel(run, captures, kernel_runs):
    """One run on the tracking-scan kernel's plain version against the JAX
    Pallas kernel in interpret mode."""
    st_ref, out_ref = _jax_run(run, captures, kernel=True)
    st, out = kernel_runs[run]
    assert assert_scan_match(out_ref, out, st_ref, st) == \
        PARTS.get((True, run), {}), run


def test_kernel_plain_version_meets_the_claims(captures, kernel_runs):
    """Every claim on the tracking-scan kernel's plain version (the
    semantics chip_smoke.py's phase 22 runs through K1 on the card)."""
    pll = stress.check_coherent(
        {k: stress.numpy_outputs(o) for k, (_, o) in kernel_runs.items()},
        captures)
    assert pll["pll29_coherent"][0] <= 1 and pll["pll24_ext5"][0] <= 1
