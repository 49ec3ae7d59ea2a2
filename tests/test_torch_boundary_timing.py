"""tests/test_boundary_timing.py on the port, against the JAX package.

Seven PRNs with nav-bit edges 2 %, 25 %, 46 %, 54 %, 75 %, 98 % and
49.95 % (the razor) into an epoch (``probes/stress.py``'s boundary
suite; the capture equals the JAX suite's, bit for bit):

* the port's Receiver on its reference scan against the JAX Receiver
  (tests/test_torch_receiver.py's rules), both under the suite's bar:
  every reconstructed subframe-boundary arrival at offset 0 and within
  5 us of the planted edge, the razor channel at 0 or a clean +/-1 ms;
* the tracking-scan kernel's plain version under the same bar.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat as JSimSat
from stm32f4_sdr_gps_tpu.signal.simulator import simulate_capture as j_sim
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.probes import stress
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from tests import test_boundary_timing as j_suite
from tests.test_nav import TEST_EPH
from tests.test_torch_impairments import (
    assert_receivers_part_only_where_marginal, jax_config, recorded_run)

torch.set_num_threads(2)

# channels whose reference scans part from the JAX Receiver's at a
# marginal decision (tests/test_torch_dynamics.py): {PRN: epoch}, each
# a half-chip replica cell
PARTS = {7: 1086, 15: 1259}


@pytest.fixture(scope="module")
def capture():
    return stress.boundary_capture()


def test_capture_equals_jax(capture):
    """The suite's constants and capture, built as the JAX suite builds
    them."""
    from stm32f4_sdr_gps_tpu.signal.nav_message import build_bitstream

    assert (stress.BND_PRNS, stress.BND_DELAYS, stress.BND_DOPPLERS) == (
        j_suite.PRNS, j_suite.DELAYS, j_suite.DOPPLERS)
    assert stress.TEST_EPH == TEST_EPH
    prefix = np.tile([0, 1], j_suite.PREFIX_BITS // 2).astype(np.int8)
    sats = []
    for prn, delay, dop in zip(j_suite.PRNS, j_suite.DELAYS,
                               j_suite.DOPPLERS):
        body = build_bitstream(dict(TEST_EPH),
                               start_tow_6s=j_suite.START_TOW6,
                               num_subframes=2, subframe_ids=(5, 1))
        sats.append(JSimSat(prn=prn, doppler_hz=dop, cn0_dbhz=49.0,
                            nav_bits=np.concatenate([prefix, body]),
                            codes_in_bit=j_suite.CIB, delay_ms=delay))
    x, _ = j_sim(sats, num_epochs=stress.BND_EPOCHS, seed=13)
    np.testing.assert_array_equal(capture, x)


def test_reference_scan_matches_jax(capture):
    """Both Receivers recorded on their full-readback paths: they part
    only at the named marginal epochs (PARTS) and meet the bar with the
    same integer offsets."""
    cfg = stress.compressed_config(stress.BND_PRNS, stress.BND_BLOCK
                                   ).replace(device_digest=False)
    j_run = recorded_run(JReceiver(jax_config(cfg).replace(
        device_digest=False)), capture)
    j_rec = stress.check_boundary(j_run[0])
    run = recorded_run(Receiver(cfg, device="cpu"), capture)
    rec = stress.check_boundary(run[0])
    assert_receivers_part_only_where_marginal(j_run, run, PARTS)
    assert [off for off, _ in rec.values()] == \
        [off for off, _ in j_rec.values()]


def test_kernel_plain_version_meets_the_bar(capture):
    calls = ts.track_scan_reference.calls
    report, rx = stress.run_receiver(
        capture, stress.compressed_config(stress.BND_PRNS, stress.BND_BLOCK,
                                          in_kernel_scan=True), "cpu")
    assert ts.track_scan_reference.calls - calls == \
        rx.profiler.stages["track"].calls
    stress.check_boundary(report)
