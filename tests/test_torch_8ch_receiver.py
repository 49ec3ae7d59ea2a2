"""tests/test_8ch_receiver.py on the port, against the JAX package.

Eight PRNs at 46 dBHz with seeded Dopplers and delays, 500-epoch blocks
(``probes/stress.py``'s eight-channel suite; the capture equals the JAX
suite's, bit for bit):

* the port's Receiver on its reference scan against the JAX Receiver
  (tests/test_torch_receiver.py's rules), both under the suite's bar: at
  least 7 full ephemeris sets, A within 1 m, ``EPH UTC`` on the
  dashboard;
* the tracking-scan kernel's plain version under the same bar.
"""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_tpu.signal.nav_message import build_bitstream
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat as JSimSat
from stm32f4_sdr_gps_tpu.signal.simulator import simulate_capture as j_sim
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.probes import stress
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from tests import test_8ch_receiver as j_suite
from tests.test_nav import TEST_EPH
from tests.test_torch_impairments import (
    assert_receivers_part_only_where_marginal, jax_config, recorded_run)

torch.set_num_threads(2)

# channels whose reference scans part from the JAX Receiver's at a
# marginal decision (tests/test_torch_dynamics.py): {PRN: epoch}, each
# a half-chip replica cell
PARTS = {16: 1144, 31: 120}


@pytest.fixture(scope="module")
def capture():
    return stress.eight_capture()


def test_capture_equals_jax(capture):
    """The suite's capture, built as test_eight_channels_decode builds
    it."""
    assert stress.EIGHT_PRNS == j_suite.PRNS
    prefix = np.tile([0, 1], 60).astype(np.int8)
    rng = np.random.default_rng(5)
    sats = []
    for prn in j_suite.PRNS:
        body = build_bitstream(dict(TEST_EPH), start_tow_6s=58800,
                               num_subframes=4, subframe_ids=(5, 1, 2, 3))
        sats.append(JSimSat(prn=prn,
                            doppler_hz=float(rng.uniform(-6000, 6000)),
                            cn0_dbhz=46.0,
                            nav_bits=np.concatenate([prefix, body]),
                            codes_in_bit=j_suite.CIB,
                            delay_ms=float(rng.uniform(1.0, 20.0))))
    x, _ = j_sim(sats, num_epochs=stress.EIGHT_EPOCHS, seed=5)
    np.testing.assert_array_equal(capture, x)


def test_reference_scan_matches_jax(capture):
    """Both Receivers recorded on their full-readback paths: they part
    only at the named marginal epochs (PARTS) and meet the bar with the
    same full sets."""
    cfg = stress.compressed_config(stress.EIGHT_PRNS, stress.EIGHT_BLOCK
                                   ).replace(device_digest=False)
    j_rx = JReceiver(jax_config(cfg).replace(device_digest=False))
    j_run = recorded_run(j_rx, capture)
    j_full = stress.check_eight(j_run[0], j_rx)
    rx = Receiver(cfg, device="cpu")
    run = recorded_run(rx, capture)
    assert stress.check_eight(run[0], rx) == j_full
    assert_receivers_part_only_where_marginal(j_run, run, PARTS)


def test_kernel_plain_version_meets_the_bar(capture):
    calls = ts.track_scan_reference.calls
    report, rx = stress.run_receiver(
        capture, stress.compressed_config(stress.EIGHT_PRNS,
                                          stress.EIGHT_BLOCK,
                                          in_kernel_scan=True), "cpu")
    assert ts.track_scan_reference.calls - calls == \
        rx.profiler.stages["track"].calls
    stress.check_eight(report, rx)
