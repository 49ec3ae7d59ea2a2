"""The port's Receiver held to the multi-channel firmware oracle
(``fw_master_run``) on the cold capture of tests/test_master_parity.py
(38 s of wire format at 47 dBHz, seed 3, PRNs 2, 7, 15, 24, no Doppler
hints), on the CPU reference scan, with that suite's own bars: the cold
frequency bins within one 500 Hz bin of the oracle's; the nav bits
piecewise equal (tests/parity_util.py: a global inversion, at most five
slip segments, junk bits only at transitions, >= 300 matched); the
single-differenced relative pseudoranges (formed at each block's end by
the port's form_observations) in the {-1, 0, +1} light-ms classes, the 0
class >= 25 %, sub-ms residuals < 160 m, overlap mean < 40 m, 2 s window
means < 55 m.  Each bar is applied by the JAX suite's own test function
on the port's results and by the port's copy in
probes/firmware_parity.py (what chip_smoke.py applies on the card)."""

import pytest
import torch

import tests.test_master_parity as jax_suite
from stm32f4_sdr_gps_torch.probes import firmware_parity as fp
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband

torch.set_num_threads(2)

SUITE = "master_parity"


@pytest.fixture(scope="module")
def cold_pipelines(tmp_path_factory):
    """The JAX suite's (fw, bits, channels, observables, truth) tuple,
    with the port's Receiver (the reference scan) in place of the JAX
    one."""
    assert native.get_lib() is not None, "native library unavailable"
    words, truth = fp.generate(SUITE, str(tmp_path_factory.mktemp("cold")))
    fw = fp.run_oracle(SUITE, words)
    cfg = fp.receiver_config(SUITE, in_kernel_scan=False)
    assert cfg.doppler_hints_hz is None
    _, report, bits, _, obs = fp.run_receiver(
        reference_to_baseband(native.unpack_bits16(words)), cfg,
        device="cpu", observables=True)
    return fw, bits, {ch.prn: ch for ch in report.channels}, obs, truth


def test_cold_frequency_search_parity(cold_pipelines):
    jax_suite.test_cold_frequency_search_parity(cold_pipelines)
    fw, _, channels, _, truth = cold_pipelines
    assert len(fp.check_cold_bins(fw, channels, truth)) == 4


def test_cold_nav_bits_bit_exact(cold_pipelines):
    jax_suite.test_cold_nav_bits_bit_exact(cold_pipelines)
    fw, bits, _, _, _ = cold_pipelines
    for chd in fw["channels"]:
        rec = fp.check_bits_piecewise("cold", chd["prn"], chd, bits,
                                      min_matched=300)
        assert rec["segments"] <= 5, chd["prn"]


def test_relative_pseudorange_parity(cold_pipelines):
    jax_suite.test_relative_pseudorange_parity(cold_pipelines)
    fw, _, _, obs, _ = cold_pipelines
    rec = fp.check_relative_pseudoranges(fw, obs)
    assert rec["single_differences"] >= 20
    assert rec["worst_sub_ms_m"] < 160.0
