"""The port's capture ingest (signal/capture.py) against the JAX
package's: the SPI word packing both ways, the host conditioner on its
quarter-rate path and on its general mix, the device conditioner (on the
CPU here; on the card in chip_smoke.py phase 16) and every read_capture
format.  Tolerance: 1e-5 absolute on unit
samples (float32 rounding of the mix and the boxcar sum); integer
formats exactly."""

import jax
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import REFERENCE_PLAN as J_REF_PLAN
from stm32f4_sdr_gps_tpu.signal import capture as jcap
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.config import REFERENCE_PLAN
from stm32f4_sdr_gps_torch.signal import capture as tcap

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wire():
    """4 ms of PRN 11 as the reference front end delivers it: 1-bit real
    samples at 16.368 MHz, and their SPI words."""
    sat = SimSat(prn=11, doppler_hz=-1700.0, cn0_dbhz=50.0,
                 code_phase_chips=333.0)
    x, _ = simulate_capture([sat], num_epochs=4, plan=J_REF_PLAN, seed=3)
    return x, jcap.pack_bits_lsb16(x)


@pytest.mark.parametrize("n_words", [1, 7, 1023])
def test_pack_unpack_round_trip(n_words):
    rng = np.random.default_rng(n_words)
    signs = rng.choice([-1.0, 1.0], 16 * n_words).astype(np.float32)
    words = tcap.pack_bits_lsb16(signs)
    assert words.dtype == np.uint16
    np.testing.assert_array_equal(words, jcap.pack_bits_lsb16(signs))
    np.testing.assert_array_equal(tcap.unpack_bits_lsb16(words), signs)
    np.testing.assert_array_equal(tcap.unpack_bits_lsb16(words),
                                  jcap.unpack_bits_lsb16(words))
    # 0/1 input packs as the signs do
    np.testing.assert_array_equal(tcap.pack_bits_lsb16(signs > 0), words)
    with pytest.raises(ValueError):
        tcap.pack_bits_lsb16(signs[:-1])


def test_host_conditioner_quarter_rate_matches_jax(wire):
    x, _ = wire
    got = tcap.reference_to_baseband(x)
    want = jcap.reference_to_baseband(x)
    assert got.dtype == np.complex64 and got.shape == (len(x) // 8,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_jax", [True, False])
def test_host_conditioner_general_mix_matches_jax(wire, use_jax):
    """A boxcar of 4 leaves the quarter-rate path: the exact complex mix,
    then the integrate-and-dump, against both of the JAX package's
    branches."""
    x, _ = wire
    got = tcap.reference_to_baseband(x, REFERENCE_PLAN, decimation=4)
    assert got.dtype == np.complex64 and got.shape == (len(x) // 4,)
    want = jcap.reference_to_baseband(x, J_REF_PLAN, decimation=4,
                                      use_jax=use_jax)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_device_conditioner_matches_host_and_jax(wire):
    """From the packed words: the port's device conditioner (CPU tensors
    here) against the host conditioner and the JAX package's device
    conditioner; whole-epoch chunks give the same samples."""
    x, words = wire
    got = tcap.reference_to_baseband_device(words, device="cpu")
    assert got.dtype == torch.complex64
    host = tcap.reference_to_baseband(tcap.unpack_bits_lsb16(words))
    np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=1e-5)
    want = np.asarray(jax.jit(jcap.reference_to_baseband_device)(words))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    chunks = [tcap.reference_to_baseband_device(
        torch.as_tensor(words[i:i + 1023].astype(np.int32)), device="cpu")
        for i in range(0, len(words), 1023)]
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), got.numpy())


@pytest.mark.parametrize("fmt", ["npy", "cf32", "ci8", "bits16", "auto"])
def test_read_capture_formats_match_jax(fmt, wire, tmp_path):
    rng = np.random.default_rng(4)
    iq = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)
          ).astype(np.complex64) * 0.3
    if fmt in ("npy", "auto"):
        path = str(tmp_path / "cap.npy")
        np.save(path, iq)
    elif fmt == "cf32":
        path = str(tmp_path / "cap.cf32")
        np.stack([iq.real, iq.imag], -1).astype(np.float32).tofile(path)
    elif fmt == "ci8":
        path = str(tmp_path / "cap.ci8")
        np.clip(np.round(np.stack([iq.real, iq.imag], -1) * 127), -127,
                127).astype(np.int8).tofile(path)
    else:
        path = str(tmp_path / "cap.bin")
        wire[1].tofile(path)
    got = tcap.read_capture(path, fmt)
    want = jcap.read_capture(path, fmt)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)
    if fmt in ("npy", "cf32", "auto"):
        np.testing.assert_array_equal(got, iq)


def test_read_capture_refuses_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unknown capture format"):
        tcap.read_capture(str(tmp_path / "x.bin"), "wav")
