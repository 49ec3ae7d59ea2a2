"""The port's copy of the native ingest bindings (runtime/native.py)
against the JAX package's, and the ring buffer as a StreamingTracker
block source, on the CPU."""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.runtime import native as j_native
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, TrackConfig
from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
from stm32f4_sdr_gps_torch.parallel.streaming import StreamingTracker
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.capture import (pack_bits_lsb16,
                                                  unpack_bits_lsb16)
from stm32f4_sdr_gps_torch.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.track.state import init_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_bit_codecs_match_jax_and_capture(lib):
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 16, 500).astype(np.uint16)
    signs = native.unpack_bits16(words)
    assert np.array_equal(signs, j_native.unpack_bits16(words))
    assert np.array_equal(signs, unpack_bits_lsb16(words))
    assert np.array_equal(native.pack_bits16(signs), words)
    assert np.array_equal(pack_bits_lsb16(signs), words)


def test_correlator_oracle_matches_jax(lib):
    rng = np.random.default_rng(2)
    prn = rng.integers(0, 256, 32).astype(np.uint8)
    data_i = rng.integers(0, 256, 32).astype(np.uint8)
    data_q = rng.integers(0, 256, 32).astype(np.uint8)
    for offset in (0, 5, 31):
        assert native.correlate_1bit_oracle(data_i, data_q, prn, offset) \
            == j_native.correlate_1bit_oracle(data_i, data_q, prn, offset)
    assert native.correlate_1bit_oracle(prn, ~prn, prn, 0) == (-128, 128)


def test_ring_feeds_the_streaming_tracker(lib):
    """Blocks popped from the native ring (interleaved I/Q floats) drive
    the tracker to the same outputs as the array itself."""
    s = BASEBAND_PLAN.samples_per_epoch
    x, _ = simulate_capture([SimSat(prn=3, doppler_hz=1800.0,
                                    code_phase_chips=444.0, cn0_dbhz=46.0)],
                            num_epochs=20, seed=4)
    mesh = make_mesh(time=1, devices=["cpu"] * 2)
    st = init_state(2, np.array([444.0, 10.0]), np.array([1800.0, 0.0]),
                    device="cpu")

    def tracker():
        return StreamingTracker(st, ca_table_bipolar([3, 5]), mesh,
                                BASEBAND_PLAN, TrackConfig())

    ring = native.NativeRing(2 * 10 * s * 2)
    from_ring, direct = tracker(), tracker()
    for k in range(2):
        block = x[k * 10 * s:(k + 1) * 10 * s]
        assert ring.push(block.view(np.float32))
        popped = ring.pop(2 * 10 * s).view(np.complex64)
        got, want = from_ring.process(popped), direct.process(block)
        for f, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), f
    assert ring.available == 0
