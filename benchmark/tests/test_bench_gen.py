"""The device generator against its frozen NumPy copy on a short
capture, in both front ends, and the inputs as a function of the seed."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import gen, gen_np, scene

from . import helpers

SEED = 2 ** 31 + 4099


def _cfg(name):
    with open(os.path.join(helpers.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _check_signal(cfg, sample0, n):
    sc = scene.build(cfg, SEED, 1, 36.0)
    fe = cfg["frontend"]
    got = gen.signal_chunk(sc, fe, sample0, n, "cpu").numpy()
    want = gen_np.signal_chunk(sc, fe, sample0, n)
    assert got.dtype == want.dtype
    # the copy evaluates the carrier at its whole phase (~1e8 cycles at
    # the IF), the generator at its fraction: 1e-7 of unit noise apart
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    return sc, got


def test_baseband_signal_matches_numpy_copy():
    cfg = _cfg("iq2046k_allview32")
    sc, x = _check_signal(cfg, 35_000 * 2046, 4 * 2046)
    assert len(sc.sats) == 10
    assert np.iscomplexobj(x)


def test_wire_signal_matches_numpy_copy():
    cfg = _cfg("fw_max2769_4sat")
    sc, x = _check_signal(cfg, 20_000 * 16368, 2 * 16368)
    assert sc.prns == (2, 7, 15, 24)
    assert not np.iscomplexobj(x)


def test_packing_matches_numpy_copy():
    x = torch.randn(1023 * 16 * 3, generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    x[:16] = torch.tensor([1.0, -1, 0, -0.5] * 4, dtype=torch.float64)
    got = gen.pack_words(x).numpy().astype(np.uint16)
    np.testing.assert_array_equal(got, gen_np.pack_words(x.numpy()))
    # LSB first: bit k is sample k's sign (0 counts as positive)
    assert got[0] == 0b0101010101010101 | 0b0100010001000100


def test_captures_follow_the_seed():
    cfg = _cfg("fw_max2769_4sat")
    sc = scene.build(cfg, SEED, 0, 0.01)
    a = gen.synthesize(sc, cfg["frontend"], 6, SEED, "cpu", chunk_epochs=4)
    b = gen.synthesize(sc, cfg["frontend"], 6, SEED, "cpu", chunk_epochs=4)
    c = gen.synthesize(sc, cfg["frontend"], 6, SEED + 1, "cpu",
                       chunk_epochs=4)
    assert a.dtype == np.uint16 and a.shape == (6 * 1023,)
    np.testing.assert_array_equal(a, b)
    assert (a != c).mean() > 0.5


def test_open_sky_follows_the_seed():
    cfg = _cfg("iq2046k_allview32")
    s1 = scene.build(cfg, SEED, 0, 36.0)
    s2 = scene.build(cfg, SEED, 0, 36.0)
    s3 = scene.build(cfg, SEED, 1, 36.0)
    assert s1.prns == s2.prns and np.array_equal(s1.rr, s2.rr)
    assert not np.array_equal(s1.rr, s3.rr)
    for s in s1.sats + s3.sats:
        assert s.elevation_deg >= 10.0 and 44.0 <= s.cn0_dbhz <= 50.0
        assert abs(s.doppler_hz) < 5000.0
        assert len(s.bits) == 100 + 3000


class _NoNoise:
    def standard_normal(self, n):
        return np.zeros(n)


def _port_simulator(sc, fe, sample0, n):
    """The port's own simulator (``signal/simulator.py``), noise off,
    over the same scene: its samples before any cast."""
    from stm32f4_sdr_gps_torch.config import SignalPlan
    from stm32f4_sdr_gps_torch.signal import simulator as sim

    plan = SignalPlan(sample_rate_hz=fe["sample_rate_hz"],
                      if_freq_hz=fe.get("if_hz", 0.0),
                      complex_input=fe["complex"])
    sats = [sim.SimSat(prn=s.prn, doppler_hz=s.doppler_hz,
                       doppler_rate_hz_s=s.doppler_rate_hz_s,
                       carrier_phase_cycles=s.carrier_phase_cycles,
                       cn0_dbhz=s.cn0_dbhz, nav_bits=s.bits,
                       codes_in_bit=sc.codes_in_bit,
                       delay_ms=s.delay_s * 1e3) for s in sc.sats]
    x, _ = sim._simulate_chunk(sats, sample0, n, plan, 1.0, _NoNoise())
    return np.asarray(x, np.complex128 if fe["complex"] else np.float64)


@pytest.mark.parametrize("name,sample0,n", [
    ("iq2046k_allview32", 35_000 * 2046, 2 * 2046),
    ("fw_max2769_4sat", 20_000 * 16368, 16368)])
def test_generator_matches_the_port_simulator(name, sample0, n):
    """The C/N0 calibration, code, carrier and bits are the port's
    simulator's: the same scene gives the same noiseless samples to the
    float32 rounding the simulator's output cast leaves."""
    cfg = _cfg(name)
    sc = scene.build(cfg, SEED, 1, 36.0)
    fe = cfg["frontend"]
    got = gen.signal_chunk(sc, fe, sample0, n, "cpu").numpy()
    want = _port_simulator(sc, fe, sample0, n)
    amp = np.abs(want).max()
    assert amp > 0
    assert np.abs(got - want).max() <= 1e-6 * amp
