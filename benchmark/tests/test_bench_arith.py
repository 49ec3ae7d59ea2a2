"""The rate and tail arithmetic, on a window that holds a stall, K1's
operation and byte counts, and the reference's code-phase arithmetic."""

import dataclasses
import math
import statistics

import numpy as np
import pytest

from benchmark import gen, physics, roofline, run, scene, truth

from . import helpers


def _run(ctx, window_s, e2e):
    r = object.__new__(run.Run)
    r.ctx, r.window_s = ctx, window_s
    r.cell = type("C", (), {"end_to_end": [{"name": n, "unit": "u"}
                                           for n in e2e]})()
    return r


def test_rate_counts_the_whole_window_with_its_stall():
    # 36 jobs of 1 s of signal at 100x, then a 2 s stall: the rate is
    # over all the work and all the window, stall included
    r = _run({"tracked_epochs": 36 * 1000}, 36 * 0.01 + 2.0, ["rt_x"])
    assert r.end_to_end(5.0)["rt_x"]["value"] == pytest.approx(36 / 2.36)


def test_tail_sees_the_stall_and_the_median_does_not():
    walls = [0.020] * 94 + [0.500] * 6
    r = _run({"cold": {"wall_s": walls}}, 10.0, ["coldstart_p95_ms",
                                                 "setup_s"])
    out = r.end_to_end(7.5)
    assert out["coldstart_p95_ms"]["value"] > 400.0
    assert out["setup_s"]["value"] == 7.5
    assert statistics.median(walls) == 0.020


def test_p95_interpolates():
    assert run.p95(list(range(101))) == pytest.approx(95.0)


def test_chip_error_goes_the_short_way_round():
    assert truth.chip_error(1022.9, 0.1) == pytest.approx(0.2)
    assert truth.chip_error(0.1, 1022.9) == pytest.approx(0.2)
    assert truth.chip_error(300.0, 0.0) == pytest.approx(300.0)


def test_frontend_lag():
    # the wire's 8 samples summed into one baseband sample stand for
    # their middle, 3.5 samples at 16.368 MHz = 7/32 chip in
    assert truth.frontend_lag_s(helpers.config(wire=True)["frontend"]) \
        * physics.CODE_RATE_HZ == pytest.approx(7.0 / 32.0)
    assert truth.frontend_lag_s(helpers.config()["frontend"]) == 0.0


def test_planted_code_phase_is_the_signals():
    """The reference's code phase at an epoch's first sample, read as a
    replica at 2 samples a chip, is the code the generator put there."""
    cfg = helpers.config()
    sc = scene.build(cfg, 2 ** 31 + 5, 0, 0.01)
    sat = sc.sats[0]
    one = dataclasses.replace(sc, sats=[sat])
    s0, n, fs = 3 * 2046, 2046, cfg["frontend"]["sample_rate_hz"]
    x = gen.signal_chunk(one, cfg["frontend"], s0, n, "cpu").numpy()
    t = (np.arange(n) + s0) / fs
    phase = 2 * math.pi * (sat.carrier_phase_cycles + t * (
        sat.doppler_hz + 0.5 * sat.doppler_rate_hz_s * t))
    chips = np.sign((x * np.exp(-1j * phase)).real)
    cp = truth.code_phase_at(sat, s0 / fs)
    code = physics.ca_bipolar(sat.prn)
    replica = code[np.floor(cp + 0.5 * np.arange(n)).astype(int) % 1023]
    agree = abs(float(np.mean(chips * replica)))
    assert agree > 0.99
    # half a chip off, half the samples agree
    late = code[np.floor(cp + 0.5 + 0.5 * np.arange(n)).astype(int) % 1023]
    assert abs(float(np.mean(chips * late))) < 0.75


def test_k1_counts():
    # 25 operations per sample and channel
    assert roofline.k1_ops(1000, 32) == 25 * 1000 * 2046 * 32
    # PERF.md's kernel table: 24.43 us of operations at 32 channels,
    # 4.96 us of bytes at 4 channels, per 1000-epoch block
    assert roofline.k1_bound_s(1000, 32) == pytest.approx(24.43e-6, rel=1e-3)
    assert roofline.k1_bound_s(1000, 4) == pytest.approx(4.96e-6, rel=1e-3)
    assert roofline.k1_bytes(1000, 4) == (1000 * 2046 * 8 + 4 * 4352 * 4
                                          + 1000 * 4 * 11 * 4
                                          + 2 * 4 * 34 * 4)
    assert roofline.k1_bytes(100, 4) < roofline.k1_bytes(1000, 4)


def test_trace_busy_share_and_idle_gaps():
    from benchmark.trace import summarize

    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 3},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 45, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
         "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 160, "dur": 5},
    ]
    s = summarize(ev)
    # overlapping kernels count once; the window runs 0-165 us
    assert s["busy_s"] == pytest.approx((3 + 15 + 10 + 5) * 1e-6)
    assert s["window_s"] == pytest.approx(165e-6)
    assert s["kernels"]["k1"] == (pytest.approx(23e-6), 3)
    assert s["htod_s"] == pytest.approx(10e-6)
    gaps = dict(s["idle_gaps"])
    # each gap goes to the innermost host operation open at its middle
    assert gaps["inner"] == pytest.approx(32e-6)
    assert gaps["outer"] == pytest.approx(10e-6)
    assert gaps["host (no operation)"] == pytest.approx(90e-6)
