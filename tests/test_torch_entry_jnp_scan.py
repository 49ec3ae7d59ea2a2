"""The port's entry_jnp_scan (the reference-scan per-block program, 32
channels x 100 epochs) against the JAX package's, on the CPU.

Both draw their arguments from seed 0 in the same order, so the inputs
must be identical; the (100, 32) outputs and the returned state are held
to the tolerances of tests/test_pallas_scan.py:68-117 (ip / qp rtol 2e-2
/ atol 2.0, code phase 5e-3 chip, Doppler 0.5 Hz, SNR 0.1 dB), and every
integer array exactly, at every epoch (on noise no nav bit is expected,
so bit_ready is not required to fire)."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from stm32f4_sdr_gps_torch.config import TrackConfig
from stm32f4_sdr_gps_torch.entry import entry_jnp_scan
from stm32f4_sdr_gps_torch.track.state import TrackOutputs, TrackState

torch.set_num_threads(2)

FLOAT_TOL = {"ip": (2e-2, 2.0), "qp": (2e-2, 2.0),
             "code_phase_chips": (0.0, 5e-3), "doppler_hz": (0.0, 0.5),
             "snr_db": (0.0, 0.1)}
# the state's floats: the loop quantities at the outputs' tolerances; the
# correlator sums (SNR, bit and extended-bit sums) at ip / qp's (the
# extended sums at test_pallas_scan.py's atol 10); the discriminator
# memories (chips, half-cycles, cycles; |x| <= 1) and the carrier phase
# (cycles, wrap-aware) to 1e-3
STATE_TOL = {"code_phase_chips": (0.0, 5e-3), "doppler_hz": (0.0, 0.5),
             "acq_doppler_hz": (0.0, 0.5), "snr_db": (0.0, 0.1),
             "snr_i_sum": (2e-2, 2.0), "snr_q_sum": (2e-2, 2.0),
             "bit_ip_sum": (2e-2, 2.0), "bit_qp_sum": (2e-2, 2.0),
             "ext_ip_sum": (2e-2, 10.0), "ext_qp_sum": (2e-2, 10.0),
             "dll_err_prev": (0.0, 1e-3), "pll_err_prev": (0.0, 1e-3),
             "fll_theta_prev": (0.0, 1e-3), "fll_err_prev": (0.0, 1e-3)}


@pytest.fixture(scope="module")
def both():
    jfn, jargs = ge.entry_jnp_scan()
    jstate, jouts = jfn(*jargs)
    fn, args = entry_jnp_scan(device="cpu")
    state, outs = fn(*args)
    return jargs, (jstate, jouts), args, (state, outs)


def test_inputs_identical(both):
    (jstate, jepochs, jtable), _, (state, epochs, table), _ = both
    assert epochs.shape == (100, 2046) and table.shape == (32, 1023)
    assert np.array_equal(epochs.numpy(), np.asarray(jepochs))
    assert np.array_equal(table.numpy(), np.asarray(jtable))
    for f in TrackState._fields:
        assert np.array_equal(getattr(state, f).numpy(),
                              np.asarray(getattr(jstate, f))), f


def test_outputs_match_jax(both):
    _, (_, jouts), _, (_, outs) = both
    assert outs.ip.shape == (100, 32)
    for f in TrackOutputs._fields:
        got = getattr(outs, f).numpy()
        want = np.asarray(getattr(jouts, f))
        if f in ("ie", "qe", "il", "ql"):
            # E/L are zero-size placeholders without emit_correlators
            assert got.size == want.size == 0, f
            continue
        assert got.shape == want.shape, f
        if f in FLOAT_TOL:
            rtol, atol = FLOAT_TOL[f]
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f)
        else:        # the integer decisions, at every epoch
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64), err_msg=f)


def test_state_matches_jax(both):
    _, (jstate, _), _, (state, _) = both
    for f in TrackState._fields:
        got = getattr(state, f).numpy()
        want = np.asarray(getattr(jstate, f))
        if f == "carrier_phase_cycles":
            d = (got.astype(np.float64) - want + 0.5) % 1.0 - 0.5
            assert np.abs(d).max() < 1e-3, f
        elif got.dtype.kind == "f":
            rtol, atol = STATE_TOL[f]
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          want.astype(np.int64), err_msg=f)


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="set RUN_SLOW=1 to run")
def test_reference_scan_fix_matches_jax():
    """The reference scan to a fix on chip_smoke.py phase 4's 29 s capture
    (the same capture from both packages' simulators), on the CPU: both
    Receivers fix within 500 m with |vel| < 10 m/s, with equal subframe
    ledgers.  Prints both fixes (chip_smoke.py phase 18 prints the card's
    beside them)."""
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
    from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
    from stm32f4_sdr_gps_torch.config import ReceiverConfig
    from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
    from stm32f4_sdr_gps_torch.signal.scenarios import fix_scenario

    sc = fix_scenario(num_epochs=29_000)
    jrep = JReceiver(JReceiverConfig(
        prns=sc.prns, track_block_epochs=1000,
        track=JTrackConfig(in_kernel_scan=False))).run(sc.samples)
    rep = Receiver(ReceiverConfig(
        prns=sc.prns, track_block_epochs=1000,
        track=TrackConfig(in_kernel_scan=False)), device="cpu").run(sc.samples)
    fixes = {}
    for name, r in (("jax", jrep), ("port", rep)):
        sol = r.solutions[-1]
        fixes[name] = float(np.linalg.norm(sol.rr - sc.rr_true))
        assert fixes[name] < 500.0 and np.linalg.norm(sol.vel) < 10.0, name
    print(f"reference-scan fix on the CPU: JAX {fixes['jax']:.2f} m, port "
          f"{fixes['port']:.2f} m")
    assert ([c.subframe_time_ms for c in rep.channels]
            == [c.subframe_time_ms for c in jrep.channels])
