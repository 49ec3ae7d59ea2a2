"""tests/test_dynamics.py on the port, against the JAX package.

The three scenarios of ``probes/stress.py``'s dynamics suite (a 0.9 Hz/s
Doppler ramp over 4000 epochs, a 40 ms dropout and a 60 ms noise burst
over 2000 epochs; the port's captures equal the JAX package's, bit for
bit, tests/test_torch_impairments.py) through one channel of
``track_block``:

* the port's reference scan against the JAX reference scan, with the
  tolerances of tests/test_pallas_scan.py:68-117 and exact integer
  decisions;
* the tracking-scan kernel's plain version (``in_kernel_scan=True``)
  against the JAX Pallas kernel K1 in interpret mode, the same way;
* both under the suite's bars (``stress.check_dynamics``), and the
  simulator's chirp bookkeeping in both packages.

The scenarios carry no data bits, so no bit is decided; the integer
decisions compared are the bit-sync flags.  Over the dropout's 40 ms of
exact zeros the SNR estimator sees no signal; NaN counts as equal to NaN
there (assert_allclose's default).

Two runs may part at an epoch whose decision is marginal (the repo's rule,
chip_smoke.py's MARGINAL_IP): a prompt sign within float32 summation
error of zero, or a half-chip replica cell that the two code phases,
within the 5e-3 chip tolerance of each other, straddle.  At 2 samples a
chip the replica's sample k sits at the code phase plus k/2 chips plus
the code Doppler's drift so far in the epoch (up to 1023 |fd| / fL1,
~0.004 chip), computed in float32; the cells can differ only where a
multiple of 0.5 chip lies in the span those positions sweep in the two
runs.  ``assert_scan_match`` lets a channel part only at such an epoch
(or just after one), compares it up to there and returns where each
channel parts; each test names those epochs.  On the
dropout capture the JAX Pallas kernel's code phase, accumulated in its
own order, runs up to ~1e-3 chip from the reference scan's (the port's
kernel plain version follows the reference scan's); at epoch 450 the
code phase sits at 100.5 chips and the two kernels pick neighbouring
cells (ROADMAP Queue 3, "Half-chip cell at a boundary").
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import BASEBAND_PLAN as J_PLAN
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.ops.pallas_epl import upsampled_code_doubled
from stm32f4_sdr_gps_tpu.ops.pallas_track_scan import track_block_pallas
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat as JSimSat
from stm32f4_sdr_gps_tpu.signal.simulator import simulate_capture as j_sim
from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.probes import stress

torch.set_num_threads(2)

NAMES = tuple(stress.DYNAMICS)

# a prompt-sign decision on |ip| below this is marginal (chip_smoke.py)
MARGINAL_IP = 0.5
# the code-phase tolerance of tests/test_pallas_scan.py:68-117
CP_ATOL = 5e-3
FL1 = 1.57542e9
# a float32 ulp of a replica sample's position (< 2048 chips)
POS_ULP = 2.0 ** -13
# epochs where the JAX Pallas kernel and the port's kernel plain version
# part on a marginal decision: {scenario: {channel: epoch}}
KERNEL_PARTS = {"ramp": {}, "dropout": {0: 450}, "burst": {}}

_INT_STATE = ("fll_primed", "prev_ip_sign", "last_swap_epoch",
              "right_period_cnt", "period_sync_ok", "old_remainder",
              "bit_pos_cnt", "bit_neg_cnt", "pll_bad_cnt",
              "pll_bad_master_cnt", "snr_cnt", "epoch_idx", "code_wraps",
              "ip_sign_window", "ext_bit_cnt")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def half_chip_marginal(cp_a, cp_b, dop_a, dop_b):
    """(T, C) bool: epochs where the two runs' code phases, within CP_ATOL
    of each other, put some replica sample in different half-chip cells:
    a multiple of 0.5 chip lies in the span their samples' positions
    sweep (the module docstring), widened by one float32 ulp of a
    position."""
    def sweep(dop):
        # the epoch's code rate is set by the Doppler its scan entered
        # with: the previous epoch's output
        d_in = np.concatenate([dop[:1], dop[:-1]]).astype(np.float64)
        return ((J_PLAN.samples_per_epoch - 1) * J_PLAN.chips_per_sample
                * d_in / FL1)

    sw_a, sw_b = sweep(dop_a), sweep(dop_b)
    lo = np.minimum(cp_a + np.minimum(sw_a, 0), cp_b + np.minimum(sw_b, 0))
    hi = np.maximum(cp_a + np.maximum(sw_a, 0), cp_b + np.maximum(sw_b, 0))
    return ((np.floor(2 * (hi + POS_ULP)) != np.floor(2 * (lo - POS_ULP)))
            & (np.abs(cp_a - cp_b) <= CP_ATOL))


def assert_scan_match(out_ref, out, st_ref=None, st=None):
    """(T, C) outputs of one package's scan (``out_ref``) against the
    port's (``out``): the tolerances of tests/test_pallas_scan.py:68-117
    on the floats and exact integer decisions.  A channel may part, but
    only at an epoch with a marginal decision (the module docstring) in
    it or in the two epochs before it; it is compared up to there.  A
    channel that does not part must also end in the same state.  Returns
    {channel: epoch where it parts}."""
    a = {f: _np(getattr(out_ref, f)) for f in out._fields}
    b = {f: _np(getattr(out, f)) for f in out._fields}
    t_cnt, c_cnt = b["ip"].shape
    bad = np.zeros((t_cnt, c_cnt), bool)
    for name, rtol, atol in (("ip", 2e-2, 2.0), ("qp", 2e-2, 2.0),
                             ("code_phase_chips", 0.0, CP_ATOL),
                             ("doppler_hz", 0.0, 0.5),
                             ("snr_db", 0.0, 0.1)):
        x, y = a[name].astype(np.float64), b[name].astype(np.float64)
        bad |= ~((np.abs(x - y) <= atol + rtol * np.abs(x))
                 | (np.isnan(x) & np.isnan(y)))
    ready = a["bit_ready"].astype(bool)
    for name in ("bit_ready", "period_sync_ok"):
        bad |= a[name] != b[name]
    for name in ("bit_value", "bit_epoch"):
        bad |= ready & (a[name] != b[name])
    marginal = (((a["ip"] > 0) != (b["ip"] > 0))
                & (np.minimum(np.abs(a["ip"]), np.abs(b["ip"]))
                   < MARGINAL_IP))
    marginal |= half_chip_marginal(a["code_phase_chips"].astype(np.float64),
                                   b["code_phase_chips"].astype(np.float64),
                                   a["doppler_hz"], b["doppler_hz"])
    stop = np.where(bad.any(0), bad.argmax(0), t_cnt)
    for c in np.nonzero(stop < t_cnt)[0]:
        t = stop[c]
        assert marginal[max(0, t - 2): t + 1, c].any(), (
            f"channel {c} parts at epoch {t} with no marginal decision: "
            + ", ".join(f"{f} {a[f][t, c]} / {b[f][t, c]}" for f in
                        ("ip", "qp", "code_phase_chips", "doppler_hz",
                         "bit_ready", "period_sync_ok")))
    whole = stop == t_cnt
    if st_ref is not None and whole.any():
        for f, atol in (("code_phase_chips", CP_ATOL), ("doppler_hz", 0.5),
                        ("snr_db", 0.1)):
            np.testing.assert_allclose(_np(getattr(st, f))[whole],
                                       _np(getattr(st_ref, f))[whole],
                                       atol=atol, err_msg=f)
        for f in _INT_STATE:
            np.testing.assert_array_equal(
                _np(getattr(st, f)).astype(np.int32)[whole],
                _np(getattr(st_ref, f)).astype(np.int32)[whole], err_msg=f)
    return {int(c): int(stop[c]) for c in np.nonzero(~whole)[0]}


def _jax_run(name, x, kernel):
    """The JAX package's run of the scenario: its reference scan (as
    tests/test_dynamics.py runs it) or its Pallas kernel in interpret
    mode."""
    kw, e, _, cp0, dop0, _ = stress.DYNAMICS[name]
    st0 = j_init_state(1, np.array([cp0]), np.array([dop0]))
    table = ca_table_bipolar([kw["prn"]])
    epochs = jnp.asarray(x.reshape(e, J_PLAN.samples_per_epoch))
    if kernel:
        return track_block_pallas(
            st0, epochs, jnp.asarray(upsampled_code_doubled(table)), J_PLAN,
            JTrackConfig(pallas_interpret=True), interpret=True)
    return j_track_block(st0, epochs, jnp.asarray(table), J_PLAN,
                         JTrackConfig())


def test_chirp_truth_matches_jax():
    """The chirp bookkeeping bar in the port, and the port's truth equal
    to the JAX simulator's at every epoch of the ramp."""
    stress.check_chirp_truth()
    kw, e, seed, _, _, _ = stress.DYNAMICS["ramp"]
    _, truth, _ = stress.dynamics_capture("ramp")
    _, j_truth = j_sim([JSimSat(**kw)], num_epochs=e, seed=seed)
    for t in (0, 1, 1000, 2000, 3999):
        assert truth.code_phase_at_epoch(0, t) == \
            j_truth.code_phase_at_epoch(0, t), t


@pytest.mark.parametrize("name", NAMES)
def test_reference_scan_matches_jax(name):
    """The port's reference scan (the CPU default) against the JAX
    reference scan on the same capture, then the suite's bar."""
    x, truth, _ = stress.dynamics_capture(name)
    st_ref, out_ref = _jax_run(name, x, kernel=False)
    st, out, rec = stress.run_dynamics(name, "cpu")
    assert assert_scan_match(out_ref, out, st_ref, st) == {}
    stress.check_dynamics(name, np.asarray(out_ref.doppler_hz)[:, 0],
                          np.asarray(out_ref.code_phase_chips)[:, 0], truth)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_plain_version_matches_jax_kernel(name):
    """The tracking-scan kernel's plain version against the JAX Pallas
    kernel in interpret mode on the same capture, up to the named
    marginal epoch (KERNEL_PARTS); then the suite's bar on both."""
    x, truth, _ = stress.dynamics_capture(name)
    st_ref, out_ref = _jax_run(name, x, kernel=True)
    calls = ts.track_scan_reference.calls
    st, out, rec = stress.run_dynamics(name, "cpu", in_kernel_scan=True)
    assert ts.track_scan_reference.calls == calls + 1
    assert assert_scan_match(out_ref, out, st_ref, st) == KERNEL_PARTS[name]
    stress.check_dynamics(name, np.asarray(out_ref.doppler_hz)[:, 0],
                          np.asarray(out_ref.code_phase_chips)[:, 0], truth)
