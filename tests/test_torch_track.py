"""The port's tracking scans against the JAX package's, on the CPU.

* ``track.scan.track_block`` in both replica modes (fractional phase and
  half-chip) against the JAX ``track_block``;
* the tracking-scan kernel's plain version (``track_scan_reference``)
  against the JAX Pallas kernel K1 in interpret mode;
* the host build of the CUDA kernel's arithmetic against the plain
  version, with exact integer decisions;
* all three in each of K1's other modes (``MODES``: coherent_bit_vote,
  coherent_pll, coherent_pll with pll_ext_bits, emit_correlators).

Same scenario and tolerance helpers as tests/test_pallas_scan.py.  Inputs
go to both packages as numpy arrays.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.ops.pallas_epl import (
    upsampled_code_doubled as j_upsampled,
)
from stm32f4_sdr_gps_tpu.ops.pallas_track_scan import (
    state_from_track_state as j_state_from_track_state,
    track_block_pallas,
)
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.scan import _lcg_uniform as j_lcg
from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch import convert
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as T_PLAN
from stm32f4_sdr_gps_torch.config import TrackConfig
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
from stm32f4_sdr_gps_torch.track.scan import _lcg_uniform, track_block
from stm32f4_sdr_gps_torch.track.state import init_state
from tests.test_pallas_scan import (
    CIB,
    PLAN,
    PRNS,
    _assert_outputs_match,
    _assert_states_match,
    _scenario,
)

torch.set_num_threads(2)


def _setup(num_epochs, seed=11, cp_off=0.1, dop_off=15.0):
    x, sats = _scenario(num_epochs, seed=seed)
    epochs = x.reshape(num_epochs, PLAN.samples_per_epoch)
    table = ca_table_bipolar(PRNS)
    cp0 = np.array([s.code_phase_chips + cp_off for s in sats])
    dop0 = np.array([s.doppler_hz + dop_off for s in sats])
    return epochs, table, cp0, dop0


def _torch_cfg(**kw):
    return TrackConfig(codes_in_bit=CIB, **kw)


def _jax_cfg(**kw):
    return JTrackConfig(codes_in_bit=CIB, pallas_interpret=True, **kw)


@pytest.mark.parametrize("half_chip", [False, True],
                         ids=["fractional", "half_chip"])
def test_track_block_matches_jax(half_chip):
    """The per-epoch reference scan, both replica modes (atan2 Costas on
    both sides)."""
    epochs, table, cp0, dop0 = _setup(90)
    code = upsampled_code_doubled(table) if half_chip else table
    jcfg = _jax_cfg(use_pallas=half_chip, pll_bad_state_threshold=10**6)
    st_ref, out_ref = j_track_block(
        j_init_state(len(PRNS), cp0, dop0), jnp.asarray(epochs),
        jnp.asarray(code), PLAN, jcfg)
    cfg = _torch_cfg(use_pallas=half_chip, pll_bad_state_threshold=10**6)
    st, out = track_block(init_state(len(PRNS), cp0, dop0, device="cpu"),
                          torch.as_tensor(epochs), torch.as_tensor(code),
                          T_PLAN, cfg)
    _assert_outputs_match(out_ref, out)
    _assert_states_match(st_ref, st)


@pytest.mark.parametrize("window", [4, 6])
def test_kernel_plain_version_matches_jax_kernel(window):
    """track_scan_reference (exact per-sample carrier) vs the JAX Pallas
    kernel in interpret mode (cached carrier ramp): both use the
    polynomial Costas discriminator."""
    epochs, table, cp0, dop0 = _setup(90 if window == 4 else 60)
    u2 = upsampled_code_doubled(table)
    jcfg = _jax_cfg(pll_check_window=window, pll_bad_state_threshold=10**6)
    st_ref, out_ref = track_block_pallas(
        j_init_state(len(PRNS), cp0, dop0, window=window),
        jnp.asarray(epochs), jnp.asarray(u2), PLAN, jcfg, interpret=True)
    cfg = _torch_cfg(pll_check_window=window, in_kernel_scan=True,
                     pll_bad_state_threshold=10**6)
    calls = ts.track_scan_reference.calls
    st, out = track_block(init_state(len(PRNS), cp0, dop0, window=window,
                                     device="cpu"),
                          torch.as_tensor(epochs), torch.as_tensor(u2),
                          T_PLAN, cfg)
    assert ts.track_scan_reference.calls == calls + 1
    _assert_outputs_match(out_ref, out)
    _assert_states_match(st_ref, st)


def _kicked(doppler_out, acq_doppler):
    """(T, C) bool: epochs whose Doppler output is the false-lock kick
    target acq + (u - 0.5) * 500, u = LCG(epoch * 37 + channel)."""
    t_cnt, c_cnt = doppler_out.shape
    seed = np.arange(t_cnt)[:, None] * 37 + np.arange(c_cnt)[None, :]
    u = _lcg_uniform(torch.as_tensor(seed)).numpy()
    target = np.float32(acq_doppler)[None, :] + (u - 0.5) * 500.0
    return np.abs(np.asarray(doppler_out) - target) < 1e-3


# the kick needs the bad-window counter to reach 10: an 8-epoch window
# of noise signs is "bad" (>1 transition) 94% of the time, so the first
# kicks land after ~100 epochs
KICK = dict(pll_bad_state_threshold=0, pll_check_window=8)
KICK_EPOCHS = 160


def test_kernel_plain_version_watchdog_kick_matches_jax():
    """Channels started 300 chips off the signal track noise, and a zero
    kick threshold fires the false-lock LCG kick: the kick epochs and
    every watchdog and bit-sync integer must match the JAX kernel
    exactly."""
    epochs, table, cp0, dop0 = _setup(KICK_EPOCHS, cp_off=300.0)
    u2 = upsampled_code_doubled(table)
    st_ref, out_ref = track_block_pallas(
        j_init_state(len(PRNS), cp0, dop0, window=8), jnp.asarray(epochs),
        jnp.asarray(u2), PLAN, _jax_cfg(**KICK), interpret=True)
    ps, raw = ts.track_scan_reference(
        ts.state_from_track_state(init_state(len(PRNS), cp0, dop0,
                                             window=8, device="cpu")),
        torch.as_tensor(epochs), torch.as_tensor(u2), T_PLAN,
        _torch_cfg(**KICK))
    st = ts.state_to_track_state(ps)
    kicked = _kicked(out_ref.doppler_hz, dop0)
    assert kicked.any(), "the watchdog kick never fired"
    np.testing.assert_array_equal(_kicked(raw[:, 3], dop0), kicked)
    for f in ("pll_bad_cnt", "pll_bad_master_cnt", "ip_sign_window",
              "prev_ip_sign", "right_period_cnt", "last_swap_epoch",
              "period_sync_ok", "epoch_idx"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st, f)).astype(np.int32),
            np.asarray(getattr(st_ref, f)).astype(np.int32), err_msg=f)


@pytest.mark.parametrize("split", [40, 44])
def test_kernel_plain_version_split_equals_full(split):
    """Two calls carrying the ScanState == one 80-epoch call, exactly."""
    epochs, table, cp0, dop0 = _setup(80, seed=5, cp_off=0.0, dop_off=0.0)
    u2 = torch.as_tensor(upsampled_code_doubled(table))
    x = torch.as_tensor(epochs)
    cfg = _torch_cfg(pll_bad_state_threshold=10**6)
    ps0 = ts.state_from_track_state(init_state(len(PRNS), cp0, dop0,
                                                device="cpu"))
    ps_f, out_f = ts.track_scan_reference(ps0, x, u2, T_PLAN, cfg)
    ps_a, out_a = ts.track_scan_reference(ps0, x[:split], u2, T_PLAN, cfg)
    ps_b, out_b = ts.track_scan_reference(ps_a, x[split:], u2, T_PLAN, cfg)
    assert torch.equal(out_f, torch.cat([out_a, out_b]))
    for a, b in zip(ps_f, ps_b):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kick", [False, True], ids=["signal", "kick"])
def test_host_build_matches_plain_version(kick):
    """The CUDA source's arithmetic (track_epoch.cuh) built with g++ and
    run serially in the kernel's summation order, against the plain torch
    version: exact integer decisions and state; floats to the order of
    the 2046-sample float32 sums."""
    n = KICK_EPOCHS if kick else 90
    epochs, table, cp0, dop0 = _setup(n, cp_off=300.0 if kick else 0.1)
    u2 = torch.as_tensor(upsampled_code_doubled(table))
    x = torch.as_tensor(epochs)
    cfg = (_torch_cfg(**KICK) if kick
           else _torch_cfg(pll_bad_state_threshold=10**6))
    w = cfg.pll_check_window
    ps0 = ts.state_from_track_state(
        init_state(len(PRNS), cp0, dop0, window=w, device="cpu"))
    ps_h, out_h = ts.track_scan_host(ps0, x, u2, T_PLAN, cfg)
    ps_r, out_r = ts.track_scan_reference(ps0, x, u2, T_PLAN, cfg)
    assert torch.equal(ps_h.i32, ps_r.i32)
    assert torch.equal(ps_h.win, ps_r.win)
    for slot in (4, 5, 6, 7, 9):        # integer decision slots
        assert torch.equal(out_h[:, slot], out_r[:, slot]), slot
    np.testing.assert_allclose(out_h[:, :2].numpy(), out_r[:, :2].numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(out_h[:, 2].numpy(), out_r[:, 2].numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(out_h[:, 3].numpy(), out_r[:, 3].numpy(),
                               atol=1e-2)
    if kick:
        kicked = _kicked(out_r[:, 3], dop0)
        assert kicked.any(), "the watchdog kick never fired"
        np.testing.assert_array_equal(_kicked(out_h[:, 3], dop0), kicked)
    else:
        assert out_r[:, 4].any(), "scenario never produced a nav bit"


def test_lcg_bit_exact():
    seed = (np.arange(0, 200_000, 7)[:, None] * 37
            + np.arange(32)[None, :]).astype(np.int32)
    want = np.asarray(j_lcg(jnp.asarray(seed)))
    got = _lcg_uniform(torch.as_tensor(seed)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scan_state_pack_roundtrip_and_convert():
    st0 = init_state(8, np.linspace(0, 1000, 8), np.linspace(-4e3, 4e3, 8),
                     device="cpu")
    st1 = ts.state_to_track_state(ts.state_from_track_state(st0))
    for f in st0._fields:
        assert torch.equal(getattr(st0, f), getattr(st1, f)), f
    # the JAX package's state and kernel planes convert to the port's
    jst = j_init_state(8, np.linspace(0, 1000, 8), np.linspace(-4e3, 4e3, 8))
    pst = convert.track_state_from_numpy([np.asarray(v) for v in jst],
                                         device="cpu")
    for f in st0._fields:
        assert torch.equal(getattr(pst, f), getattr(st0, f)), f
        np.testing.assert_array_equal(convert.track_state_to_numpy(pst)[f],
                                      np.asarray(getattr(jst, f)))
    jps = j_state_from_track_state(jst)
    ps = convert.scan_state_from_jax(jps.f32, jps.i32, jps.win,
                                     device="cpu")
    want = ts.state_from_track_state(st0)
    for a, b in zip(ps, want):
        assert torch.equal(a, b)


def test_track_block_dispatch_by_device():
    """in_kernel_scan=None resolves to the reference scan on the CPU;
    True runs the kernel's plain version there."""
    epochs, table, cp0, dop0 = _setup(8)
    x = torch.as_tensor(epochs)
    st = init_state(len(PRNS), cp0, dop0, device="cpu")
    calls = ts.track_scan_reference.calls
    track_block(st, x, torch.as_tensor(table), T_PLAN, _torch_cfg())
    assert ts.track_scan_reference.calls == calls
    track_block(st, x, torch.as_tensor(upsampled_code_doubled(table)),
                T_PLAN, _torch_cfg(in_kernel_scan=True))
    assert ts.track_scan_reference.calls == calls + 1


# K1's modes beyond the default loop (pallas_track_scan.py :613-622,
# :660-712, :738-745, :774-775, :791-794, :834-835)
MODES = {
    "coherent_bit_vote": dict(coherent_bit_vote=True),
    "coherent_pll": dict(coherent_pll=True),
    "coherent_pll_ext4": dict(coherent_pll=True, pll_ext_bits=4),
    "emit_correlators": dict(emit_correlators=True),
}
MODE_EPOCHS = 90      # tests/test_pallas_scan.py _run_both's size


def _assert_mode_exercised(mode, st_ref, out_ref):
    """The scenario must reach the branch the mode adds."""
    if mode == "coherent_pll_ext4":
        assert np.asarray(st_ref.ext_bit_cnt).max() > 0
    if mode != "emit_correlators":
        assert np.asarray(out_ref.period_sync_ok).any(), "never synced"


def _assert_el_match(out_ref, out):
    """E/L diagnostics under the I/Q tolerance of _assert_outputs_match."""
    for f in ("ie", "qe", "il", "ql"):
        want = np.asarray(getattr(out_ref, f))
        assert want.shape == (MODE_EPOCHS, len(PRNS)), f
        np.testing.assert_allclose(np.asarray(getattr(out, f)), want,
                                   rtol=2e-2, atol=2.0, err_msg=f)


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_plain_version_mode_matches_jax_kernel(mode):
    """track_scan_reference in each of K1's other modes against the JAX
    Pallas kernel in interpret mode in the same mode, on
    test_pallas_scan's 8-channel scenario, with its tolerances."""
    change = MODES[mode]
    epochs, table, cp0, dop0 = _setup(MODE_EPOCHS)
    u2 = upsampled_code_doubled(table)
    jcfg = _jax_cfg(pll_bad_state_threshold=10**6, **change)
    st_ref, out_ref = track_block_pallas(
        j_init_state(len(PRNS), cp0, dop0), jnp.asarray(epochs),
        jnp.asarray(u2), PLAN, jcfg, interpret=True)
    cfg = _torch_cfg(in_kernel_scan=True, pll_bad_state_threshold=10**6,
                     **change)
    calls = ts.track_scan_reference.calls
    st, out = track_block(init_state(len(PRNS), cp0, dop0, device="cpu"),
                          torch.as_tensor(epochs), torch.as_tensor(u2),
                          T_PLAN, cfg)
    assert ts.track_scan_reference.calls == calls + 1
    _assert_outputs_match(out_ref, out)
    _assert_states_match(st_ref, st)
    _assert_mode_exercised(mode, st_ref, out_ref)
    if mode == "emit_correlators":
        _assert_el_match(out_ref, out)


@pytest.mark.parametrize("mode", list(MODES))
def test_track_block_mode_matches_jax(mode):
    """The per-epoch reference scan (fractional replica, atan2 Costas on
    both sides) in each mode against the JAX track_block."""
    change = MODES[mode]
    epochs, table, cp0, dop0 = _setup(MODE_EPOCHS)
    st_ref, out_ref = j_track_block(
        j_init_state(len(PRNS), cp0, dop0), jnp.asarray(epochs),
        jnp.asarray(table), PLAN,
        _jax_cfg(pll_bad_state_threshold=10**6, **change))
    st, out = track_block(init_state(len(PRNS), cp0, dop0, device="cpu"),
                          torch.as_tensor(epochs), torch.as_tensor(table),
                          T_PLAN,
                          _torch_cfg(pll_bad_state_threshold=10**6, **change))
    _assert_outputs_match(out_ref, out)
    _assert_states_match(st_ref, st)
    _assert_mode_exercised(mode, st_ref, out_ref)
    if mode == "emit_correlators":
        _assert_el_match(out_ref, out)


@pytest.mark.parametrize("mode", list(MODES))
def test_host_build_mode_matches_plain_version(mode):
    """The g++ build of track_epoch.cuh against the plain version in each
    mode: integer decisions, integer state and the watchdog window
    exactly; the floats (E/L slots included) to the order of the
    2046-sample float32 sums."""
    epochs, table, cp0, dop0 = _setup(MODE_EPOCHS)
    u2 = torch.as_tensor(upsampled_code_doubled(table))
    cfg = _torch_cfg(pll_bad_state_threshold=10**6, **MODES[mode])
    ps0 = ts.state_from_track_state(init_state(len(PRNS), cp0, dop0,
                                                device="cpu"))
    x = torch.as_tensor(epochs)
    ps_h, out_h = ts.track_scan_host(ps0, x, u2, T_PLAN, cfg)
    ps_r, out_r = ts.track_scan_reference(ps0, x, u2, T_PLAN, cfg)
    assert out_h.shape == out_r.shape == (MODE_EPOCHS, ts._nout(cfg),
                                          len(PRNS))
    assert torch.equal(ps_h.i32, ps_r.i32)
    assert torch.equal(ps_h.win, ps_r.win)
    for slot in (4, 5, 6, 7, 9):        # integer decision slots
        assert torch.equal(out_h[:, slot], out_r[:, slot]), slot
    float_slots = [0, 1] + list(range(ts.NOUT, out_r.shape[1]))
    np.testing.assert_allclose(out_h[:, float_slots].numpy(),
                               out_r[:, float_slots].numpy(),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(out_h[:, 3].numpy(), out_r[:, 3].numpy(),
                               atol=1e-2)
    # the K-bit accumulators add whole-bit sums of either sign: their
    # error follows the terms, not the total (test_pallas_scan's bound)
    np.testing.assert_allclose(ps_h.f32[14:].numpy(), ps_r.f32[14:].numpy(),
                               rtol=2e-2, atol=10.0)
    assert out_r[:, 4].any(), "scenario never produced a nav bit"
    if mode == "coherent_pll_ext4":
        assert ps_r.i32[13].max() > 0 or ps_r.f32[14].abs().max() > 0


def test_upsampled_code_matches_jax():
    table = ca_table_bipolar(list(range(1, 33)))
    np.testing.assert_array_equal(upsampled_code_doubled(table),
                                  j_upsampled(table))


def _watchdog_array_step(win, sgn, hold):
    """The watchdog window's array loop as track_epoch.cuh ran it before
    the masks (and as track_scan_reference runs it): win (W, n) with row
    W-1 newest; returns the transition counts and the window after."""
    w_len = win.shape[0]
    trans = (sgn != win[w_len - 1]).astype(np.int32)
    for k in range(2, w_len):
        trans += (win[k] != win[k - 1]).astype(np.int32)
    shifted = np.concatenate([win[1:], sgn[None]], axis=0)
    return trans, np.where(hold[None], win, shifted)


@pytest.mark.parametrize("window", range(2, 33))
def test_watchdog_masks_match_array_loop(window):
    """The kernel's watchdog on two bit masks (load_state packs the (W, C)
    plane, watchdog_step counts and shifts, store_state unpacks) against
    the array loop, exactly: seeded windows of +-1, windows still filling
    (0 entries, as init_state leaves them), the all-zero start, both signs,
    hold on and off."""
    from stm32f4_sdr_gps_torch.ops.kernel_lib import host_lib

    rng = np.random.default_rng(window)
    n = 96
    win = rng.choice([-1, 1], size=(window, n)).astype(np.int32)
    filling = rng.choice([-1, 0, 1], size=(window, n)).astype(np.int32)
    win[:, n // 2:] = filling[:, n // 2:]
    win[:, -4:] = 0
    for j, fill in enumerate(range(1, window)):   # a filled suffix only
        win[:fill, j % (n // 2)] = 0
    sgn = rng.choice([-1, 1], size=n).astype(np.int32)
    hold = (np.arange(n) % 3 == 0).astype(np.int32)
    want_trans, want_win = _watchdog_array_step(win, sgn, hold.astype(bool))
    got_win = np.ascontiguousarray(win.copy())
    got_trans = np.zeros(n, np.int32)
    rc = host_lib().watchdog_host(got_win.ctypes.data, sgn.ctypes.data,
                                  hold.ctypes.data, got_trans.ctypes.data,
                                  window, n)
    assert rc == 0
    np.testing.assert_array_equal(got_trans, want_trans)
    np.testing.assert_array_equal(got_win, want_win)
    # held windows went through the packing and back unchanged
    np.testing.assert_array_equal(got_win[:, hold == 1], win[:, hold == 1])


# (channels, SMs) -> channels per block; 128 threads a channel (K1_THREADS)
# and 512 a block allow 4 per block
@pytest.mark.parametrize("c,sms,want", [
    (1, 132, 1), (4, 132, 1), (32, 132, 1), (131, 132, 1), (132, 132, 1),
    (133, 132, 2), (256, 132, 2), (264, 132, 2), (265, 132, 3),
    (528, 132, 4), (529, 132, 4), (1000, 132, 4), (114, 114, 1),
    (115, 114, 2),
])
def test_channels_per_block(c, sms, want):
    """The launcher's channels per block: one while the channels fit on
    the SMs, more past the SM count, never more than a block holds."""
    from stm32f4_sdr_gps_torch.ops.kernel_lib import host_lib

    g = host_lib().k1_channels_per_block(c, sms)
    assert g == want
    if c <= 4 * sms:
        assert -(-c // g) <= sms            # every block on an SM of its own


def test_code_phase_mod_is_float_mod():
    """The kernel's fast code-phase wrap gives float_mod's (fmodf's)
    result bit for bit: around 0, 1023, 2046 and 3069 ulp by ulp, on
    seeded values across and beyond its fast range, and on -0, inf and
    NaN."""
    from stm32f4_sdr_gps_torch.ops.kernel_lib import host_lib

    rng = np.random.default_rng(3)
    edges = [np.nextafter(np.float32(e), np.float32(d * np.inf))
             for e in (0.0, 1023.0, 2046.0, 3069.0) for d in (-1, 1)]
    around = np.concatenate([
        e + np.arange(-64, 65, dtype=np.float32) * np.spacing(e)
        for e in np.float32([1e-3, 1023.0, 2046.0, 3069.0])])
    a = np.concatenate([
        np.float32(edges), around,
        rng.uniform(-5000, 8000, 20000).astype(np.float32),
        rng.uniform(1020, 2050, 20000).astype(np.float32),
        np.float32([0.0, -0.0, 1023.0, 2046.0, 3069.0, np.inf, -np.inf,
                    np.nan, 1e30, -1e-30])]).astype(np.float32)
    fast = np.empty_like(a)
    full = np.empty_like(a)
    assert host_lib().code_phase_mod_host(a.ctypes.data, fast.ctypes.data,
                                          full.ctypes.data, a.size) == 0
    np.testing.assert_array_equal(fast.view(np.int32)[~np.isnan(full)],
                                  full.view(np.int32)[~np.isnan(full)])
    assert np.array_equal(np.isnan(fast), np.isnan(full))
