"""The port's tracking scans against the JAX package's, on the CPU.

* ``track.scan.track_block`` in both replica modes (fractional phase and
  half-chip) against the JAX ``track_block``;
* the tracking-scan kernel's plain version (``track_scan_reference``)
  against the JAX Pallas kernel K1 in interpret mode;
* the host build of the CUDA kernel's arithmetic against the plain
  version, with exact integer decisions.

Same scenario and tolerance helpers as tests/test_pallas_scan.py.  Inputs
go to both packages as numpy arrays.
"""

import dataclasses

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
    st, out = track_block(init_state(len(PRNS), cp0, dop0),
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
    st, out = track_block(init_state(len(PRNS), cp0, dop0, window=window),
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
                                             window=8)),
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
    ps0 = ts.state_from_track_state(init_state(len(PRNS), cp0, dop0))
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
        init_state(len(PRNS), cp0, dop0, window=w))
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
    st0 = init_state(8, np.linspace(0, 1000, 8), np.linspace(-4e3, 4e3, 8))
    st1 = ts.state_to_track_state(ts.state_from_track_state(st0))
    for f in st0._fields:
        assert torch.equal(getattr(st0, f), getattr(st1, f)), f
    # the JAX package's state and kernel planes convert to the port's
    jst = j_init_state(8, np.linspace(0, 1000, 8), np.linspace(-4e3, 4e3, 8))
    pst = convert.track_state_from_numpy([np.asarray(v) for v in jst])
    for f in st0._fields:
        assert torch.equal(getattr(pst, f), getattr(st0, f)), f
        np.testing.assert_array_equal(convert.track_state_to_numpy(pst)[f],
                                      np.asarray(getattr(jst, f)))
    jps = j_state_from_track_state(jst)
    ps = convert.scan_state_from_jax(jps.f32, jps.i32, jps.win)
    want = ts.state_from_track_state(st0)
    for a, b in zip(ps, want):
        assert torch.equal(a, b)


def test_track_block_dispatch_by_device():
    """in_kernel_scan=None resolves to the reference scan on the CPU;
    True runs the kernel's plain version there."""
    epochs, table, cp0, dop0 = _setup(8)
    x = torch.as_tensor(epochs)
    st = init_state(len(PRNS), cp0, dop0)
    calls = ts.track_scan_reference.calls
    track_block(st, x, torch.as_tensor(table), T_PLAN, _torch_cfg())
    assert ts.track_scan_reference.calls == calls
    track_block(st, x, torch.as_tensor(upsampled_code_doubled(table)),
                T_PLAN, _torch_cfg(in_kernel_scan=True))
    assert ts.track_scan_reference.calls == calls + 1


@pytest.mark.parametrize("change", [
    dict(coherent_pll=True), dict(coherent_bit_vote=True),
    dict(pll_ext_bits=4), dict(emit_correlators=True)])
def test_unported_modes_raise(change):
    epochs, table, cp0, dop0 = _setup(4)
    st = init_state(len(PRNS), cp0, dop0)
    cfg = dataclasses.replace(_torch_cfg(in_kernel_scan=True), **change)
    with pytest.raises(NotImplementedError):
        track_block(st, torch.as_tensor(epochs),
                    torch.as_tensor(upsampled_code_doubled(table)),
                    T_PLAN, cfg)


def test_upsampled_code_matches_jax():
    table = ca_table_bipolar(list(range(1, 33)))
    np.testing.assert_array_equal(upsampled_code_doubled(table),
                                  j_upsampled(table))
