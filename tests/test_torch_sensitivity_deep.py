"""The deep chain's sensitivity claims on the port, against the JAX
package, on the CPU:

* ``probes.sensitivity.ultra_acq_28`` (tests/test_sensitivity.py:136-162):
  the bar on the port, and each of its three acquisitions against the
  JAX package's ``acquire`` on the same capture (detection flags equal,
  Doppler within one bin, code phase within 0.01 chip, peak ratio within
  2 %, tests/test_torch_acquire_modes.py:159-164);
* ``probes.ext_pll`` at 25 dBHz on seed 42, the ext loop
  (``DEEP_COHERENT_TRACK``) on the port's reference scan against the JAX
  one (tools/ext_pll_tune.py): equal bit errors and decided bits, the
  scans matched with the tolerances of tests/test_pallas_scan.py:68-117
  and exact integer decisions (tests/test_torch_dynamics.py::
  assert_scan_match; no part);
* (RUN_SLOW) ``probes.deep_cold``: the 29 dBHz cold start
  (tests/test_e2e_slow.py:70-90) on the port's reference scan and on the
  kernel's plain version, on the three seeds chip_smoke.py runs through
  K1: its bar (``check_fix``) on seeds 21 and 7, and on seed 42 the miss
  that ``KNOWN_MISS`` names; the JAX package's Pallas kernel on the two
  seeds where it makes no fix; and where on seed 42 the port's reference
  scan parts from the JAX one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu import config as jcfg
from stm32f4_sdr_gps_tpu.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.probes import deep_cold, ext_pll
from stm32f4_sdr_gps_torch.probes import sensitivity as sens
from tests.test_torch_dynamics import assert_scan_match, half_chip_marginal
from tests.test_torch_sensitivity import J_PLAN, _same_acq

torch.set_num_threads(2)

slow = pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                          reason="set RUN_SLOW=1 to run")


def test_ultra_acq_28():
    rec = sens.ultra_acq_28("cpu")
    x, noise = sens.ultra_acq_28_captures()
    _same_acq(rec["ultra"], x, 17, sens.ULTRA_2K)
    _same_acq(rec["deep"], x, 17, sens.DEEP_2K)
    _same_acq(rec["noise"], noise, 17, sens.ULTRA_2K)


def test_ext_pll_point_matches_jax():
    """tools/ext_pll_tune.py's ext loop at 25 dBHz on seed 42: the port's
    reference scan against the JAX one, equal bit errors and bits."""
    x, bits = ext_pll.capture(25.0, 42)
    errs, n, dop, st, outs = ext_pll.run(ext_pll.DEEP_COHERENT_TRACK, x,
                                         bits, "cpu")
    st0 = j_init_state(1, np.array([0.0]), np.array([ext_pll.DOPPLER_HZ]))
    st0 = st0._replace(period_sync_ok=jnp.ones(1, bool),
                       right_period_cnt=jnp.full((1,), 10, jnp.int32))
    st_ref, out_ref = j_track_block(
        st0, jnp.asarray(x.reshape(-1, 2046)),
        jnp.asarray(ca_table_bipolar([ext_pll.PRN])), J_PLAN,
        jcfg.DEEP_COHERENT_TRACK)
    assert assert_scan_match(out_ref, outs, st_ref, st) == {}
    ready = np.asarray(out_ref.bit_ready)[:, 0]
    vals = np.asarray(out_ref.bit_value)[:, 0][ready]
    eps = np.asarray(out_ref.bit_epoch)[:, 0][ready].astype(int)
    planted = np.array([bits[e // ext_pll.CIB] for e in eps])
    j_errs = min(int(np.sum(vals != planted)),
                 int(np.sum((1 - vals) != planted)))
    assert (errs, n) == (j_errs, len(vals))
    assert n >= 70 and errs <= 1 and dop < 1.0


def _deep_cold_cpu(seed, kernel_plain):
    """The deep chain at 29 dBHz on the port on the CPU: on its reference
    scan (the CPU default) or on the tracking-scan kernel's plain version
    (the card's arithmetic); weak_chain.run_once's record."""
    from stm32f4_sdr_gps_torch.probes.weak_chain import run_once

    sc = deep_cold.scenario(29.0, seed)
    cfg = deep_cold.config(tuple(sc.prns))
    if kernel_plain:
        cfg = cfg.replace(track=dataclasses.replace(cfg.track,
                                                    in_kernel_scan=True))
    return run_once(sc, cfg, "cpu")


PIPELINES = pytest.mark.parametrize("kernel_plain", [False, True],
                                    ids=["reference_scan", "kernel_plain"])


@slow
@PIPELINES
@pytest.mark.parametrize("seed", [21, 7])
def test_deep_cold_start_29dbhz(seed, kernel_plain):
    """tests/test_e2e_slow.py::test_weak_signal_cold_start_to_fix_29dbhz's
    chain and bar (``deep_cold.check_fix``) on the port's CPU pipelines,
    on seed 21 (chip_smoke.py's phase 12) and seed 7 (phase 25; the card
    misses there, deep_cold.KNOWN_MISS)."""
    deep_cold.check_fix(_deep_cold_cpu(seed, kernel_plain))


@slow
@PIPELINES
def test_deep_cold_29dbhz_seed42_miss(kernel_plain):
    """Seed 42 of chip_smoke.py's phase 25 misses the bar on the port's CPU
    pipelines as on the card, and exactly as deep_cold.KNOWN_MISS says:
    no fix, PRN 15 short of a full set with no subframe, every channel bit
    synced.  The port's reference scan parts from the JAX one, which fixes,
    at a half-chip cell (test_deep_cold_seed42_parts_at_a_marginal_cell)."""
    rec = _deep_cold_cpu(42, kernel_plain)
    with pytest.raises(deep_cold.DeepColdError):
        deep_cold.check_fix(rec)
    assert deep_cold.check_outcome(rec, 42) == "known miss"


# The JAX package's Pallas kernel (interpret mode, on its digest path) on
# the deep chain at 29 dBHz: no fix, every channel bit synced, PRN 7 short
# of a full set with this ephemeris mask and these subframes; every other
# set full.  (Its reference scan, tools/deep_cold_probe.py, fixes at
# 259.9 m on seed 7 and 194.1 m on seed 42.)
JAX_KERNEL_MISS = {7: (7, 0, 0), 42: (7, 8, 1)}


@slow
@pytest.mark.parametrize("seed", sorted(JAX_KERNEL_MISS))
def test_deep_cold_29dbhz_jax_kernel_misses(seed):
    """The deep chain at 29 dBHz through the JAX package's own Pallas
    kernel: it makes no fix on seeds 7 and 42 (JAX_KERNEL_MISS)."""
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver

    sc = deep_cold.scenario(29.0, seed)
    track = dataclasses.replace(jcfg.DEEP_COHERENT_TRACK,
                                in_kernel_scan=True, pallas_interpret=True)
    report = JReceiver(jcfg.ReceiverConfig(
        prns=tuple(sc.prns), acq=jcfg.ULTRA_ACQ, track=track,
        track_block_epochs=1000)).run(sc.samples)
    short = [(ch.prn, ch.eph.received_mask_proc, ch.subframe_count)
             for ch in report.channels if not ch.eph.has_full_set]
    assert short == [JAX_KERNEL_MISS[seed]], short
    assert all(ch.bit_synced for ch in report.channels)
    assert not report.solutions


@slow
def test_deep_cold_seed42_parts_at_a_marginal_cell():
    """The first five tracking blocks of the 29 dBHz deep chain on seed 42
    in both packages (reference scans, full readback): the channels agree
    under test_pallas_scan's tolerances until PRN 15 (channel 2) parts at
    epoch 362 of the block entered at epoch 3120, where its code phase
    sits at 632.5006 chip in the JAX scan and 632.5007 in the port's and
    the code Doppler sweeps the epoch's samples across a half-chip
    boundary: the two replicas put a sample in neighbouring cells."""
    from stm32f4_sdr_gps_tpu.runtime import receiver as j_receiver
    from stm32f4_sdr_gps_torch.runtime import receiver as t_receiver

    sc = deep_cold.scenario(29.0, 42)
    x = sc.samples[: 4200 * 2046]
    runs = {}
    for name, mod, rx in (
            ("jax", j_receiver, j_receiver.Receiver(jcfg.ReceiverConfig(
                prns=tuple(sc.prns), acq=jcfg.ULTRA_ACQ,
                track=jcfg.DEEP_COHERENT_TRACK, track_block_epochs=1000,
                device_digest=False))),
            ("port", t_receiver, t_receiver.Receiver(
                deep_cold.config(tuple(sc.prns)).replace(
                    device_digest=False), device="cpu"))):
        blocks = runs[name] = []
        orig = mod.track_block

        def hook(state, epochs, table, plan, cfg, orig=orig, blocks=blocks):
            st, outs = orig(state, epochs, table, plan, cfg)
            blocks.append((int(np.asarray(state.epoch_idx)[0]),
                           type(outs)(*(np.asarray(v) for v in outs))))
            return st, outs

        mod.track_block = hook
        try:
            rx.run(x)
        finally:
            mod.track_block = orig
    assert [e for e, _ in runs["jax"]] == [e for e, _ in runs["port"]]
    parts = {}
    for (e, out_ref), (_, out) in zip(runs["jax"][:4], runs["port"][:4]):
        parts[e] = assert_scan_match(out_ref, out)
    assert parts == {120: {}, 1120: {}, 2120: {}, 3120: {2: 362}}, parts
    a, b = runs["jax"][3][1], runs["port"][3][1]
    cell = half_chip_marginal(
        a.code_phase_chips.astype(np.float64),
        b.code_phase_chips.astype(np.float64), a.doppler_hz, b.doppler_hz)
    assert cell[362, 2], (a.code_phase_chips[362, 2],
                          b.code_phase_chips[362, 2])
