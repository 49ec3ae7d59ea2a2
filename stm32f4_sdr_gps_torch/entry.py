"""Entry points (counterparts of the JAX package's ``__graft_entry__``).

* :func:`entry` — one block of the port's per-block production program:
  32 channels x 96 epochs through the tracking scan (the kernel on a
  CUDA device, its plain version on the CPU) carrying its own kernel
  state, followed by the on-device block digest — the program
  ``Receiver.process_block`` runs per block
  (runtime.receiver._track_and_digest_carried; on the card one captured
  CUDA graph, utils.graphs).
* :func:`entry_jnp_scan` — the reference backend as an explicit variant:
  32 channels x 100 epochs through the fractional-phase reference scan
  (``TrackConfig(in_kernel_scan=False)``, the same math without the
  kernel; on the card the epoch step is a captured graph replayed once
  an epoch).
* :func:`dryrun_multichip` — the whole sharded step on an n-position
  mesh over one device repeated: sharded acquisition, the halo, the
  channel-sharded reference scan and tracking-scan kernel, and the
  MeshReceiver to a fix held to the single-process Receiver.

All three run on the card unless the caller asks for the CPU, and raise
where there is no card.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import BASEBAND_PLAN, TrackConfig
from .ops.epl import code_rows
from .ops.track_scan import state_from_track_state
from .runtime.receiver import _track_and_digest_carried
from .track.scan import track_block
from .track.state import init_state
from .utils.device import card_or_cpu


def _setup(num_channels: int, num_epochs: int, cfg: TrackConfig, device):
    """(state, epochs, prns) made from seed 0 on ``device``, drawn in the
    JAX package's order: the noise epochs, then the code phases, then the
    Dopplers."""
    s = BASEBAND_PLAN.samples_per_epoch
    rng = np.random.default_rng(0)
    epochs = torch.as_tensor(
        (rng.standard_normal((num_epochs, s))
         + 1j * rng.standard_normal((num_epochs, s))).astype(np.complex64),
        device=device)
    state = init_state(
        num_channels,
        rng.uniform(0, 1023, num_channels),
        rng.uniform(-5000, 5000, num_channels),
        window=cfg.pll_check_window,
        device=device,
    )
    return state, epochs, [(i % 32) + 1 for i in range(num_channels)]


def entry(device="cuda", num_channels: int = 32, num_epochs: int = 96):
    """(fn, example_args): ``fn(ps, epochs, u2) -> (ps2, track_state,
    digest)`` with the arguments made from seed 0 on ``device``."""
    device = card_or_cpu(device, "entry")
    plan = BASEBAND_PLAN
    cfg = TrackConfig(in_kernel_scan=True)
    state, epochs, prns = _setup(num_channels, num_epochs, cfg, device)
    u2 = code_rows(tuple(prns), True, str(device))

    def fn(ps, epochs, u2):
        return _track_and_digest_carried(ps, epochs, u2, plan, cfg, 100, True)

    return fn, (state_from_track_state(state), epochs, u2)


def entry_jnp_scan(device="cuda", num_channels: int = 32,
                   num_epochs: int = 100):
    """(fn, example_args): ``fn(state, epochs, table) -> (new_state,
    outputs)``, ``track_block`` through the reference scan (explicitly
    ``in_kernel_scan=False``, which the card would otherwise route to the
    kernel), with the arguments made from seed 0 on ``device``."""
    device = card_or_cpu(device, "entry_jnp_scan")
    plan = BASEBAND_PLAN
    cfg = TrackConfig(in_kernel_scan=False)
    state, epochs, prns = _setup(num_channels, num_epochs, cfg, device)
    table = code_rows(tuple(prns), False, str(device))

    def fn(state, epochs, table):
        return track_block(state, epochs, table, plan, cfg)

    return fn, (state, epochs, table)


def dryrun_multichip(n_shards: int, device="cuda") -> dict:
    """Run the full sharded step on an ``n_shards``-position (time, chan)
    mesh whose positions all name ``device`` (the counterpart of the JAX
    package's ``__graft_entry__.dryrun_multichip``, in its order):
    sharded acquisition, the overlap-save halo, the channel-sharded
    reference scan, the tracking-scan kernel once a position through
    StreamingTracker, and the MeshReceiver on a compressed-bit
    fix_scenario with injected ephemerides held to the single-process
    Receiver on the same device (equal subframe ledgers, fixes within
    100 m).  Prints the agreement and returns it with the two receivers'
    reports; raises RuntimeError where a check fails."""
    import copy
    import dataclasses

    from .acquire.engine import acquisition_power
    from .config import AcqConfig, ReceiverConfig
    from .ops.correlate import code_fft_conj
    from .ops.wipeoff import doppler_rotations
    from .parallel.mesh import (halo_extend_blocks, make_mesh,
                                sharded_acquisition_power)
    from .parallel.streaming import StreamingTracker
    from .runtime.mesh_receiver import MeshReceiver
    from .runtime.receiver import Receiver
    from .signal.scenarios import fix_scenario

    device = card_or_cpu(device, "dryrun_multichip")
    time_ax = 2 if n_shards % 2 == 0 and n_shards > 1 else 1
    mesh = make_mesh(time=time_ax, chan=n_shards // time_ax,
                     devices=[device] * n_shards)
    plan = BASEBAND_PLAN
    s = plan.samples_per_epoch
    rng = np.random.default_rng(1)

    # ---- acquisition: PRNs over chan, epochs over time ------------------
    n_prns = 2 * mesh.shape["chan"]
    n_epochs = 2 * mesh.shape["time"]
    cfc = code_fft_conj(list(range(1, n_prns + 1)), plan, device=device)
    rot = doppler_rotations(torch.as_tensor(
        np.asarray(AcqConfig().doppler_bins_hz[:4], dtype=np.float32),
        device=device), s, plan.sample_rate_hz)
    epochs = torch.as_tensor(
        (rng.standard_normal((n_epochs, s))
         + 1j * rng.standard_normal((n_epochs, s))).astype(np.complex64),
        device=device)
    power = sharded_acquisition_power(epochs, cfc, rot, mesh)
    _require(power.shape == (n_prns, 4, s), f"cube shape {power.shape}")
    acq_err = float(torch.max(torch.abs(
        power - acquisition_power(epochs, cfc, rot))) / torch.max(power))

    # ---- overlap-save halo over the time axis ---------------------------
    blocks = torch.as_tensor(rng.standard_normal(
        (2 * mesh.shape["time"], 64)).astype(np.float32), device=device)
    ext = halo_extend_blocks(blocks, 16, mesh)
    _require(ext.shape == (blocks.shape[0], 64 + 16)
             and torch.equal(ext[:-1, 64:], blocks[1:, :16]), "halo")

    # ---- tracking: channel axis sharded over the whole mesh -------------
    cfg = TrackConfig(in_kernel_scan=False)
    n_ch = 4 * n_shards
    tr = StreamingTracker(init_state(
        n_ch, rng.uniform(0, 1023, n_ch), rng.uniform(-5000, 5000, n_ch),
        device=device), code_rows(tuple((i % 32) + 1 for i in range(n_ch)),
                                  False, str(device)),
        mesh, plan, cfg)
    outs = tr.process(torch.as_tensor(
        (rng.standard_normal((3, s))
         + 1j * rng.standard_normal((3, s))).astype(np.complex64),
        device=device))
    _require(outs.ip.shape == (3, n_ch), f"outputs {outs.ip.shape}")

    # ---- the tracking-scan kernel, once a position ----------------------
    n_ch = n_shards
    cfg_ik = dataclasses.replace(cfg, in_kernel_scan=True)
    tr = StreamingTracker(init_state(
        n_ch, rng.uniform(0, 1023, n_ch), rng.uniform(-5000, 5000, n_ch),
        device=device), code_rows(tuple((i % 32) + 1 for i in range(n_ch)),
                                  True, str(device)),
        mesh, plan, cfg_ik)
    o = tr.process((rng.standard_normal(2 * s)
                    + 1j * rng.standard_normal(2 * s)).astype(np.complex64))
    _require(o.ip.shape == (2, n_ch), f"kernel outputs {o.ip.shape}")

    # ---- the MeshReceiver's digest-fed block loop to a FIX --------------
    # Compressed 3-epoch bits keep this cheap; their TOW labels advance
    # 6 s per 0.9 s of physics, so the absolute fix is km-scale by
    # construction (signal.scenarios.fix_scenario) and the plausibility
    # gates that would rightly reject it are off: the check here is
    # mesh-vs-single-process agreement.
    cib = 3
    sc = fix_scenario(num_epochs=2800, codes_in_bit=cib)
    cfg_rx = ReceiverConfig(
        prns=sc.prns,
        track=TrackConfig(codes_in_bit=cib, pll_bad_state_threshold=10**9),
        track_block_epochs=200,
        max_resid_rms_m=0.0, min_altitude_m=0.0, max_altitude_m=0.0,
        grid_fault_search=False,
    )

    def run_with_injected_eph(rx):
        # warm-start ephemerides (the boundary ledger still comes from
        # live subframe decode, which is what the fix timing needs)
        for ch in rx.channels:
            ch.eph = copy.deepcopy(sc.eph_map[ch.prn])
        return rx.run(sc.samples)

    rep_mesh = run_with_injected_eph(MeshReceiver(cfg_rx, mesh))
    rep_one = run_with_injected_eph(Receiver(cfg_rx, device=device))
    _require(rep_mesh.solutions, "mesh receiver produced no fix")
    _require(rep_one.solutions, "single-process receiver produced no fix")
    _require([ch.prn for ch in rep_mesh.channels]
             == [ch.prn for ch in rep_one.channels], "channel sets differ")
    for chm, ch1 in zip(rep_mesh.channels, rep_one.channels):
        _require(chm.subframe_count >= 1
                 and chm.subframe_time_ms == ch1.subframe_time_ms,
                 f"PRN {chm.prn}: {chm.subframe_count} subframes, ledger "
                 f"{chm.subframe_time_ms} vs {ch1.subframe_time_ms}")
    d_fix = float(np.linalg.norm(
        rep_mesh.solutions[-1].rr - rep_one.solutions[-1].rr))
    _require(d_fix < 100.0,
             f"mesh fix disagrees with single-process: {d_fix} m")
    print(f"dryrun_multichip OK on {n_shards} positions of {device} "
          f"(mesh time={mesh.shape['time']} chan={mesh.shape['chan']}; "
          f"sharded cube within {acq_err:.1e} of the single one; the "
          f"tracking-scan kernel once a position; MESH FIX from the "
          f"digest-fed MeshReceiver block loop: {len(rep_mesh.solutions)} "
          f"solutions, mesh-vs-single-process agreement {d_fix:.1f} m "
          f"over {rep_mesh.epochs_processed} epochs)")
    return {"positions": n_shards, "acq_rel_err": acq_err,
            "fix_agreement_m": d_fix, "solutions": len(rep_mesh.solutions),
            "epochs": rep_mesh.epochs_processed,
            "subframe_time_ms": [ch.subframe_time_ms
                                 for ch in rep_mesh.channels],
            "mesh_report": rep_mesh, "single_report": rep_one}


def _require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")
