"""Mesh-sharded streaming receiver (torch port of the JAX package's
runtime/mesh_receiver.py).

A :class:`~stm32f4_sdr_gps_torch.runtime.receiver.Receiver` whose device
stages run on a :class:`~stm32f4_sdr_gps_torch.parallel.mesh.Mesh`:

* acquisition shards PRNs over ``chan`` and epoch blocks over ``time``,
  merged in time-shard order (parallel.streaming.acquire_sharded);
* tracking keeps the channel axis sharded across every grid position
  with state resident between blocks (parallel.streaming.
  StreamingTracker), on either tracking path (the reference scan, or
  the tracking-scan kernel once a position a block);
* the device digest (runtime.digest) runs per position after its scan,
  so the default readback is the ~kB joined digest — full (T, C)
  readback only when correlator diagnostics need it (the same rule as
  the single-device Receiver);
* the aided bit sync and the dynamic channel-set operations
  (``maybe_reacquire`` / ``drop_dead_channels`` / ``warm_reset``) run
  the base Receiver logic on one TrackState gathered on the receiver's
  device, and shard the result back (with ghost-channel padding to a
  mesh multiple where the channel set changed).  ``track_state`` is
  gathered when it is read after a block (the aided sync where it acts,
  a checkpoint), in a ``gather`` stage of the profiler, not every
  block.

Host-side decode/PVT is unchanged.  This class is the one-process view
(one controller, N grid positions); runtime.multiprocess decodes per
process.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..acquire.engine import AcqResult
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.streaming import StreamingTracker, acquire_sharded
from ..track.state import TrackOutputs, TrackState, init_state
from .digest import digest_to_host
from .receiver import Receiver, handoff


class MeshReceiver(Receiver):
    """Receiver with mesh-sharded acquisition and tracking; its
    receiver-wide tensors live on the mesh's first device.  Without a
    ``mesh``, the visible cards (raises without one)."""

    def __init__(self, config, mesh: Optional[Mesh] = None):
        mesh = mesh if mesh is not None else make_mesh()
        super().__init__(config, device=mesh.devices[0])
        self.mesh = mesh
        self.tracker: Optional[StreamingTracker] = None
        self._n_live = 0
        self._gathered: Optional[TrackState] = None

    @property
    def track_state(self) -> Optional[TrackState]:
        """The tracker's state as one TrackState on the receiver's device,
        ghost rows included: the aided sync's input and the checkpoint
        alias.  Gathered from the positions when first read after a
        block."""
        if self._state_stale:
            with self.profiler.stage("gather").time():
                self._gathered = self.tracker.gather_state(self.device)
            self._track_state = self._gathered
            self._state_stale = False
        return self._track_state

    @track_state.setter
    def track_state(self, value: Optional[TrackState]) -> None:
        self._track_state = value
        self._state_stale = False

    def acquire_all(self, samples: np.ndarray,
                    extra_hints: Optional[dict] = None) -> List[AcqResult]:
        cfg = self.config
        hints = {}
        for prn, h in zip(cfg.prns, cfg.doppler_hints_hz or ()):
            if h is not None:
                hints[int(prn)] = float(h)
        if extra_hints:
            hints.update(extra_hints)
        with self.profiler.stage("acquire").time():
            results = acquire_sharded(
                samples, list(cfg.prns), self.mesh, cfg.plan, cfg.acq,
                doppler_hints_hz=hints or None,
            )
        for ch, res in zip(self.channels, results):
            ch.acq = res
            ch.state_name = "ACQ_DONE" if res.detected else "ACQ_FAILED"
        return results

    def start_tracking(self, samples: np.ndarray,
                       start_epoch: int = 0) -> None:
        cfg = self.config
        live = [ch for ch in self.channels if ch.acq and ch.acq.detected]
        if not live:
            raise RuntimeError("no channels acquired")
        self.standby_channels = [
            ch for ch in self.channels
            if ch not in live and ch not in self.standby_channels
        ] + self.standby_channels
        # pad the channel set to a mesh multiple with ghost copies of the
        # first channel (their outputs are ignored)
        pad = (-len(live)) % self.mesh.size
        tracked = live + live[:1] * pad
        self.channels = live
        self._n_live = len(live)

        prns = [ch.prn for ch in tracked]
        phases = np.array([ch.acq.code_phase_chips for ch in tracked])
        spe = cfg.plan.samples_per_epoch
        e = min(256 if cfg.track.coherent_pll else 32, len(samples) // spe)
        dev = self.device
        with self.profiler.stage("pretrack").time():
            dopplers, refined = handoff(
                samples, e, prns, phases,
                np.array([ch.acq.doppler_hz for ch in tracked]), cfg, dev,
                self.profiler.stage)
        state = init_state(len(tracked), refined, dopplers,
                           start_epoch=start_epoch,
                           window=cfg.track.pll_check_window, device=dev)
        # the receiver keeps the padded table (the checkpoint's rows), in
        # the tracking path's form (the tracker's)
        self.code_table = self._code_rows(prns)
        self.track_state = state
        self.tracker = StreamingTracker(state, self.code_table, self.mesh,
                                        cfg.plan, cfg.track)
        for ch in live:
            ch.state_name = "TRACKING"

    def process_block(self, samples: np.ndarray) -> None:
        cfg = self.config
        n_epochs = len(samples) // cfg.plan.samples_per_epoch
        epochs = self._to_device(samples, n_epochs)
        if self._digest_active:
            # per-position device digest: the (T, C) outputs never leave
            # the devices; only the joined ~kB digest reaches the host
            with self.profiler.stage(
                "track", budget_s=n_epochs * 1e-3
            ).time():
                d = digest_to_host(self.tracker.process_digest(epochs, cfg))
            with self.profiler.stage("decode").time():
                self._consume_digest(d, n_epochs)
            self._aided_sync_on_shards(
                self._aided_sync_from_digest, d, n_epochs, epochs)
        else:
            with self.profiler.stage(
                "track", budget_s=n_epochs * 1e-3
            ).time():
                outs = self.tracker.process(epochs)
                outs = TrackOutputs(*(v.cpu().numpy() for v in outs))
            with self.profiler.stage("decode").time():
                self._consume_outputs(outs, n_epochs)
            self._aided_sync_on_shards(
                self._maybe_aided_sync, outs, n_epochs, epochs)
        self.epoch_cursor += n_epochs
        # track_state doubles as the checkpoint alias (runtime.checkpoint
        # reads it; restoring a MeshReceiver yields a plain Receiver —
        # shard with StreamingTracker to resume on a mesh)

    def _aided_sync_on_shards(self, step, *args) -> None:
        """Run an aided-sync ``step`` after a block: the state it reads is
        gathered only if it reads one (ghost rows included, the base
        Receiver's mesh-padding branch), and sharded back where the step
        replaced it."""
        self._state_stale = True
        self._gathered = None
        step(*args)
        if not self._state_stale and self._track_state is not self._gathered:
            self.tracker.load(self._track_state)

    # -- dynamic channel set on a sharded tracker --------------------------

    def _sync_live_from_tracker(self) -> None:
        """Expose the un-padded live state/table as self.track_state /
        self.code_table so the base Receiver's channel-set logic can
        operate on them."""
        n = self._n_live
        self.track_state = TrackState(
            *(x[:n] for x in self.tracker.gather_state(self.device)))
        self.code_table = self.code_table[:n]

    def _reshard_to_tracker(self) -> None:
        """Re-pad the (possibly re-sized) live state to a mesh multiple
        with ghost copies of channel 0 and shard it back."""
        n = int(self.code_table.shape[0])
        pad = (-n) % self.mesh.size

        def _pad(x):
            if pad == 0:
                return x
            return torch.cat([x, x[:1].repeat((pad,) + (1,) * (x.dim() - 1))])

        self.track_state = TrackState(*(_pad(x) for x in self.track_state))
        self.code_table = _pad(self.code_table)
        self.tracker.load(self.track_state, self.code_table)
        self._n_live = n

    def maybe_reacquire(self, recent_samples: np.ndarray) -> List[int]:
        if self.tracker is None:
            return super().maybe_reacquire(recent_samples)
        self._sync_live_from_tracker()
        added = super().maybe_reacquire(recent_samples)
        self._reshard_to_tracker()
        return added

    def drop_dead_channels(self, cn0_floor_dbhz: float = None,
                           grace_ms: int = None) -> List[int]:
        if self.tracker is None:
            return super().drop_dead_channels(cn0_floor_dbhz, grace_ms)
        self._sync_live_from_tracker()
        dropped = super().drop_dead_channels(cn0_floor_dbhz, grace_ms)
        self._reshard_to_tracker()
        return dropped
