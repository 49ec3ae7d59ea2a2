"""Multi-device streaming receiver front end (torch port of the JAX
package's parallel/streaming.py).

Long captures with time-blocks sharded across the mesh's ``time`` axis
and PRN channels across ``chan``:

* Acquisition is embarrassingly parallel over time-blocks: each shard
  integrates its local epochs non-coherently and the partial power cubes
  add up (mesh.sharded_acquisition_power).
* Tracking is sequential in time by nature (1 ms loop closure,
  SURVEY.md §7 hard part (a)); its parallel axis is channels.  The
  streaming loop therefore pipelines: sharded acquisition over the
  whole capture first, then the channel-sharded tracking scan consumes
  time-blocks in order.
* Block boundaries: epochs are self-contained 1 ms circular-correlation
  windows, so acquisition needs no halo; the halo exchange
  (mesh.halo_extend_blocks) exists for sample-granular block splits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..acquire.engine import (AcqResult, analyze_power, apply_doppler_hints,
                              epochs_on)
from ..config import AcqConfig, SignalPlan, BASEBAND_PLAN
from ..ops.correlate import (
    code_fft_conj,
    code_spectrum_conj_matmul,
    dft_tables_device,
    pack_code_bits,
    unpack_code_table,
)
from ..ops.wipeoff import doppler_rotations
from ..runtime.digest import BlockDigest, digest_block
from ..track.scan import track_block
from ..track.state import TrackOutputs, TrackState
from .mesh import (
    Mesh,
    concat_shards,
    replicated,
    shard_code_table,
    shard_track_state,
    sharded_acquisition_power,
)


def acquire_sharded(
    samples: np.ndarray,
    prns,
    mesh: Mesh,
    plan: SignalPlan = BASEBAND_PLAN,
    cfg: AcqConfig = AcqConfig(),
    num_epochs: Optional[int] = None,
    doppler_hints_hz: Optional[dict] = None,
) -> List[AcqResult]:
    """Mesh-sharded cold acquisition over a capture, in one process.

    PRNs shard over ``chan`` (padded to a multiple with head PRNs),
    epochs over ``time``.  ``doppler_hints_hz`` confines hinted PRNs to
    hint +/- one bin, as the single-device ``acquire()`` does.
    """
    s = plan.samples_per_epoch
    e = num_epochs or cfg.noncoherent_epochs
    nt = mesh.shape["time"]
    nc = mesh.shape["chan"]
    e = (max(e, nt) // nt) * nt
    if len(samples) < e * s:
        raise ValueError(f"need {e} epochs of samples")
    dev = mesh.devices[0]
    epochs = epochs_on(samples, e, s, dev)

    prns = list(prns)
    pad = (-len(prns)) % nc
    padded = prns + prns[:pad]          # repeat head PRNs as padding
    bins = np.asarray(cfg.doppler_bins_hz, dtype=np.float32)
    rot = doppler_rotations(torch.as_tensor(bins, device=dev), s,
                            plan.sample_rate_hz)
    dft = None
    if cfg.use_matmul_dft:
        # the matmul-DFT build: tables made on the device, the codes
        # shipped bit-packed (acquire.engine semantics)
        dft = dft_tables_device(s, device=dev)
        packed = torch.as_tensor(pack_code_bits(padded, plan), device=dev)
        cfc = code_spectrum_conj_matmul(unpack_code_table(packed, s), *dft)
    else:
        cfc = code_fft_conj(padded, plan, device=dev)
    power = sharded_acquisition_power(epochs, cfc, rot, mesh, dft=dft,
                                      dft_precision=cfg.dft_precision)
    # the cube stays on the device: PRN-pad slice, hint mask and peak
    # analysis are device ops; only (P,) vectors reach the host
    power = power[: len(prns)]
    power = apply_doppler_hints(power, prns, bins, doppler_hints_hz, cfg)
    return analyze_power(power, prns, bins, plan, cfg)


class StreamingTracker:
    """Channel-sharded tracking over sequential time-blocks.

    The host feeds blocks in order (from a file, the native ring buffer
    ``runtime.native.NativeRing``, or a network stream); each grid
    position's state stays resident on its device between calls — the
    analogue of the firmware's resident per-channel state advanced by the
    1 ms ISR.  Every position advances its channels with ``track_block``
    over the block replicated to its device: the tracking-scan kernel
    (K1), one launch a position a block, where ``cfg.in_kernel_scan``
    resolves to it, else the per-epoch reference scan.  Each call enters
    the scan from the TrackState (no kernel carry between blocks).  On a
    multi-process mesh a process holds and returns only its own
    positions' channels.
    """

    def __init__(self, state: TrackState, code_table, mesh: Mesh,
                 plan: SignalPlan, cfg):
        self.mesh = mesh
        self.plan = plan
        self.cfg = cfg
        # the WHOLE mesh (time axis included) acts as one channel axis
        # for tracking — time cannot shard a 1 ms feedback loop
        n_chan = int(np.shape(code_table)[0])
        if n_chan % mesh.size:
            raise ValueError(
                f"StreamingTracker: {n_chan} channels do not divide over "
                f"the {mesh.size}-device mesh (all mesh axes shard the "
                f"channel axis); pad the channel set to a multiple — "
                f"MeshReceiver.start_tracking shows the ghost-channel "
                f"pattern")
        self.load(state, code_table)

    def load(self, state: TrackState, code_table=None) -> None:
        """Shard ``state`` (and ``code_table``, where given) over the
        mesh in place of the tracker's own."""
        self.shards = shard_track_state(state, self.mesh)
        if code_table is not None:
            self.tables = shard_code_table(code_table, self.mesh)

    def gather_state(self, device) -> TrackState:
        """The whole TrackState on ``device`` (one process holds it all)."""
        if self.mesh.group is not None:
            raise ValueError("gather_state needs a one-process mesh")
        return concat_shards(self.shards, device, dim=0)

    def _epochs(self, samples) -> torch.Tensor:
        """The block's (T, S) epochs: a tensor as given (e.g. the block a
        receiver already put on the card), numpy samples copied once to
        the mesh's first device."""
        if isinstance(samples, torch.Tensor):
            return samples
        s = self.plan.samples_per_epoch
        return epochs_on(samples, len(samples) // s, s, self.mesh.devices[0])

    def _scan(self, samples):
        """Advance every position one block; its (state, outputs) each."""
        eps = replicated(self._epochs(samples), self.mesh)
        res = [track_block(st, ep, tb, self.plan, self.cfg)
               for st, ep, tb in zip(self.shards, eps, self.tables)]
        self.shards = [st for st, _ in res]
        return res

    def process(self, samples) -> TrackOutputs:
        """Advance all channels through one block of whole epochs; the
        (T, C) outputs joined on the channel axis on the mesh's first
        device."""
        return concat_shards([outs for _, outs in self._scan(samples)],
                             self.mesh.devices[0])

    def process_digest(self, samples, cfg_recv) -> BlockDigest:
        """Advance one block AND reduce it to a BlockDigest per position —
        the mesh form of runtime.receiver._track_and_digest.  Each
        position digests its own channels on its device (the digest is
        channel-independent); the leaves join on their channel axis (the
        last) on the mesh's first device, so the only readback a consumer
        needs is the ~kB digest, never the (T, C) outputs."""
        ds = [digest_block(outs, st, self.cfg, cfg_recv.code_filter_len,
                           cfg_recv.enable_code_filter)
              for st, outs in self._scan(samples)]
        return concat_shards(ds, self.mesh.devices[0])
