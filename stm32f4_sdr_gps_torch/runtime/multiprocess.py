"""Multi-process decode: the gps_master role distributed across processes
(torch port of the JAX package's runtime/multiprocess.py, over
``torch.distributed``).

On a multi-process mesh the tracking scan shards channels over EVERY
grid position (parallel.streaming.StreamingTracker), so each process's
positions hold a contiguous channel block.  Nav decode is 50 bps/channel
of control-heavy host work — exactly what should NOT be centralized:
each process runs the framers/ephemeris decode for ITS OWN channel block
(:class:`ShardDecoder`, reusing the single-process Receiver's decode
path verbatim via runtime.receiver.push_channel_bit), and only the tiny
per-channel observables + decoded ephemerides are gathered (JSON blobs
over a uint8 all-gather of the caller's process group, gloo over
loopback TCP) to form observations and solve PVT.

Reference role: ``gps_master_nav_handling`` + ``gps_master_calculate_pos``
(gps_master.c:159-425) — a single-MCU loop here split as
per-process decode → gather → one solver.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ReceiverConfig
from ..parallel.mesh import Mesh
from ..pvt.observables import ChannelObservables, form_observations
from ..pvt.solve import pntpos
from .digest import BlockDigest, cn0_from_moments, digest_to_host
from .receiver import ChannelStatus, push_channel_bit


def local_digest_block(d: BlockDigest, mesh: Mesh) -> Tuple[BlockDigest, int]:
    """THIS process's channel columns of a block digest, as
    ``(numpy digest, col_start)``.

    A process's tracker holds only its own grid positions, so its digest
    (leaves (C,) or (K, C)) already is its channel block; ``col_start``
    is the process's first grid position times the channels a position.
    """
    d = digest_to_host(d)
    per = d.bit_count.shape[0] // len(mesh.positions)
    return d, mesh.positions.start * per


class ShardDecoder:
    """Per-process framers/ephemeris for a channel block.

    Consumes (the local columns of) per-block digests and maintains the
    same ChannelStatus the single-process Receiver would for those
    channels: nav bits → framer → subframes → ephemeris → boundary
    ledger, plus the loop observables PVT needs.
    """

    def __init__(self, prns, config: ReceiverConfig,
                 start_epoch: int = 0):
        self.config = config
        self.epoch_cursor = start_epoch
        cib = config.track.codes_in_bit
        self.channels: List[ChannelStatus] = [
            ChannelStatus(prn=int(p)) for p in prns
        ]
        for ch in self.channels:
            ch.framer.polarity_timeout_ms = 600 * cib
            ch.state_name = "TRACKING"

    def consume_digest(self, d: BlockDigest, n_epochs: int) -> None:
        """Fold one block's digest (numpy leaves, columns = this
        process's channels in order) into the channel states."""
        cfg = self.config
        cib = cfg.track.codes_in_bit
        for c, ch in enumerate(self.channels):
            for k in range(int(d.bit_count[c])):
                push_channel_bit(ch, int(d.bit_value[k, c]),
                                 int(d.bit_epoch[k, c]), cib)
            ch.snr_db = float(d.snr_db[c])
            ch.bit_synced = bool(d.period_sync_ok[c])
            ch.cn0_dbhz = cn0_from_moments(
                float(d.cn0_m2[c]), float(d.cn0_m4[c]), int(d.cn0_n[c]))
            ch.doppler_hz = float(d.doppler_hz[c])
            ch.carrier_cycles += float(d.doppler_sum[c]) * 1e-3
            ch.code_phase_chips = float(
                d.code_phase_filtered[c] if cfg.enable_code_filter
                else d.code_phase_chips[c])
        self.epoch_cursor += n_epochs

    # -- gather + solve ----------------------------------------------------

    def encode_shard(self) -> bytes:
        """Observables + decoded ephemerides of this process's channels as
        a JSON blob (the structured checkpoint codec — no pickle)."""
        from .checkpoint import _encode

        rows = []
        for ch in self.channels:
            rows.append(dict(
                prn=ch.prn,
                subframe_time_ms=ch.subframe_time_ms,
                tow_s=ch.subframe_tow_s,
                week=ch.eph.week,
                code_phase_chips=ch.code_phase_chips,
                doppler_hz=ch.doppler_hz,
                snr_db=ch.snr_db,
                has_eph=bool(ch.eph.has_full_set),
                eph=_encode(ch.eph),
            ))
        return json.dumps(rows).encode("utf-8")


def allgather_blobs(blob: bytes, group=None,
                    max_len: int = 1 << 16) -> List[bytes]:
    """All-gather one variable-length byte blob per process of ``group``
    (None: the default group), in rank order: fixed-size uint8 rows with
    an 8-byte length header, gathered as host tensors (no pickle)."""
    if len(blob) > max_len:
        raise ValueError(f"shard blob {len(blob)} > max_len {max_len}")
    arr = np.zeros(max_len + 8, np.uint8)
    arr[:8] = np.frombuffer(
        np.uint64(len(blob)).tobytes(), np.uint8)
    arr[8: 8 + len(blob)] = np.frombuffer(blob, np.uint8)
    mine = torch.from_numpy(arr)
    rows = [torch.empty_like(mine)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, mine, group=group)
    out = []
    for row in rows:
        row = row.numpy()
        n = int(np.frombuffer(row[:8].tobytes(), np.uint64)[0])
        out.append(row[8: 8 + n].tobytes())
    return out


def gather_and_solve(decoder: ShardDecoder, meas_epoch_ms: int,
                     x0=None, solve: bool = True, group=None):
    """Gather every process's channel observables, form one observation
    set, and (optionally) run PVT.

    Every process of ``group`` calls this collectively (the all-gather
    is a collective); each gets the same (obs, solution) back, so any
    process can act on the fix.  Returns (obs, solution_or_None).
    """
    from .checkpoint import _decode

    blobs = allgather_blobs(decoder.encode_shard(), group=group)
    rows = []
    for blob in blobs:
        rows.extend(json.loads(blob.decode("utf-8")))
    eph_map = {}
    chobs = []
    seen = set()
    for r in rows:
        if r["subframe_time_ms"] <= 0:
            continue
        if r["prn"] in seen:
            continue       # ghost padding duplicates a real channel
        seen.add(r["prn"])
        chobs.append(ChannelObservables(
            prn=r["prn"], subframe_time_ms=r["subframe_time_ms"],
            tow_s=r["tow_s"], week=r["week"],
            code_phase_chips=r["code_phase_chips"],
            doppler_hz=r["doppler_hz"], snr_db=r["snr_db"]))
        if r["has_eph"]:
            eph_map[r["prn"]] = _decode(r["eph"])
    obs = form_observations(chobs, meas_epoch_ms)
    if obs is None or not solve:
        return obs, None
    usable = [o for o in obs if o.sat in eph_map]
    if len(usable) < 4:
        return obs, None
    sol = pntpos(usable, eph_map, x0=x0)
    return obs, sol
