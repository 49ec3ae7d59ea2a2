"""Device mesh: sharded acquisition and tracking (torch port of the JAX
package's parallel/mesh.py).

The reference is a uniprocessor; its concurrency structures (TDM channel
multiplexing, Doppler-bin serial scan, ISR double-buffering) map to mesh
axes here (SURVEY.md §2.3):

* ``chan`` axis — satellite channels / PRN rows of the acquisition cube
  (replaces TDM multiplexing, main.c:140-155);
* ``time`` axis — capture time-blocks for non-coherent integration;
  partial power sums merge in time-shard order (replaces the serial
  10-epochs-per-bin scan, acquisition.c:280-312).

A :class:`Mesh` is a row-major (time, chan) grid of positions, each with
a torch device; one device may stand at several positions.  A grid that
repeats ``cuda:0`` runs every shard and every merge on one card: it
checks the sharding and the collectives, and measures no scaling.  On a
multi-process mesh each process holds a contiguous block of the
flattened grid (as JAX assigns devices to processes), and the
collectives run over the caller's ``torch.distributed`` group on host
tensors (gloo over loopback TCP); the compute stays on the devices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..acquire.engine import acquisition_power
from ..track.state import TrackState
from ..utils.device import card_or_cpu


class Mesh:
    """A (time, chan) grid of positions.  ``devices`` are this process's
    positions' devices in flattened order; ``group`` is the process group
    of a multi-process mesh (None: one process holds the whole grid)."""

    def __init__(self, devices, time: int, chan: int, group=None):
        self.devices = tuple(devices)
        self.shape = {"time": time, "chan": chan}
        self.size = time * chan
        self.group = group
        rank = 0 if group is None else dist.get_rank(group)
        first = rank * len(self.devices)
        #: flattened grid positions this process holds
        self.positions = range(first, first + len(self.devices))

    def local(self) -> list:
        """(flattened grid position, device) of each position this
        process holds."""
        return list(zip(self.positions, self.devices))


def make_mesh(time: int = 1, chan: int | None = None, devices=None,
              group=None) -> Mesh:
    """Build a (time, chan) mesh over ``devices``: this process's devices,
    one a grid position, a device may repeat.  Without ``devices``, the
    visible cards; raises without one (no CPU fallback: pass CPU devices
    to run on the CPU).  With a process ``group`` every process passes
    the same number of devices and rank r holds the r-th block of
    positions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(devices=None): CUDA is not available; pass CPU "
                "devices (devices=['cpu'] * n) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = card_or_cpu(d, "make_mesh")
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    n = len(devs) * (1 if group is None else dist.get_world_size(group))
    if chan is None:
        chan = n // time
    if time * chan != n:
        raise ValueError(f"mesh {time}x{chan} != {n} devices")
    return Mesh(devs, time, chan, group)


def replicated(x: torch.Tensor, mesh: Mesh) -> list:
    """``x`` at each of this process's positions, copied once for each
    distinct device: positions that share a device share the tensor."""
    on = {}
    for dev in mesh.devices:
        if dev not in on:
            on[dev] = x.to(dev)
    return [on[dev] for dev in mesh.devices]


def concat_shards(parts: list, device, dim: int = -1):
    """The shards' tensors (or NamedTuples of tensors) joined in grid
    order along the channel axis ``dim``, on ``device``."""
    if isinstance(parts[0], tuple):
        return type(parts[0])(*(concat_shards(list(leaves), device, dim)
                                for leaves in zip(*parts)))
    return torch.cat([p.to(device) for p in parts], dim=dim)


def _all_reduce_host(buf: torch.Tensor, group) -> None:
    """Sum a host tensor over the group in place.  Every element is
    written by one process and is zero on the others, so the sum is
    exact whatever order the backend adds in."""
    dist.all_reduce(torch.view_as_real(buf) if buf.is_complex() else buf,
                    group=group)


# ---------------------------------------------------------------------------
# Acquisition: PRN axis over `chan`, epoch blocks over `time`, merged in
# time-shard order.
# ---------------------------------------------------------------------------

def sharded_acquisition_power(
    epochs: torch.Tensor,    # (E, S): the whole capture in one process;
    #   on a multi-process mesh the rows of this process's time shards
    cfc: torch.Tensor,       # (P, S), P divisible by mesh.shape['chan']
    rot: torch.Tensor,       # (D, S) Doppler rotations
    mesh: Mesh,
    gather_output: bool = False,  # multi-process: the whole cube on
    #   every process (else each holds its own PRN rows)
    dft: tuple | None = None,     # (wc, ws) matmul-DFT tables; None = FFT
    dft_precision: str = "highest",
) -> torch.Tensor:
    """Non-coherent power cube (P, D, S) with epochs sharded over
    ``time`` and PRNs over ``chan``: each position integrates its epoch
    rows for its PRN rows (acquisition_power, one epoch at a time), and
    the partial cubes of one PRN block add in time-shard order.  In one
    process the result is the whole cube on the mesh's first device."""
    nt, nc = mesh.shape["time"], mesh.shape["chan"]
    p_cnt = cfc.shape[0]
    if p_cnt % nc:
        raise ValueError(f"{p_cnt} PRN rows do not divide over chan={nc}")
    p_sh = p_cnt // nc
    local_t = sorted({p // nc for p in mesh.positions})
    if epochs.shape[0] % len(local_t):
        raise ValueError(f"{epochs.shape[0]} epochs do not divide over "
                         f"{len(local_t)} time shards")
    e_sh = epochs.shape[0] // len(local_t)
    eps, cfcs, rots = (replicated(x, mesh) for x in (epochs, cfc, rot))
    tables = [replicated(w, mesh) for w in dft] if dft is not None else None
    parts = {}
    for i, (p, _) in enumerate(mesh.local()):
        t, c = divmod(p, nc)
        k = local_t.index(t)
        parts[t, c] = acquisition_power(
            eps[i][k * e_sh:(k + 1) * e_sh],
            cfcs[i][c * p_sh:(c + 1) * p_sh], rots[i],
            dft=None if tables is None else (tables[0][i], tables[1][i]),
            dft_precision=dft_precision)
    dev0 = mesh.devices[0]
    if mesh.group is None:
        return torch.cat([_sum_in_order([parts[t, c].to(dev0)
                                         for t in range(nt)])
                          for c in range(nc)])
    buf = torch.zeros((nt, p_cnt) + tuple(rot.shape), dtype=torch.float32)
    for (t, c), part in parts.items():
        buf[t, c * p_sh:(c + 1) * p_sh] = part.cpu()
    _all_reduce_host(buf, mesh.group)
    cube = _sum_in_order([buf[t].to(dev0) for t in range(nt)])
    if gather_output:
        return cube
    local_c = sorted({p % nc for p in mesh.positions})
    return torch.cat([cube[c * p_sh:(c + 1) * p_sh] for c in local_c])


def _sum_in_order(parts: list) -> torch.Tensor:
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x
    return acc


# ---------------------------------------------------------------------------
# Tracking: channel axis sharded across the whole mesh.
# ---------------------------------------------------------------------------

def channel_sharding(mesh: Mesh, n_rows: int) -> list:
    """(row slice, device) of each position this process holds: a leading
    (channel) axis of ``n_rows`` split over every grid position in
    flattened order."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not divide over the "
                         f"{mesh.size}-position mesh")
    per = n_rows // mesh.size
    return [(slice(p * per, (p + 1) * per), dev) for p, dev in mesh.local()]


def shard_track_state(state: TrackState, mesh: Mesh) -> list:
    """This process's TrackState shards, each a copy on its position's
    device: no shard shares storage with another, so a kernel that writes
    one shard's planes cannot reach a neighbour's rows."""
    return [TrackState(*(x[sl].to(dev, copy=True) for x in state))
            for sl, dev in channel_sharding(mesh, state.doppler_hz.shape[0])]


def shard_code_table(code_table, mesh: Mesh) -> list:
    """This process's rows of the code table, one copy a position."""
    table = torch.as_tensor(code_table)
    return [table[sl].to(dev, copy=True)
            for sl, dev in channel_sharding(mesh, table.shape[0])]


# ---------------------------------------------------------------------------
# Overlap-save halo exchange for time-sharded sample blocks.
# ---------------------------------------------------------------------------

def halo_extend_blocks(blocks: torch.Tensor, halo: int, mesh: Mesh,
                       axis: str = "time") -> torch.Tensor:
    """Append each shard's first ``halo`` samples to its *left* neighbour
    (overlap-save): a block that ends mid-correlation-window can finish
    it locally.  (B, N) sharded on B over ``axis`` → (B, N + halo) with
    out[i, N:] = blocks[i+1, :halo] (the last block zero-padded): the
    firmware's ISR↔mainline double-buffer handshake
    (signal_capture.c:100-141, SURVEY.md §2.3).  On a multi-process mesh
    ``blocks`` holds this process's shards and each shard's head comes
    from the process holding its first position."""
    n_sh, nc = mesh.shape[axis], mesh.shape["chan"]

    def shard(p):
        return p // nc if axis == "time" else p % nc

    def first(i):
        return i * nc if axis == "time" else i

    dev_of = {}
    for p, dev in mesh.local():
        dev_of.setdefault(shard(p), dev)
    local = sorted(dev_of)
    if blocks.shape[0] % len(local):
        raise ValueError(f"{blocks.shape[0]} blocks do not divide over "
                         f"{len(local)} shards")
    b_sh = blocks.shape[0] // len(local)
    rows = {i: blocks[k * b_sh:(k + 1) * b_sh].to(dev_of[i])
            for k, i in enumerate(local)}
    if mesh.group is None:
        heads = {i: rows[i][:1, :halo] for i in local}
    else:
        buf = torch.zeros((n_sh, 1, halo), dtype=blocks.dtype)
        for i in local:
            if first(i) in mesh.positions:
                buf[i] = rows[i][:1, :halo].cpu()
        _all_reduce_host(buf, mesh.group)
        heads = dict(enumerate(buf))
    out = []
    for i in local:
        b = rows[i]
        recv = (heads[i + 1].to(b.device) if i + 1 < n_sh
                else torch.zeros_like(b[:1, :halo]))
        intra = torch.cat([b[1:, :halo], recv], dim=0)
        out.append(torch.cat([b, intra], dim=1))
    return concat_shards(out, mesh.devices[0], dim=0)
