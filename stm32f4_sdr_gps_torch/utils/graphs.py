"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles its per-block tracking programs with
``jax.jit``: ``track_block`` (a ``lax.scan`` over ``track_epoch_step``,
track/scan.py:393) and the two block programs of runtime/receiver.py
(``_track_and_digest``, ``_track_and_digest_carried``), and the
acquisition's cube and peak analysis (``_acquire_fused``,
acquire/engine.py).  On the card the port captures each of them once per
key as a CUDA graph and replays it, as jit traces once per key and reruns
the compiled program:

* :func:`captured` decorates a function whose arguments are pytrees of
  tensors (tensors, tuples, NamedTuples, lists, None) or static values
  named in ``static_argnames``;
* :func:`scan` is ``lax.scan`` under jit: the epoch step is the captured
  unit, reading its input row and writing its output row at an index held
  on the device, replayed T times with no host sync inside the block.

The key is the function, its static arguments and each tensor leaf's
shape, dtype and device (and the length T of a scan).  The first call
with a key on a CUDA device runs the function once eagerly on a side
stream (the kernel libraries, cuBLAS's workspace, the allocator and
``cudaFuncSetAttribute`` are then settled), captures it into static
input and output buffers, then replays it.  Later calls copy their
inputs into the static buffers and replay.  A host tensor among the
arguments of a program on the card is copied once, straight into its
static input, as jit transfers a numpy argument.  A graph bakes in the
values it was captured with (K1 copies its loop constants into the
launch), so everything that is not a tensor is in the key.

What a replay returns is cloned out of the static buffers (one copy of
one packed buffer; every leaf a view of it on a 64-byte boundary), so a
later replay overwrites nothing a caller holds.  Replays run one at a
time on the current stream, so the graphs, which share one memory pool
a device while any of them lives, never see each other's live data.
The cache keeps at most ``MAX_ENTRIES`` programs and drops the least
recently used.

The kernel wrappers count their own Python calls (``launches``).  A
replay calls none of them, so each program records how many launches of
each counted wrapper (:func:`count_launches`) its capture holds and adds
them on every replay.  The warm-up's launches, whose results are thrown
away, are counted apart (``stats["warmup_launches"]``).

On the CPU, under :func:`disable_capture` (the counterpart of
``jax.disable_jit``, for held comparisons) and inside another capture,
the same code runs eagerly.  A failed capture or replay raises: nothing
falls back to the eager run.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import math

import torch

#: programs the cache keeps (least recently used dropped first)
MAX_ENTRIES = 16
#: byte boundary of every leaf in a packed buffer
ALIGN = 64

#: captures, replays and cache evictions in this process, and the
#: counted wrappers' warm-up launches by name
stats = {"captures": 0, "replays": 0, "evictions": 0,
         "warmup_launches": {}}

_cache: collections.OrderedDict = collections.OrderedDict()
_pools: dict = {}
_counted: list = []
_disabled = 0
_inlined = 0


def count_launches(fn):
    """Register a kernel wrapper whose ``launches`` count (and its
    ``by_mode`` dict, where it has one) a replay adds to."""
    _counted.append(fn)
    return fn


@contextlib.contextmanager
def disable_capture():
    """Run every captured program eagerly inside the block (the
    counterpart of ``jax.disable_jit``)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


@contextlib.contextmanager
def _inline():
    """Programs called while another one warms up or is captured run
    eagerly, inside it (a capture cannot nest)."""
    global _inlined
    _inlined += 1
    try:
        yield
    finally:
        _inlined -= 1


def _use_graphs(device: torch.device) -> bool:
    return (device.type == "cuda" and not _disabled and not _inlined
            and not torch.cuda.is_current_stream_capturing())


def clear() -> None:
    """Drop every captured program."""
    _cache.clear()


# ---------------------------------------------------------------- pytrees

def flatten(tree):
    """(tensor leaves in order, hashable spec that rebuilds the tree)."""
    if isinstance(tree, torch.Tensor):
        return [tree], "T"
    if tree is None:
        return [], "N"
    if isinstance(tree, (tuple, list)):
        leaves, kids = [], []
        for v in tree:
            sub, spec = flatten(v)
            leaves.extend(sub)
            kids.append(spec)
        return leaves, (type(tree), tuple(kids))
    raise TypeError("a captured program takes tensors, tuples, NamedTuples,"
                    f" lists and None, not {type(tree).__name__}")


def unflatten(spec, leaves):
    return _build(spec, iter(leaves))


def _build(spec, it):
    if spec == "T":
        return next(it)
    if spec == "N":
        return None
    cls, kids = spec
    vals = [_build(k, it) for k in kids]
    if cls is list:
        return vals
    if hasattr(cls, "_fields"):
        return cls(*vals)
    return cls(vals)


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def _program_device(leaves) -> torch.device:
    """The device a program runs on: that of its first CUDA leaf, else
    the CPU."""
    for t in leaves:
        if t.is_cuda:
            return t.device
    return torch.device("cpu")


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


# ---------------------------------------------------------------- packing

def layout(specs) -> tuple:
    """Byte offsets of (dtype, shape) leaves packed one after another on
    ``ALIGN``-byte boundaries, and the total bytes."""
    offsets, off = [], 0
    for dtype, shape in specs:
        offsets.append(off)
        off += -(-math.prod(shape) * dtype.itemsize // ALIGN) * ALIGN
    return offsets, off


def pack(leaves) -> torch.Tensor:
    """The leaves' bytes in one uint8 tensor on their device, laid out as
    :func:`layout` says (one concatenation)."""
    _, total = layout([(t.dtype, t.shape) for t in leaves])
    parts = []
    for t in leaves:
        b = t.contiguous().view(-1).view(torch.uint8)
        parts.append(b)
        pad = -b.numel() % ALIGN
        if pad:
            parts.append(torch.empty(pad, dtype=torch.uint8, device=t.device))
    if not parts:
        return torch.empty(total, dtype=torch.uint8)
    return torch.cat(parts)


def unpack(buf: torch.Tensor, specs) -> list:
    """Views of a packed uint8 buffer as the (dtype, shape) leaves it
    holds."""
    offsets, _ = layout(specs)
    return [buf[o:o + math.prod(shape) * dtype.itemsize].view(dtype)
            .view(shape) for o, (dtype, shape) in zip(offsets, specs)]


# ---------------------------------------------------------------- counts

def _snapshot() -> list:
    return [(fn.launches, dict(getattr(fn, "by_mode", {})))
            for fn in _counted]


def _restore(snap) -> None:
    for fn, (n, by_mode) in zip(_counted, snap):
        fn.launches = n
        if hasattr(fn, "by_mode"):
            fn.by_mode.clear()
            fn.by_mode.update(by_mode)


def _delta(snap) -> list:
    """(wrapper, launches, by_mode) counted since ``snap``."""
    out = []
    for fn, (n, by_mode) in zip(_counted, snap):
        now = getattr(fn, "by_mode", {})
        d_by = {k: v - by_mode.get(k, 0) for k, v in now.items()
                if v != by_mode.get(k, 0)}
        if fn.launches != n or d_by:
            out.append((fn, fn.launches - n, d_by))
    return out


def _add(delta, times: int = 1) -> None:
    for fn, n, by_mode in delta:
        fn.launches += n * times
        for k, v in by_mode.items():
            fn.by_mode[k] = fn.by_mode.get(k, 0) + v * times


def _warm(run, device):
    """``run()`` eagerly on a side stream; its launches go to
    ``stats["warmup_launches"]``, not to the wrappers' counts."""
    snap = _snapshot()
    side = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)
    side.wait_stream(main)
    try:
        with _inline(), torch.cuda.stream(side):
            out = run()
        main.wait_stream(side)
        warm = stats["warmup_launches"]
        for fn, n, _ in _delta(snap):
            warm[fn.__name__] = warm.get(fn.__name__, 0) + n
    finally:
        _restore(snap)
    return out


def _capture(run, device):
    """(graph, what ``run()`` returned while captured, the counted
    launches the capture holds)."""
    pool = _pools.get(device)
    if pool is None or not any(getattr(e, "device", None) == device
                               for e in _cache.values()):
        # a pool no live graph holds may still hold a block that outlived
        # its graphs (such as cuBLAS's workspace for the capture stream),
        # and PyTorch refuses to share it again: take a fresh one
        pool = _pools[device] = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    snap = _snapshot()
    try:
        with _inline(), torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            out = run()
        launches = _delta(snap)
    finally:
        _restore(snap)
    stats["captures"] += 1
    return graph, out, launches


def _lookup(key, build):
    entry = _cache.get(key)
    if entry is None:
        entry = build()
        _cache[key] = entry
        while len(_cache) > MAX_ENTRIES:
            _cache.popitem(last=False)
            stats["evictions"] += 1
    else:
        _cache.move_to_end(key)
    return entry


# ---------------------------------------------------------------- programs

class _Program:
    """One captured function: static inputs, the packed static output and
    the layout that unpacks it."""

    def __init__(self, call, leaves, device):
        self.device = device
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in leaves]
        for s, t in zip(self.static, leaves):
            s.copy_(t)
        _warm(lambda: call(self.static), device)

        def body():
            out_leaves, spec = flatten(call(self.static))
            return pack(out_leaves), spec, [(t.dtype, tuple(t.shape))
                                            for t in out_leaves]

        self.graph, (self.packed, self.spec, self.specs), self.launches = \
            _capture(body, device)

    def run(self, leaves):
        for s, t in zip(self.static, leaves):
            s.copy_(t)
        self.graph.replay()
        _add(self.launches)
        stats["replays"] += 1
        return unflatten(self.spec, unpack(self.packed.clone(), self.specs))


def _capture_call(call, leaves, device):
    return _Program(call, leaves, device)


def captured(static_argnames=()):
    """Decorator: run the function as a captured CUDA graph on the card
    (see the module docstring); ``static_argnames`` are the arguments that
    are not tensors, all hashable and part of the key."""
    names = tuple(static_argnames)

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def program(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            arg = bound.arguments
            dyn = [n for n in arg if n not in names]
            leaves, spec = flatten(tuple(arg[n] for n in dyn))
            device = _program_device(leaves)

            def call(ls):
                kw = dict(zip(dyn, unflatten(spec, ls)))
                kw.update((n, arg[n]) for n in names)
                return fn(**kw)

            if not _use_graphs(device):
                return call([_on(t, device) for t in leaves])
            key = (fn, tuple(arg[n] for n in names), spec,
                   _signature(leaves))
            prog = _lookup(key, lambda: _capture_call(call, leaves, device))
            return prog.run(leaves)

        return program

    return wrap


# ---------------------------------------------------------------- scan

def _scan_step(step, static, carry_spec, carry, xs, consts, i, ys):
    """One step of the scan on buffers, in place: ``x = xs[i]``;
    ``(carry', y) = step(carry, x, *consts, *static)``; ``ys[:, i] = y``;
    ``carry = carry'``; ``i += 1``.  ``ys`` None: the (T, ...) output
    buffers are made from this step's outputs and its new carry is
    checked against the buffers (lax.scan's carry rule).  Returns
    (ys, spec of y)."""
    x = xs.index_select(0, i).squeeze(0)
    new, y = step(unflatten(carry_spec, carry), x, *consts, *static)
    new_leaves, new_spec = flatten(new)
    y_leaves, y_spec = flatten(y)
    if ys is None:
        if new_spec != carry_spec or [(t.dtype, t.shape) for t in carry] \
                != [(t.dtype, t.shape) for t in new_leaves]:
            raise TypeError("scan: the step's new carry differs from the "
                            "carry it was given in structure, dtype or "
                            "shape")
        ys = [torch.empty((xs.shape[0],) + tuple(t.shape), dtype=t.dtype,
                          device=t.device) for t in y_leaves]
    for b, t in zip(ys, y_leaves):
        b.index_copy_(0, i, t.unsqueeze(0))
    for b, t in zip(carry, new_leaves):
        b.copy_(t)
    i.add_(1)
    return ys, y_spec


def _scan_eager(step, static, carry_spec, carry, xs, consts, device):
    """The step form run eagerly on fresh buffers: (carry, ys, y spec)."""
    carry = [t.to(device, copy=True, memory_format=torch.contiguous_format)
             for t in carry]
    xs = _on(xs, device)
    consts = [_on(t, device) for t in consts]
    i = torch.zeros(1, dtype=torch.int64, device=device)
    ys = y_spec = None
    for _ in range(xs.shape[0]):
        ys, y_spec = _scan_step(step, static, carry_spec, carry, xs, consts,
                                i, ys)
    return carry, ys, y_spec


class _Scan:
    """One captured scan step: static carry and output buffers (views of
    one packed buffer), the static input rows and constants, the index."""

    def __init__(self, step, static, carry_spec, carry, xs, consts, device):
        self.device = device
        # warm-up: the eager scan over the first row; it also gives the
        # outputs' dtypes and shapes
        ys1, y_spec = _warm(lambda: _scan_eager(
            step, static, carry_spec, carry, xs[:1], consts, device)[1:],
            device)
        n = xs.shape[0]
        self.y_spec = y_spec
        self.specs = ([(t.dtype, tuple(t.shape)) for t in carry]
                      + [(t.dtype, (n,) + tuple(t.shape[1:])) for t in ys1])
        _, total = layout(self.specs)
        self.packed = torch.empty(total, dtype=torch.uint8, device=device)
        views = unpack(self.packed, self.specs)
        self.carry, self.ys = views[:len(carry)], views[len(carry):]
        self.xs = torch.empty(xs.shape, dtype=xs.dtype, device=device)
        self.consts = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in consts]
        self.i = torch.zeros(1, dtype=torch.int64, device=device)
        self.n = n
        self.graph, _, self.launches = _capture(lambda: _scan_step(
            step, static, carry_spec, self.carry, self.xs, self.consts,
            self.i, self.ys), device)

    def _copy_in(self, carry, xs, consts):
        for b, t in zip(self.carry + [self.xs] + self.consts,
                        list(carry) + [xs] + list(consts)):
            b.copy_(t)
        self.i.zero_()

    def run(self, carry, xs, consts):
        self._copy_in(carry, xs, consts)
        for _ in range(self.n):
            self.graph.replay()
        _add(self.launches, self.n)
        stats["replays"] += self.n
        views = unpack(self.packed.clone(), self.specs)
        k = len(self.carry)
        return views[:k], views[k:], self.y_spec


def _capture_scan(step, static, carry_spec, carry, xs, consts, device):
    return _Scan(step, static, carry_spec, carry, xs, consts, device)


def scan(step, carry, xs: torch.Tensor, consts=(), static=()):
    """``lax.scan`` of ``step(carry, x, *consts, *static) -> (carry, y)``
    over the rows of ``xs``: ``(final carry, ys)``, each leaf of ``ys``
    the (T, ...) stack of that leaf of ``y``.  The carry keeps its
    structure, dtypes and shapes from step to step.  On the card the step
    is one captured graph replayed T times (the key: ``step``, ``static``,
    the leaves' signatures and T); elsewhere the same step form runs
    eagerly."""
    if xs.shape[0] == 0:
        raise ValueError("scan needs at least one row")
    carry_leaves, carry_spec = flatten(carry)
    consts = list(consts)
    leaves = carry_leaves + [xs] + consts
    device = _program_device(leaves)
    static = tuple(static)
    if _use_graphs(device):
        key = ("scan", step, static, carry_spec, _signature(leaves))
        prog = _lookup(key, lambda: _capture_scan(
            step, static, carry_spec, carry_leaves, xs, consts, device))
        out, ys, y_spec = prog.run(carry_leaves, xs, consts)
    else:
        out, ys, y_spec = _scan_eager(step, static, carry_spec, carry_leaves,
                                      xs, consts, device)
    return unflatten(carry_spec, out), unflatten(y_spec, ys)
