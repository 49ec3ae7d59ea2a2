"""The captured programs (utils.graphs) on the CPU.

* the cache of ``captured`` and ``scan``, with the capture step stubbed
  by an eager one: the same key reuses its program; a change of C, of T
  or of any TrackConfig field captures anew; the LRU bound holds;
  ``disable_capture`` captures nothing;
* on the CPU the decorated programs equal the undecorated functions bit
  for bit;
* ``track_block``'s step form equals the Python loop over
  ``track_epoch_step`` it replaced, bit for bit, in the reference scan,
  the half-chip scan with K2's plain version, ``coherent_bit_vote``,
  ``coherent_pll`` and ``emit_correlators``, and the JAX ``track_block``
  under tests/test_pallas_scan.py:68-117's tolerances (integer decisions
  exact);
* the packed digest readback equals one ``.cpu()`` a leaf, dtype for
  dtype; pack / unpack round trips; the launch counts a replay adds.

The card-side cases (replay equal to eager, no aliasing across replays)
are in tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.track.scan import track_block as j_track_block
from stm32f4_sdr_gps_tpu.track.state import init_state as j_init_state
from stm32f4_sdr_gps_torch.acquire import engine
from stm32f4_sdr_gps_torch.config import AcqConfig
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN as T_PLAN
from stm32f4_sdr_gps_torch.ops import track_scan as ts
from stm32f4_sdr_gps_torch.ops.epl import upsampled_code_doubled
from stm32f4_sdr_gps_torch.runtime import receiver as rcv
from stm32f4_sdr_gps_torch.runtime.digest import (BlockDigest, digest_block,
                                                  digest_to_host)
from stm32f4_sdr_gps_torch.track.scan import track_block, track_epoch_step
from stm32f4_sdr_gps_torch.track.state import TrackOutputs, init_state
from stm32f4_sdr_gps_torch.utils import graphs, profiling
from tests.test_pallas_scan import (PLAN, PRNS, _assert_outputs_match,
                                    _assert_states_match)
from tests.test_torch_track import _jax_cfg, _setup, _torch_cfg

torch.set_num_threads(2)

EPOCHS = 90          # tests/test_pallas_scan.py _run_both's size

MODES = {
    "reference": dict(),
    "half_chip_k2_plain": dict(use_pallas=True),
    "coherent_bit_vote": dict(coherent_bit_vote=True),
    "coherent_pll": dict(coherent_pll=True),
    "emit_correlators": dict(emit_correlators=True),
}


def _python_loop(state, epochs, table, plan, cfg):
    """track_block as it was before the step form: a Python loop over
    track_epoch_step, the per-epoch outputs stacked (zero-size
    placeholders kept as they are)."""
    steps = []
    for t in range(epochs.shape[0]):
        state, out = track_epoch_step(state, epochs[t], table, plan, cfg)
        steps.append(out)
    return state, TrackOutputs(*(
        leaves[0] if leaves[0].numel() == 0 else torch.stack(leaves)
        for leaves in zip(*steps)))


def _inputs(mode, num_epochs=EPOCHS):
    epochs, table, cp0, dop0 = _setup(num_epochs)
    change = MODES[mode]
    code = upsampled_code_doubled(table) if change.get("use_pallas") \
        else table
    return epochs, code, cp0, dop0, change


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
def test_step_form_equals_python_loop(mode):
    epochs, code, cp0, dop0, change = _inputs(mode)
    cfg = _torch_cfg(pll_bad_state_threshold=10**6, **change)
    st0 = init_state(len(PRNS), cp0, dop0, device="cpu")
    x, tab = torch.as_tensor(epochs), torch.as_tensor(code)
    st_a, out_a = track_block(st0, x, tab, T_PLAN, cfg)
    st_b, out_b = _python_loop(st0, x, tab, T_PLAN, cfg)
    for a, b in zip(st_a, st_b):
        _equal(a, b)
    for a, b in zip(out_a, out_b):
        _equal(a, b)
    assert out_a.bit_ready.any()


@pytest.mark.parametrize("mode", list(MODES))
def test_step_form_matches_jax(mode):
    epochs, code, cp0, dop0, change = _inputs(mode)
    st_ref, out_ref = j_track_block(
        j_init_state(len(PRNS), cp0, dop0), jnp.asarray(epochs),
        jnp.asarray(code), PLAN,
        _jax_cfg(pll_bad_state_threshold=10**6, **change))
    st, out = track_block(init_state(len(PRNS), cp0, dop0, device="cpu"),
                          torch.as_tensor(epochs), torch.as_tensor(code),
                          T_PLAN,
                          _torch_cfg(pll_bad_state_threshold=10**6, **change))
    _assert_outputs_match(out_ref, out)
    _assert_states_match(st_ref, st)


@pytest.mark.parametrize("spacing", [0.5, 0.25, 0.1, 1.0 / 3.0])
def test_step_lags_equal_host_tuple(spacing):
    """The reference scan's lags, now made on the device, equal the
    float32 tuple it took before."""
    got = spacing * torch.arange(-1, 2, dtype=torch.float32)
    want = torch.as_tensor((-spacing, 0.0, spacing), dtype=torch.float32)
    assert torch.equal(got, want)
    assert not torch.signbit(got[1])


# ---------------------------------------------------------------- programs

def _k1_args(c=len(PRNS), t=12):
    epochs, table, cp0, dop0 = _setup(t)
    st = init_state(len(PRNS), cp0, dop0, device="cpu")
    st = type(st)(*(v[:c] for v in st))
    u2 = torch.as_tensor(upsampled_code_doubled(table))[:c].contiguous()
    return ts.state_from_track_state(st), torch.as_tensor(epochs), u2, st


def _run_program(name, c=len(PRNS), t=12, cfg=None):
    """One call of each captured program at C channels and T epochs."""
    ps, x, u2, st = _k1_args(c, t)
    cfg = cfg or _torch_cfg(in_kernel_scan=True)
    if name == "carried":
        return rcv._track_and_digest_carried(ps, x, u2, T_PLAN, cfg, 100,
                                             True)
    if name == "kernel_block":
        return ts.track_block_kernel(st, x, u2, T_PLAN, cfg)
    if name == "scan":
        return track_block(st, x, u2, T_PLAN,
                           dataclasses.replace(cfg, in_kernel_scan=False,
                                               use_pallas=True))
    st2, outs = _python_loop(st, x, u2, T_PLAN,
                             dataclasses.replace(cfg, in_kernel_scan=False,
                                                 use_pallas=True))
    return rcv._digest(outs, st2, cfg, 100, True)


class _Stub:
    """A captured program that runs eagerly: counts its captures and
    replays, in ``graphs.stats`` too, as a captured program does."""

    captures = 0

    def __init__(self, run):
        _Stub.captures += 1
        graphs.stats["captures"] += 1
        self.runs = 0
        self._run = run

    def run(self, *args):
        self.runs += 1
        graphs.stats["replays"] += 1
        return self._run(*args)


@pytest.fixture
def stubbed(monkeypatch):
    """Capture stubbed by an eager run: the cache logic on the CPU."""
    monkeypatch.setattr(graphs, "_cache", graphs._cache.__class__())
    monkeypatch.setattr(
        graphs, "_use_graphs",
        lambda device: not graphs._disabled and not graphs._inlined)
    monkeypatch.setattr(graphs, "_capture_call",
                        lambda call, leaves, device: _Stub(call))

    def scan_stub(step, static, carry_spec, carry, xs, consts, device):
        def run(carry, xs, consts):
            return graphs._scan_eager(step, static, carry_spec, carry, xs,
                                      consts, device)
        return _Stub(run)

    monkeypatch.setattr(graphs, "_capture_scan", scan_stub)
    _Stub.captures = 0
    return _Stub


PROGRAMS = ["carried", "kernel_block", "scan", "digest"]


@pytest.mark.parametrize("name", PROGRAMS)
@pytest.mark.parametrize("change", ["same", "channels", "epochs", "cfg"])
def test_captured_cache_keys(stubbed, name, change):
    cfg = _torch_cfg(in_kernel_scan=True)
    first = _run_program(name, cfg=cfg)
    assert stubbed.captures == 1
    if change == "same":
        second = _run_program(name, cfg=cfg)
        assert stubbed.captures == 1
        for a, b in zip(graphs.flatten(first)[0],
                        graphs.flatten(second)[0]):
            _equal(a, b)
        (prog,) = graphs._cache.values()
        assert prog.runs == 2
        return
    kw = {"channels": dict(c=len(PRNS) - 1), "epochs": dict(t=14),
          "cfg": dict(cfg=dataclasses.replace(cfg, dll_c1=cfg.dll_c1 * 2))}
    _run_program(name, **kw[change])
    assert stubbed.captures == 2
    assert len(graphs._cache) == 2


def test_captured_cache_is_lru(stubbed, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_ENTRIES", 2)
    ev = graphs.stats["evictions"]
    for c in (8, 7, 6):
        _run_program("carried", c=c)
    assert stubbed.captures == 3 and len(graphs._cache) == 2
    assert graphs.stats["evictions"] == ev + 1
    _run_program("carried", c=7)          # kept: no capture
    assert stubbed.captures == 3
    _run_program("carried", c=8)          # evicted: captured again
    assert stubbed.captures == 4 and len(graphs._cache) == 2


def test_disable_capture_runs_eagerly(stubbed):
    with graphs.disable_capture():
        for name in PROGRAMS:
            _run_program(name)
    assert stubbed.captures == 0 and not graphs._cache
    _run_program("carried")
    assert stubbed.captures == 1


@pytest.mark.parametrize("name", PROGRAMS)
def test_decorated_equals_undecorated_on_cpu(name):
    """On the CPU a captured program is its function, bit for bit."""
    ps, x, u2, st = _k1_args()
    cfg = _torch_cfg(in_kernel_scan=True)
    if name == "carried":
        fn, args = rcv._track_and_digest_carried, (ps, x, u2, T_PLAN, cfg,
                                                   100, True)
    elif name == "kernel_block":
        fn, args = ts.track_block_kernel, (st, x, u2, T_PLAN, cfg)
    elif name == "scan":
        cfg = dataclasses.replace(cfg, in_kernel_scan=False, use_pallas=True)
        fn, args = None, (st, x, u2, T_PLAN, cfg)
    else:
        st2, outs = _python_loop(st, x, u2, T_PLAN,
                                 dataclasses.replace(cfg, in_kernel_scan=False,
                                                     use_pallas=True))
        fn, args = rcv._digest, (outs, st2, cfg, 100, True)
    if fn is None:
        got, want = track_block(*args), _python_loop(*args)
    else:
        got, want = fn(*args), fn.__wrapped__(*args)
    gl, gspec = graphs.flatten(got)
    wl, wspec = graphs.flatten(want)
    assert gspec == wspec and len(gl) == len(wl)
    for a, b in zip(gl, wl):
        _equal(a, b)


# ---------------------------------------------------------------- acquisition

ACQ_X = (np.array([1.0, 1j]) @ np.random.default_rng(23).standard_normal(
    (2, 4 * 2046))).astype(np.complex64)
ACQ_SMALL = dict(doppler_span_hz=1000.0, noncoherent_epochs=4)
#: the second call of each case, after acquire(PRNs 4, 7) on the default
ACQ_CHANGES = {
    "prn_set": dict(prns=[9, 30]),
    "prn_count": dict(prns=[4, 7, 9]),
    "hint_mask": dict(hints={7: 500.0}),
    "coherent": dict(cfg=dict(coherent_epochs=2)),
    "edge_hypotheses": dict(base=dict(coherent_epochs=2),
                            cfg=dict(coherent_epochs=2, edge_hypotheses=2)),
    "dft_precision": dict(base=dict(use_matmul_dft=True),
                          cfg=dict(use_matmul_dft=True,
                                   dft_precision="highest")),
}


def _acquire(prns=(4, 7), cfg=None, hints=None):
    acq = AcqConfig(**ACQ_SMALL, **(cfg or {}))
    return engine.acquire(ACQ_X, list(prns), T_PLAN, acq,
                          doppler_hints_hz=hints, device="cpu")


@pytest.mark.parametrize("change", list(ACQ_CHANGES))
def test_acquisition_program_keys(stubbed, change):
    """Two PRN sets of one size share the captured acquisition; another
    PRN count, a hint mask, another coherent span, edge-hypothesis count
    or DFT precision each capture their own."""
    kw = dict(ACQ_CHANGES[change])
    base = kw.pop("base", None)
    _acquire(cfg=base)
    assert stubbed.captures == 1
    _acquire(**{**dict(cfg=base), **kw})
    assert stubbed.captures == (1 if change == "prn_set" else 2)
    assert sum(p.runs for p in graphs._cache.values()) == 2


def test_acquisition_counts_capture_and_replay(stubbed):
    """``acquire.capture`` on the call that captures, ``acquire.replay``
    on every call that replays (the capturing one too)."""
    def moved():
        before = dict(profiling.counters)
        _acquire()
        return {k: profiling.counters.get(k, 0) - before.get(k, 0)
                for k in ("acquire.capture", "acquire.replay")}

    assert moved() == {"acquire.capture": 1, "acquire.replay": 1}
    assert moved() == {"acquire.capture": 0, "acquire.replay": 1}
    with graphs.disable_capture():
        assert moved() == {"acquire.capture": 0, "acquire.replay": 0}


def test_scan_rejects_a_changing_carry():
    def step(carry, x):
        return carry.to(torch.int64), x

    with pytest.raises(TypeError, match="carry"):
        graphs.scan(step, torch.zeros(3, dtype=torch.int32),
                    torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="one row"):
        graphs.scan(step, torch.zeros(3), torch.zeros((0, 3)))


# ---------------------------------------------------------------- packing

def _digest_sample(c=3, k=5, cib=20):
    rng = np.random.default_rng(4)
    leaves = []
    for name in BlockDigest._fields:
        shape = {"bit_value": (k, c), "bit_epoch": (k, c),
                 "flip_hist": (cib, c)}.get(name, (c,))
        if name in ("bit_value", "first_ip_sign", "last_ip_sign"):
            v = torch.as_tensor(rng.integers(-1, 2, shape), dtype=torch.int8)
        elif name in ("period_sync_ok", "sync_any_loss"):
            v = torch.as_tensor(rng.integers(0, 2, shape).astype(bool))
        elif name in ("bit_count", "bit_epoch", "last_unsync_epoch",
                      "cn0_n", "flip_hist", "swap_residue"):
            v = torch.as_tensor(rng.integers(-5, 10**6, shape),
                                dtype=torch.int32)
        else:
            v = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32)
        leaves.append(v)
    return BlockDigest(*leaves)


@pytest.mark.parametrize("c", [1, 3, 8, 33])
def test_packed_digest_readback_equals_per_leaf(c):
    d = _digest_sample(c)
    got = digest_to_host(d)
    for name, a, v in zip(BlockDigest._fields, got, d):
        want = v.cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape, name
        np.testing.assert_array_equal(a, want, err_msg=name)


def test_packed_digest_readback_of_a_block():
    """A real block's digest: packed readback = one .cpu() a leaf."""
    epochs, table, cp0, dop0 = _setup(40)
    st2, outs = _python_loop(init_state(len(PRNS), cp0, dop0, device="cpu"),
                             torch.as_tensor(epochs), torch.as_tensor(table),
                             T_PLAN, _torch_cfg())
    d = digest_block(outs, st2, _torch_cfg(), 100, True)
    for a, v in zip(digest_to_host(d), d):
        want = v.cpu().numpy()
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("specs", [
    [(torch.float32, (3,)), (torch.bool, (5,)), (torch.int8, (2, 7)),
     (torch.int32, ()), (torch.float32, (0,)), (torch.int64, (4, 3))],
    [(torch.bool, (1,)), (torch.float32, (90, 0)), (torch.int32, (17, 3))],
])
def test_pack_unpack_round_trip(specs):
    gen = torch.Generator().manual_seed(1)
    leaves = [(torch.randint(-9, 9, shape, generator=gen) > 0
               if dtype == torch.bool else
               torch.randint(-9, 9, shape, generator=gen).to(dtype))
              for dtype, shape in specs]
    buf = graphs.pack(leaves)
    offsets, total = graphs.layout(specs)
    assert buf.dtype == torch.uint8 and buf.numel() == total
    assert all(o % graphs.ALIGN == 0 for o in offsets)
    for a, b in zip(graphs.unpack(buf, specs), leaves):
        _equal(a, b)


def test_replay_adds_the_launches_a_capture_holds(monkeypatch):
    def fake():
        pass

    fake.launches, fake.by_mode = 0, {}
    monkeypatch.setattr(graphs, "_counted", [fake])
    snap = graphs._snapshot()
    fake.launches += 1
    fake.by_mode[("default", 8)] = 1
    delta = graphs._delta(snap)
    graphs._restore(snap)
    assert fake.launches == 0 and fake.by_mode == {}
    graphs._add(delta, 1000)
    assert fake.launches == 1000 and fake.by_mode == {("default", 8): 1000}
