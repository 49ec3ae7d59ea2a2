"""The roll probes P1-P4 (tools/tpu_roll_wide_probe.py,
tools/tpu_mosaic_bisect.py) in the port, on the CPU.

The JAX probes cannot be imported in a test: at import they arm a 600 s
``os._exit`` timer, point JAX's compilation cache into the repository and
run their stages on pytest's ``argv`` (tpu_roll_wide_probe.py:54-67,
:269-275).  So each probe's kernel body is restated here as a Pallas
kernel run with ``interpret=True``, copied from the tool and cited by
line, and held against the port's plain version exactly (a roll is a
copy) over the full outputs, on the tool's inputs and on seeded ones.
The restatements differ from the tools only where said:

* P2's static amounts are folded into [0, W) before ``pltpu.roll`` (the
  TPU's spelling of a left roll; Mosaic refuses negative static amounts),
  since the seeded amounts take either sign;
* P3 reads ``es`` per row from an input (the tool fixes it at
  SPAN // 2 = 7, which the tool's inputs keep), so the seeded inputs
  exercise every barrel stage.

Also here: the g++ build of the kernels' lanes (csrc/roll_ops.cuh via
csrc/roll_host.cpp) and the one-call gather yardstick against the plain
versions, exactly, at 8, 32 and 128 rows: the barrel at every es in
[0, 15] and negative ones, at mc from 1 to 2046; the rolls at amounts of
either sign, 0, W - 1, W and more and the int32 ends, at the probes'
widths and an odd one (the kernel's scalar path); the host build refuses
a misaligned plane where the launcher does; the wrappers refuse CPU
tensors; the CLIs exit 1 without a card and 2 on an unknown stage; the
design-choice probe's patched builds (probes/roll_parts.py), the
scalar-load build's lanes through g++ against the plain version.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stm32f4_sdr_gps_torch.ops import kernel_lib
from stm32f4_sdr_gps_torch.ops.kernel_lib import host_lib
from stm32f4_sdr_gps_torch.probes import mosaic_bisect as p4
from stm32f4_sdr_gps_torch.probes import roll_parts as rp
from stm32f4_sdr_gps_torch.probes import roll_wide as p13

torch.set_num_threads(2)

INPUTS = ["probe", "seeded"]
P13_CASES = p13.CASES
WIN, U2P, SPAN = p13.WIN, 4352, p13.SPAN


# ---- P1 and P4: tpu_roll_wide_probe.py:72-99, tpu_mosaic_bisect.py:69-97

@functools.cache
def _roll_restated(rows, width, neg):
    def kernel(x_ref, s_ref, o_ref):           # roll_wide :78-83
        for r in range(rows):
            sft = s_ref[r]
            row = x_ref[pl.ds(r, 1), :]
            amt = -sft if neg else sft
            o_ref[pl.ds(r, 1), :] = pltpu.roll(row, amt, 1)

    def run(x, s):                             # :85-93
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct((rows, width), jnp.float32),
            in_specs=[pl.BlockSpec((rows, width), lambda: (0, 0)),
                      pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec((rows, width), lambda: (0, 0)),
            interpret=True,
        )(x, s)

    return jax.jit(run)


# ---- P2: tpu_roll_wide_probe.py:108-130, static amounts folded

@functools.cache
def _statwin_restated(rows, amts):
    def kernel2(x_ref, o_ref):                 # :115-118
        row = x_ref[pl.ds(0, 1), :]
        for i, a in enumerate(amts):
            o_ref[pl.ds(i, 1), :] = pltpu.roll(row, a % WIN, 1)

    def run(x):                                # :120-127
        return pl.pallas_call(
            kernel2,
            out_shape=jax.ShapeDtypeStruct((rows, WIN), jnp.float32),
            in_specs=[pl.BlockSpec((rows, WIN), lambda: (0, 0))],
            out_specs=pl.BlockSpec((rows, WIN), lambda: (0, 0)),
            interpret=True,
        )(x)

    return jax.jit(run)


# ---- P3: tpu_roll_wide_probe.py:139-186, es per row from an input

@functools.cache
def _barrel_restated(rows):
    span, stages = SPAN, (1, 2, 4, 8)

    def kernel(u2_ref, mc_ref, es_ref, e_ref, p_ref, l_ref):  # :157-176
        for c in range(rows):
            mc = mc_ref[c]
            row = u2_ref[pl.ds(c, 1), :]
            shift = mc - 1 - span // 2
            amt = jnp.where(shift > 0, U2P - shift, -shift)
            e_ref[pl.ds(c, 1), :] = pltpu.roll(row, amt, 1)[:, :WIN]
        bw = e_ref[...]
        es = es_ref[...]                       # the tool: full(span // 2)
        for sft in stages:
            rolled = pltpu.roll(bw, WIN - sft, 1)
            bw = jnp.where((es & sft) != 0, rolled, bw)
        pw = pltpu.roll(bw, WIN - 1, 1)
        lw = pltpu.roll(pw, WIN - 1, 1)
        e_ref[...] = bw
        p_ref[...] = pw
        l_ref[...] = lw

    def run(u2d, mc, es):                      # :178-186
        return pl.pallas_call(
            kernel,
            out_shape=[jax.ShapeDtypeStruct((rows, WIN), jnp.float32)] * 3,
            in_specs=[pl.BlockSpec((rows, U2P), lambda: (0, 0)),
                      pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec((rows, 1), lambda: (0, 0))],
            out_specs=[pl.BlockSpec((rows, WIN), lambda: (0, 0))] * 3,
            interpret=True,
        )(u2d, mc, es)

    return jax.jit(run)


def _p13_restated(case, args):
    arrays = [a.numpy() for a in args]
    if case == "barrel":
        u2, mc, es = arrays
        return _barrel_restated(len(mc))(u2, mc, es[:, None])
    x, amt = arrays
    if case == "statwin":
        return _statwin_restated(len(amt), tuple(int(a) for a in amt))(x)
    neg = case.endswith("_neg")
    return _roll_restated(len(amt), x.shape[1], neg)(x, -amt if neg else amt)


def _as_tuple(t):
    return t if isinstance(t, tuple) else (t,)


def _assert_equal(got, want):
    for g, w in zip(_as_tuple(got), _as_tuple(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---- plain versions against the restatements ----

@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("case", P13_CASES)
def test_p1_to_p3_plain_matches_restatement(case, which):
    args = p13.check_args(case, which)
    _assert_equal(p13.PLAIN[case](*args), _p13_restated(case, args))


@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("case", p4.CASES)
def test_p4_plain_matches_restatement(case, which):
    x, amt = p4.check_args(case, which)
    neg = case == "roll_neg"
    want = _roll_restated(len(amt), p4.W, neg)(
        x.numpy(), (-amt if neg else amt).numpy())
    _assert_equal(p4.PLAIN[case](x, amt), want)


def test_barrel_consumed_lanes_are_the_code_at_mc():
    """The tool's own check (tpu_roll_wide_probe.py:187-195): with es = 7
    the consumed lanes [:2048] of E / P / L are u2 rolled left by mc - 1 /
    mc / mc + 1."""
    u2, mc, es = p13.check_args("barrel", "probe")
    assert (es == SPAN // 2).all()
    got = p13.barrel_reference(u2, mc, es)
    for c in range(len(mc)):
        for t, off in zip(got, (-1, 0, 1)):
            want = np.roll(u2[c].numpy(), -(int(mc[c]) + off))[:2048]
            np.testing.assert_array_equal(t[c, :2048].numpy(), want)


def test_seeded_inputs_exercise_every_barrel_stage_and_sign():
    _, _, es = p13.check_args("barrel", "seeded")
    for s in p13.STAGE_SHIFTS:
        assert ((es & s) != 0).any() and ((es & s) == 0).any(), s
    for mod, case in ((p13, "dynu2_neg"), (p13, "dynwin_pos"), (p4, "roll_neg")):
        _, amt = mod.check_args(case, "seeded")
        assert (amt.abs() >= mod.check_args(case, "seeded")[0].shape[1]).any()
    _, amt = p13.check_args("statwin", "seeded")
    assert (amt < 0).any() and (amt > 0).any()


# ---- the host build of the CUDA source's lanes, and the yardstick ----

def _host(case, args):
    if case == "barrel":
        return p13.barrel_host(*args)
    return p13.roll_rows_host(*args, 0 if case == "statwin" else -1)


@pytest.mark.parametrize("rows", [8, 32, 128])
@pytest.mark.parametrize("case", P13_CASES + ["p4_" + c for c in p4.CASES])
def test_host_build_matches_plain(case, rows):
    mod = p4 if case.startswith("p4_") else p13
    case = case.removeprefix("p4_")
    for which in INPUTS:
        args = mod.check_args(case, which, rows=rows)
        _assert_equal(_host(case, args), mod.PLAIN[case](*args))


@pytest.mark.parametrize("case", P13_CASES + ["p4_" + c for c in p4.CASES])
def test_library_gather_matches_plain(case):
    mod = p4 if case.startswith("p4_") else p13
    case = case.removeprefix("p4_")
    for which in INPUTS:
        args = mod.check_args(case, which)
        want = mod.PLAIN[case](*args)
        got = p13.library_call(case, args)()
        if case == "barrel":
            want = torch.stack(want)
        assert torch.equal(got, want), which


# the barrel's stage bits: every es in [0, 15], and negative ones (their
# low four bits); K1's mc range [1, 2046] at its ends and inside
BARREL_ES = list(range(16)) + [-1, -7, -16, -2**31]
BARREL_MC = [1, 2, 9, 1023, 2045, 2046]


@pytest.mark.parametrize("rows", [8, 32, 128])
@pytest.mark.parametrize("es", BARREL_ES)
def test_barrel_host_matches_plain_every_es(es, rows):
    """The composed gather (barrel_src: the rebuild roll, the barrel's
    stages and P's and L's rolls as one index) against the plain version,
    stage by stage, bit for bit."""
    u2 = torch.as_tensor(np.random.default_rng(rows + es % 97).uniform(
        -1, 1, (rows, U2P)).astype(np.float32))
    mc = torch.as_tensor(np.resize(np.int32(BARREL_MC), rows))
    es_t = torch.full((rows,), es, dtype=torch.int32)
    _assert_equal(p13.barrel_host(u2, mc, es_t),
                  p13.barrel_reference(u2, mc, es_t))


def _edge_amounts(w):
    return [0, 1, -1, w - 1, -(w - 1), w, -w, w + 1, 3 * w + 5, -3 * w - 5,
            2**31 - 1, -2**31]


@pytest.mark.parametrize("src_row", [-1, 0], ids=["P1", "P2"])
@pytest.mark.parametrize("rows", [8, 32, 128])
@pytest.mark.parametrize("w", [U2P, WIN, p4.W, p13.ODD_WIDTH])
def test_roll_host_matches_plain_edge_amounts(w, rows, src_row):
    """Amounts of either sign, 0, W - 1, W and more, and the int32 ends,
    at the probes' widths (the 16-byte path) and at an odd width (the
    scalar path)."""
    x = torch.as_tensor(np.random.default_rng(w + rows).uniform(
        -1, 1, (rows, w)).astype(np.float32))
    amt = torch.as_tensor(np.resize(np.int64(_edge_amounts(w)), rows)
                          .astype(np.int32))
    _assert_equal(p13.roll_rows_host(x, amt, src_row),
                  p13.roll_rows_reference(x, amt, src_row))


@pytest.mark.parametrize("rows", [8, 32, 128])
def test_odd_width_seeded_inputs(rows):
    for case in ("dynwin_neg", "dynwin_pos", "statwin"):
        x, amt = p13.check_args(case, "seeded", rows=rows,
                                lanes=p13.ODD_WIDTH)
        assert x.shape == (rows, p13.ODD_WIDTH)
        _assert_equal(_host(case, (x, amt)), p13.PLAIN[case](x, amt))


def test_host_build_refuses_what_the_launcher_refuses():
    x, amt = p13.check_args("dynwin_pos", "probe")
    with pytest.raises(ValueError):
        p13.roll_rows_host(x, amt, -2)


def _misaligned(shape):
    """A contiguous float32 tensor of ``shape`` starting 4 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.empty(n + 4)[1:n + 1].view(shape)


@pytest.mark.parametrize("w,refused", [(WIN, True), (p4.W, True),
                                       (p13.ODD_WIDTH, False)])
def test_host_build_refuses_a_misaligned_row_plane(w, refused):
    """Where W % 4 == 0 the launcher (and its host build) refuses an out
    off a 16-byte boundary (its 16-byte stores); at an odd width the
    scalar path takes it.  x may start anywhere (scalar loads)."""
    lib = host_lib()
    x = torch.arange(8 * w, dtype=torch.float32).view(8, w)
    amt = torch.arange(8, dtype=torch.int32)
    out = _misaligned((8, w))
    assert lib.roll_rows_host(x.data_ptr(), amt.data_ptr(), out.data_ptr(),
                              8, w, -1) == refused
    if not refused:
        assert torch.equal(out, p13.roll_rows_reference(x, amt))
    x_off = _misaligned((8, w))
    x_off.copy_(x)
    out = torch.empty_like(x)
    assert lib.roll_rows_host(x_off.data_ptr(), amt.data_ptr(),
                              out.data_ptr(), 8, w, -1) == 0
    assert torch.equal(out, p13.roll_rows_reference(x, amt))


def test_host_build_refuses_a_misaligned_barrel_output():
    u2, mc, es = p13.check_args("barrel", "seeded")
    outs = [torch.empty((8, WIN)) for _ in range(3)]
    lib = host_lib()
    for k in range(3):
        bad = list(outs)
        bad[k] = _misaligned((8, WIN))
        assert lib.barrel_host(u2.data_ptr(), mc.data_ptr(), es.data_ptr(),
                               *(t.data_ptr() for t in bad), 8) == 1
    assert lib.barrel_host(u2.data_ptr(), mc.data_ptr(), es.data_ptr(),
                           *(t.data_ptr() for t in outs), 8) == 0


def test_library_gather_at_an_odd_width():
    args = p13.check_args("dynwin_neg", "seeded", lanes=p13.ODD_WIDTH)
    assert torch.equal(p13.library_call("dynwin_neg", args)(),
                       p13.roll_rows_reference(*args))


# ---- wrappers and entry points without a card ----

WRAPPERS = [(p13, "dynu2_neg"), (p13, "statwin"), (p13, "barrel"),
            (p4, "roll_pos")]


@pytest.mark.parametrize("mod,case", WRAPPERS,
                         ids=["P1", "P2", "P3", "P4"])
def test_kernel_wrappers_refuse_cpu_tensors(mod, case):
    fn = mod.KERNELS[case]
    n0 = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*mod.check_args(case, "probe"))
    assert fn.launches == n0


@pytest.mark.parametrize("mod", [p13, p4], ids=["roll_wide", "mosaic_bisect"])
def test_cli_exit_codes_without_a_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    name = mod.__name__.rsplit(".", 1)[1]
    first = next(iter(mod.STAGES))
    assert mod.main([name, first]) == 1
    assert mod.main([name, "all"]) == 1
    assert mod.main([name]) == 1
    assert mod.main([name, "bogus"]) == 2


# ---- the design-choice probe's builds (probes/roll_parts.py) ----

def _shipped_sources():
    texts = {}
    for name in rp.SOURCES:
        with open(os.path.join(kernel_lib.CSRC, name)) as f:
            texts[name] = f.read()
    return texts


@pytest.mark.parametrize("build", rp.BUILDS)
def test_roll_parts_patched_sources(build):
    """Each patch applies once; the shipped build is the sources
    themselves."""
    texts = rp.patched_sources(build)
    if build == "shipped":
        assert texts == _shipped_sources()
        return
    assert texts != _shipped_sources()
    for name, _, new in rp.PATCHES[build]:
        assert new in texts[name]


def test_roll_parts_missing_anchor_fails():
    with pytest.raises(RuntimeError, match="anchor found 0 times"):
        rp._replace_once("int x;", "int y;", "")
    with pytest.raises(ValueError):
        rp.patched_sources("threads_48")


@pytest.mark.parametrize("case", ["dynu2_neg", "dynwin_pos", "statwin"])
def test_roll_parts_funnel_loads_host_build_matches_plain(case, tmp_path):
    """The funnel_loads patch's lanes, built with g++ from the patched
    roll_ops.cuh, equal the plain version, as the shipped ones do."""
    for name, text in rp.patched_sources("funnel_loads").items():
        (tmp_path / name).write_text(text)
    (tmp_path / "roll_host.cpp").write_text(
        open(os.path.join(kernel_lib.CSRC, "roll_host.cpp")).read())
    lib = kernel_lib._load("roll_parts_funnel_host",
                           ["g++"] + kernel_lib.GXX_FLAGS, ["roll_host.cpp"],
                           {"roll_rows_host": kernel_lib._ROLL_ROWS_ARGS},
                           str(tmp_path))
    for which in INPUTS:
        x, amt = p13.check_args(case, which, rows=32)
        out = torch.empty_like(x)
        assert lib.roll_rows_host(x.data_ptr(), amt.data_ptr(),
                                  out.data_ptr(), 32, x.shape[1],
                                  0 if case == "statwin" else -1) == 0
        _assert_equal(out, p13.PLAIN[case](x, amt))


@pytest.mark.parametrize("argv,rc", [(["x", "abc"], 2), (["x", "0"], 2),
                                     (["x"], 1), (["x", "8", "128"], 1)])
def test_roll_parts_cli_exit_codes(monkeypatch, argv, rc):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert rp.main(argv) == rc
