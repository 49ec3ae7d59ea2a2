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
versions, exactly; the wrappers refuse CPU tensors; the CLIs exit 1
without a card and 2 on an unknown stage.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stm32f4_sdr_gps_torch.probes import mosaic_bisect as p4
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


@pytest.mark.parametrize("rows", [8, 32])
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


def test_host_build_refuses_what_the_launcher_refuses():
    x, amt = p13.check_args("dynwin_pos", "probe")
    with pytest.raises(ValueError):
        p13.roll_rows_host(x, amt, -2)


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
