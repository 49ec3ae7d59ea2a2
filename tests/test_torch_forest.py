"""The epoch-cost probes P6-P8 (tools/forest_probe*.py) in the port, on the
CPU.

The JAX probes cannot be imported in a test: at import they arm SIGALRM,
compile every variant for the TPU and parse a profiler trace
(tools/forest_probe.py:30-36, :148-170).  So each probe's kernel body is
restated here as a Pallas kernel run with ``interpret=True``, copied from
the tool and cited by line, and each variant's plain torch version is held
against it at the check size (G = 2, 8 iterations, K = 4 for P6) on the
probe's own inputs and on seeded ones.  The restatements differ from the
tools only where the port's semantics differ, and say so:

* P7 zeroes its output at the first step (the tool left every row but row
  0 and dynstore's row g undefined) and also returns its two state
  planes;
* P8 also returns its wide plane, and runs red_row, roll_row and roll_col
  with the row variants' state as (8, C, 1) and the roll amount folded to
  W - s (the tool's spelling does not trace on today's JAX).

Tolerances (plain version vs restatement):

* fused steps, rtol 1e-5: the reference's XLA lowering rounds a*c + b
  once; the plain version forms it in float64 and rounds once more, which
  can differ by one rounding in rare cases, and the chains carry such a
  difference along at about its relative size;
* compares, selects, int ops, divides, the transposes' scalings and the
  barrel: exact on their own; in P7 they ride on the fused chain and take
  its rtol;
* sincos: rtol 1e-5 on b, atol 1e-5 on a = cos(a) + sin(b): XLA's and
  torch's cos and sin differ by an ulp, and b grows about 5x per
  iteration, so after 16 iterations an ulp of a reaches b's last bits;
* red: rtol 1e-5, six float32 sums of 2048 terms in other orders.

The g++ host build of the CUDA source's bodies (csrc/forest_ops.cuh via
csrc/forest_host.cpp) is held against the plain version too: exact for
P6 and P7 but sincos (glibc's cosf and sinf against torch's, the same
tolerance), rtol 1e-5 on P8's sums.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stm32f4_sdr_gps_torch.probes import forest_chain as p6
from stm32f4_sdr_gps_torch.probes import forest_constructs as p7
from stm32f4_sdr_gps_torch.probes import forest_layout as p8

torch.set_num_threads(2)

f32 = jnp.float32
C = 32
EPOCHS = 8
INPUTS = ["probe", "seeded"]


# ---- P6: tools/forest_probe.py:60-141 ----

@functools.cache
def _p6_restated(variant, c, k, g):
    shp = p6.state_shape(variant, c)           # forest_probe.py:61-74

    def chain_fma(a, b, n):                    # :76-80
        for _ in range(n):
            a = a * f32(1.000001) + b
            b = b * f32(0.999999) + a
        return a, b

    def chain_sel(a, b, n):                    # :82-87
        for _ in range(n):
            m = a > b
            a = jnp.where(m, a * f32(0.5) + b, b - a)
            b = jnp.where(m, b, b * f32(0.5) + a)
        return a, b

    def chain_int(a, b, n):                    # :89-95
        ai = a.astype(jnp.int32)
        bi = b.astype(jnp.int32)
        for _ in range(n):
            ai = jnp.minimum(ai + 1, 1000) ^ bi
            bi = jnp.maximum(bi - 1, -1000) + ai
        return ai.astype(f32), bi.astype(f32)

    def kernel(x_init, out_ref, st):           # :97-124
        gi = pl.program_id(0)

        @pl.when(gi == 0)
        def _():
            st[...] = x_init[...]

        def body(ei, _):
            v = st[...]
            if variant.startswith("ilp"):
                outs = []
                for j in range(4):
                    a, b = chain_fma(v[2 * j], v[2 * j + 1], k // 4)
                    outs += [a, b]
                st[...] = jnp.stack(outs)
            else:
                fn = {"fma": chain_fma, "sel": chain_sel,
                      "int": chain_int}[variant.split("_")[1]]
                a, b = fn(v[0], v[1], k)
                st[...] = jnp.stack([a, b])
            return 0

        jax.lax.fori_loop(0, EPOCHS, body, 0)

        @pl.when(gi == g - 1)
        def _():
            out_ref[...] = st[...]

    def run(x):                                # :126-136
        return pl.pallas_call(
            kernel,
            grid=(g,),
            in_specs=[pl.BlockSpec(shp, lambda t: (0,) * len(shp),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(shp, lambda t: (0,) * len(shp),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(shp, f32),
            scratch_shapes=[pltpu.VMEM(shp, f32)],
            interpret=True,
        )(x)

    return jax.jit(run)


# ---- P7: tools/forest_probe2.py:64-163, output zeroed, state returned ----

@functools.cache
def _p7_restated(variant, c, g):
    NP = 13
    shp = (NP, c, 1)
    out_shp = (g, c, 16)

    def kernel(x_init, out_ref, st_out, sti_out, st, st_i):   # :68-146
        gi = pl.program_id(0)

        @pl.when(gi == 0)
        def _():
            st[...] = x_init[...]
            st_i[...] = x_init[...].astype(jnp.int32)
            out_ref[...] = jnp.zeros(out_shp, f32)       # the port's zeros

        def body(ei, _):
            v = st[...]
            a, b = v[0], v[1]
            iv = st_i[...]
            ia, ib = iv[0], iv[1]
            for _ in range(2):
                a = a * f32(1.000001) + b
                b = b * f32(0.999999) + a

            extra_i = []
            if variant == "when_any":
                @pl.when(jnp.any(a > b * f32(1e9)))
                def _():
                    st[0] = a + f32(1.0)
            elif variant == "when_any4":
                for j in range(4):
                    @pl.when(jnp.any(a > b * f32(1e9) + f32(j)))
                    def _():
                        st[0] = a + f32(1.0)
            elif variant == "concat16":
                pieces = [a * f32(1.0 + 0.01 * j) for j in range(16)]
                out_ref[0] = jnp.concatenate(pieces, axis=1)
            elif variant == "stack13":
                st[...] = jnp.stack(
                    [a * f32(1.0 + 0.001 * j) for j in range(NP)])
            elif variant == "imod4":
                for j in range(4):
                    ia = jnp.mod(ib - ia, 20 + j)
                extra_i.append(ia)
            elif variant == "fdiv4":
                for j in range(4):
                    a = b / jnp.maximum(a, f32(1e-12))
                    b = a + b
            elif variant == "dynstore":
                out_ref[pl.ds(gi, 1)] = jnp.broadcast_to(a, (c, 16))[None]
            elif variant == "sincos":
                a = jnp.cos(a) + jnp.sin(b)
            elif variant == "costas":
                y = b * jnp.sign(a)
                ax = jnp.abs(a)
                ay = jnp.abs(y)
                z = jnp.minimum(ax, ay) / jnp.maximum(
                    jnp.maximum(ax, ay), f32(1e-30))
                z2 = z * z
                p = f32(0.0208351)
                p = p * z2 - f32(0.0851330)
                p = p * z2 + f32(0.1801410)
                p = p * z2 - f32(0.3302995)
                p = p * z2 + f32(0.9998660)
                w = z * p
                w = jnp.where(ay > ax, f32(np.pi / 2) - w, w)
                a = jnp.sign(y) * w / f32(np.pi)
            elif variant == "lcg":
                s = ia * jnp.int32(1664525) + jnp.int32(1013904223)
                s = s ^ jax.lax.shift_right_logical(s, 16)
                s = s * jnp.int32(np.int64(2246822519) - (1 << 32))
                u = jax.lax.shift_right_logical(s, 8).astype(f32) \
                    / f32(1 << 24)
                a = jnp.where(u > f32(0.5), a, b)

            st[0:2] = jnp.stack([a, b])
            if extra_i:
                st_i[0:1] = extra_i[0][None]
            return 0

        jax.lax.fori_loop(0, EPOCHS, body, 0)

        @pl.when(gi == g - 1)
        def _():
            out_ref[pl.ds(0, 1)] = jnp.broadcast_to(st[0], (c, 16))[None]
            st_out[...] = st[...]
            sti_out[...] = st_i[...]

    def run(x):                                # :148-159
        whole = lambda s: pl.BlockSpec(s, lambda t: (0, 0, 0),  # noqa: E731
                                       memory_space=pltpu.VMEM)
        return pl.pallas_call(
            kernel,
            grid=(g,),
            in_specs=[whole(shp)],
            out_specs=[whole(out_shp), whole(shp), whole(shp)],
            out_shape=[jax.ShapeDtypeStruct(out_shp, f32),
                       jax.ShapeDtypeStruct(shp, f32),
                       jax.ShapeDtypeStruct(shp, jnp.int32)],
            scratch_shapes=[pltpu.VMEM(shp, f32),
                            pltpu.VMEM(shp, jnp.int32)],
            interpret=True,
        )(x)

    return jax.jit(run)


# ---- P8: tools/forest_probe3.py:58-147, with the fixes, plane returned ----

@functools.cache
def _p8_restated(variant, c, g):
    SP = p8.SP
    if "col" in variant:                       # :59-64
        wshp, raxis = (SP, c), 0
    else:
        wshp, raxis = (c, SP), 1
    sshp = p8.state_shape(variant, c)          # :65, fixed for the rows

    def kernel(x_init, w_init, out_ref, wout_ref, st, wst):   # :67-127
        gi = pl.program_id(0)

        @pl.when(gi == 0)
        def _():
            st[...] = x_init[...]
            wst[...] = w_init[...]

        def body(ei, _):
            v = st[...]
            if variant == "tr6":
                t = jax.lax.transpose(v[0:6], (0, 2, 1))
                st[0:6] = jax.lax.transpose(t * f32(1.000001), (0, 2, 1))
            elif variant == "tr2":
                t = jax.lax.transpose(v[0:2], (0, 2, 1))
                st[0:2] = jax.lax.transpose(t * f32(1.000001), (0, 2, 1))
            elif variant.startswith("wide"):
                w = wst[...]
                a = w
                for _ in range(7):
                    a = a * f32(1.000001) + w
                    a = a * f32(0.999999) - w
                wst[...] = a
            elif variant.startswith("red"):
                w = wst[...]
                acc = []
                for j in range(6):
                    acc.append(jnp.sum(w * (w + f32(j)), axis=raxis,
                                       keepdims=True))
                r = jnp.concatenate(acc, axis=raxis)
                if raxis == 1:
                    st[0:1, :, 0:1] = jnp.sum(r, axis=1, keepdims=True)[None]
                else:
                    st[0:1, 0:1, :] = jnp.sum(r, axis=0, keepdims=True)[None]
            elif variant.startswith("roll"):
                w = wst[...]
                ax = 1 if variant == "roll_row" else 0
                if variant == "roll_row":
                    m = st[0] > f32(0.5)
                else:
                    m = st[0, 0:1, :] > f32(0.5)
                for s in (1, 2, 4, 8):
                    # the port's fold of the tool's pltpu.roll(w, -s, ax)
                    rolled = pltpu.roll(w, SP - s, ax)
                    w = jnp.where(m, rolled, w)
                wst[...] = w
            st[7:8] = v[7:8] * f32(1.0000001)
            return 0

        jax.lax.fori_loop(0, EPOCHS, body, 0)

        @pl.when(gi == g - 1)
        def _():
            out_ref[...] = st[...]
            wout_ref[...] = wst[...]

    def run(x, w):                             # :129-142
        sspec = pl.BlockSpec(sshp, lambda t: (0, 0, 0),
                             memory_space=pltpu.VMEM)
        wspec = pl.BlockSpec(wshp, lambda t: (0, 0), memory_space=pltpu.VMEM)
        return pl.pallas_call(
            kernel,
            grid=(g,),
            in_specs=[sspec, wspec],
            out_specs=[sspec, wspec],
            out_shape=[jax.ShapeDtypeStruct(sshp, f32),
                       jax.ShapeDtypeStruct(wshp, f32)],
            scratch_shapes=[pltpu.VMEM(sshp, f32), pltpu.VMEM(wshp, f32)],
            interpret=True,
        )(x, w)

    return jax.jit(run)


# ---- inputs ----

def _arrays(probe, variant, which):
    """The numpy inputs of one variant at the check size (check_args)."""
    return [a.numpy() for a in probe.check_args(variant, which)
            if isinstance(a, torch.Tensor)]


def _close(got, want, rtol=0.0, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.isfinite(want)), "non-finite reference output"
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---- plain versions against the restatements ----

@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("variant", p6.VARIANTS)
def test_p6_plain_matches_restatement(variant, which):
    x, = _arrays(p6, variant, which)
    want = np.asarray(_p6_restated(variant, C, p6.CHECK_K, p6.CHECK_G)(x))
    got = p6.chain_reference(torch.as_tensor(x), variant, p6.CHECK_K,
                             p6.CHECK_G).numpy()
    _close(got, want, rtol=1e-5 if variant.endswith("fma") else 0.0)


def _p7_tol(variant, name):
    if variant == "sincos" and name in ("out", "st"):
        return {"rtol": 1e-5, "atol": 1e-5}
    return {"rtol": 0.0 if name == "sti" else 1e-5}


@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("variant", p7.VARIANTS)
def test_p7_plain_matches_restatement(variant, which):
    x, = _arrays(p7, variant, which)
    want = _p7_restated(variant, C, p7.CHECK_G)(x)
    got = p7.constructs_reference(torch.as_tensor(x), variant, p7.CHECK_G)
    for name, gv, wv in zip(("out", "st", "sti"), got, want):
        _close(gv.numpy(), wv, **_p7_tol(variant, name))
    if variant == "dynstore":           # row g holds step g's last a
        assert np.all(np.asarray(want[0])[1:] != 0.0)


def _p8_tol(variant):
    return 1e-5 if variant.startswith(("wide", "red")) else 0.0


@pytest.mark.parametrize("which", INPUTS)
@pytest.mark.parametrize("variant", p8.VARIANTS)
def test_p8_plain_matches_restatement(variant, which):
    x, w = _arrays(p8, variant, which)
    want = _p8_restated(variant, C, p8.CHECK_G)(x, w)
    got = p8.layout_reference(torch.as_tensor(x), torch.as_tensor(w),
                              variant, p8.CHECK_G)
    for gv, wv in zip(got, want):
        _close(gv.numpy(), wv, rtol=_p8_tol(variant))
    if which == "seeded" and variant.startswith("roll"):
        # half the channels rolled by 15 samples per iteration, the others
        # untouched
        rolled = p8.state_shape(variant, C)[1] == C
        wt, w0 = (np.asarray(a) if rolled else np.asarray(a).T
                  for a in (want[1], w))
        moved = ~np.all(wt == w0, axis=1)
        np.testing.assert_array_equal(moved, x.reshape(8, C)[0] > 0.5)
        shift = 15 * p8.CHECK_G * EPOCHS
        np.testing.assert_array_equal(wt[moved],
                                      np.roll(w0, -shift, 1)[moved])


@pytest.mark.parametrize("variant", p7.VARIANTS)
def test_p7_probe_inputs_stay_finite_for_the_finite_timing(variant):
    """ns_per_iter_finite times launches of up to FINITE_G steps on the
    probe's inputs: every value they write must still be finite."""
    x = torch.as_tensor(p7.probe_inputs(C))
    for t in p7.constructs_reference(x, variant, p7.FINITE_G):
        assert torch.isfinite(t.float()).all()


# ---- the host build of the CUDA source's bodies against the plain ----

@pytest.mark.parametrize("variant", p6.VARIANTS)
def test_p6_host_build_matches_plain(variant):
    for which in INPUTS:
        args = p6.check_args(variant, which)
        want, got = p6.chain_reference(*args), p6.chain_host(*args)
        assert torch.equal(got, want), which


@pytest.mark.parametrize("variant", p7.VARIANTS)
def test_p7_host_build_matches_plain(variant):
    for which in INPUTS:
        args = p7.check_args(variant, which)
        want = p7.constructs_reference(*args)
        got = p7.constructs_host(*args)
        for name, gv, wv in zip(("out", "st", "sti"), got, want):
            if variant == "sincos":
                _close(gv.numpy(), wv.numpy(), **_p7_tol(variant, name))
            else:
                assert torch.equal(gv, wv), (which, name)


@pytest.mark.parametrize("variant", p8.VARIANTS)
def test_p8_host_build_matches_plain(variant):
    for which in INPUTS:
        args = p8.check_args(variant, which)
        want, got = p8.layout_reference(*args), p8.layout_host(*args)
        for gv, wv in zip(got, want):
            _close(gv.numpy(), wv.numpy(),
                   rtol=1e-5 if variant.startswith("red") else 0.0)


def test_p8_host_build_refuses_what_the_kernels_refuse():
    x, w = (torch.as_tensor(a) for a in p8.probe_inputs("red_col", 3))
    with pytest.raises(ValueError, match="C=3"):
        p8.layout_host(x, w, "red_col", 1)
    x, w = (torch.as_tensor(a) for a in p8.probe_inputs("tr6", 171))
    with pytest.raises(ValueError, match="C=171"):
        p8.layout_host(x, w, "tr6", 1)


# ---- wrappers and entry points without a card ----

def _cpu_args(probe):
    """A variant and its wrapper's arguments, on the CPU."""
    if probe is p6:
        return "c1_fma", (torch.as_tensor(p6.probe_inputs("c1_fma", 4)),
                          "c1_fma", 4, 2)
    if probe is p7:
        return "base", (torch.as_tensor(p7.probe_inputs(4)), "base", 2)
    x, w = (torch.as_tensor(a) for a in p8.probe_inputs("red_row", 4))
    return "red_row", (x, w, "red_row", 2)


@pytest.mark.parametrize("probe", [p6, p7, p8], ids=["P6", "P7", "P8"])
def test_kernel_wrappers_refuse_cpu_tensors(probe):
    variant, args = _cpu_args(probe)
    fn = probe.KERNELS[variant]
    n0 = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert fn.launches == n0


@pytest.mark.parametrize("probe", [p6, p7, p8], ids=["P6", "P7", "P8"])
def test_cli_exit_codes_without_a_card(probe):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    name = probe.__name__.rsplit(".", 1)[1]
    assert probe.main([name, probe.VARIANTS[0], "4"]) == 1
    assert probe.main([name, "all"]) == 1
    assert probe.main([name, "bogus"]) == 2
