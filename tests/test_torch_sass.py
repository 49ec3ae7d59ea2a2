"""Reading SASS (probes/sass.py) on a listing in cuobjdump's form: the
functions, the loops, the register dependencies and the chain depth per
trip that chip_smoke.py prices P6 with (the card's cuobjdump runs only
there)."""

import pytest

from stm32f4_sdr_gps_torch.probes import forest_chain as p6
from stm32f4_sdr_gps_torch.probes import sass

# one sel pair a trip (forest_ops.cuh sel_pair), then the trip counter
LISTING = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_112chain_kernelILi1ELi1EEEvPKfPfii
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe20000000800 */
        /*0010*/                   MOV R2, RZ ;               /* 0x000000ff00027202 */
        /*0020*/                   FSETP.GT.AND P0, PT, R4, R5, PT ;
        /*0030*/                   FADD R6, -R4, R5 ;
        /*0040*/                   FMUL R7, R4, 0.5 ;
        /*0050*/                   FADD R7, R7, R5 ;
        /*0060*/                   FSEL R4, R7, R6, P0 ;
        /*0070*/                   FMUL R8, R5, 0.5 ;
        /*0080*/                   FADD R8, R8, R4 ;
        /*0090*/                   FSEL R5, R5, R8, P0 ;
        /*00a0*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00b0*/                   ISETP.GE.AND P1, PT, R2, R9, PT ;
        /*00c0*/              @!P1 BRA 0x20 ;
        /*00d0*/                   STG.E.128 desc[UR4][R10.64], R4 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
                Function : _ZN12_GLOBAL__N_113barrel_kernelEPKf
        /*0000*/                   EXIT ;
"""


def _chain():
    funcs = sass.functions(LISTING, r"chain_kernelILi(\d)ELi1E")
    assert list(funcs) == [("1",)]
    return funcs[("1",)]


def test_functions_and_opcodes():
    ins = _chain()
    assert [a for a, _ in ins] == list(range(0, 0x100, 0x10))
    assert sass.opcode(ins[12][1]) == "BRA"
    assert sass.opcode(ins[2][1]) == "FSETP.GT.AND"
    assert list(sass.functions(LISTING, "barrel_kernel")) == [
        ("_ZN12_GLOBAL__N_113barrel_kernelEPKf",)]


def test_loops_and_control_flow():
    ins = _chain()
    assert sass.inner_loops(ins) == [(2, 12), (15, 15)]
    succ = sass.successors(ins)
    assert succ[12] == [2, 13] and succ[14] == [] and succ[15] == [15]
    assert sass.on_cycle(succ, 5) and not sass.on_cycle(succ, 13)


@pytest.mark.parametrize("text,written,read", [
    ("FSETP.GT.AND P0, PT, R4, R5, PT", {"P0"}, {"R4", "R5"}),
    ("FSEL R4, R7, R6, P0", {"R4"}, {"R7", "R6", "P0"}),
    ("IADD3 R4, P0, PT, R2, 0x1, RZ", {"R4", "P0"}, {"R2"}),
    ("LOP3.LUT R4, R2, R3, RZ, 0x3c, !PT", {"R4"}, {"R2", "R3"}),
    ("@!P1 BRA 0x20", set(), {"P1"}),
    ("STG.E.128 desc[UR4][R10.64], R4", set(), {"UR4", "R10", "R4"}),
    ("FADD R6, -|R4|, R5.reuse", {"R6"}, {"R4", "R5"}),
])
def test_deps(text, written, read):
    assert sass.deps(text) == (written, read)


def test_chain_depth_and_loop_control():
    """The sel pair's loop-carried chain: compare, select, add, select,
    4 instructions a trip; 8 of the trip's 10 are the pair's."""
    ins = _chain()
    body = [t for _, t in ins[2:12]]
    assert sass.depth_per_trip(body) == 4
    assert sass.loop_control(body) == 2
    # two independent copies of the chain take no longer
    assert sass.depth_per_trip(body[:8] + [
        t.replace("R4", "R14").replace("R5", "R15") for t in body[:8]]) == 4


def test_latency_bound():
    """P6's least time an iteration at 1980 MHz: one chain of 64 fma
    pairs, 2 dependent FFMAs of 4 cycles each; ilp's 4 chains of 16; the
    16 chains of kc issued one FFMA a cycle."""
    assert p6.latency_bound_ns("c1_fma", 2, 2, 1980) == pytest.approx(
        64 * 2 * 4 / 1.98)
    assert p6.latency_bound_ns("ilp_fma", 2, 2, 1980) == pytest.approx(
        16 * 2 * 4 / 1.98)
    assert p6.latency_bound_ns("kc_fma", 2, 2, 1980) == pytest.approx(
        16 * 64 * 2 / 1.98)
    assert p6.latency_bound_ns("c1_sel", 4, 8, 1000) == 64 * 4 * 4
