"""The kernels' build cache (ops/kernel_lib.py) on the g++ host route.

A library's file name must change when its source or any header it
includes from the source directory changes, so that an edited header
never loads a stale library; and each library's functions get their own
argument lists.
"""

import ctypes

import pytest

from stm32f4_sdr_gps_torch.ops import kernel_lib

GXX = ["g++"] + kernel_lib.GXX_FLAGS

FILES = {
    "probe.cpp": '#include "top.h"\n'
                 'extern "C" int probe_value() { return TOP + NESTED; }\n',
    "top.h": '#pragma once\n#include "nested.h"\n#define TOP 10\n',
    "nested.h": '#pragma once\n#define NESTED 1\n',
}
EDITS = {"probe.cpp": ("TOP + NESTED", "TOP + NESTED + 100"),
         "top.h": ("TOP 10", "TOP 20"),
         "nested.h": ("NESTED 1", "NESTED 2")}
WANT = {"probe.cpp": 111, "top.h": 21, "nested.h": 12}


def _value(lib_path):
    fn = ctypes.CDLL(lib_path).probe_value
    fn.restype = ctypes.c_int
    return fn()


@pytest.mark.parametrize("edited", sorted(EDITS))
def test_edit_builds_a_new_library(tmp_path, edited):
    src = tmp_path / "csrc"
    src.mkdir()
    for name, text in FILES.items():
        (src / name).write_text(text)
    out = str(tmp_path / "build")

    def build():
        return kernel_lib._build("probe", GXX, ["probe.cpp"], csrc=str(src),
                                 build_dir=out)

    first = build()
    assert _value(first) == 11
    assert build() == first
    assert kernel_lib.build_info["probe"]["cached"]
    old, new = EDITS[edited]
    (src / edited).write_text(FILES[edited].replace(old, new))
    second = build()
    assert second != first
    assert _value(second) == WANT[edited]


def test_each_library_binds_its_own_signatures():
    lib = kernel_lib.host_lib()
    assert lib.epl_host.argtypes[-1] is ctypes.c_float
    assert len(lib.epl_host.argtypes) == 8
    assert len(lib.track_scan_host.argtypes) == 10


# ptxas -v lines of one instantiation of the tracking scan, a function
# without spills and one with, as nvcc prints them for sm_90a
K1_ENTRY = ("_ZN4anon17track_scan_kernelIN5track4ModeILi0ELb0ELb0EEEEE"
            "vPKfi")
PTXAS_LOG = f"""ptxas info    : 1402 bytes gmem
ptxas info    : Compiling entry function '{K1_ENTRY}' for 'sm_90a'
ptxas info    : Function properties for {K1_ENTRY}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 102 registers, used 1 barriers
ptxas info    : Compile time = 108.136 ms
ptxas info    : Compiling entry function '_Z10epl_kernelPKfS0_' for 'sm_90a'
ptxas info    : Function properties for _Z10epl_kernelPKfS0_
    256 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13barrel_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z13barrel_kernelPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 2 barriers, 8704 bytes smem, 392 bytes cmem[0]
"""


def test_ptxas_report():
    k1 = kernel_lib.ptxas_report(PTXAS_LOG, "track_scan_kernel")
    assert k1 == [{"name": K1_ENTRY, "stack": 0, "spill_stores": 0,
                   "spill_loads": 0, "registers": 102, "smem": 0,
                   "barriers": 1}]
    k2 = kernel_lib.ptxas_report(PTXAS_LOG, "epl_kernel")
    assert [(k["stack"], k["spill_stores"], k["spill_loads"],
             k["registers"], k["smem"]) for k in k2] == [(256, 8, 12, 40, 0)]
    p3 = kernel_lib.ptxas_report(PTXAS_LOG, "barrel_kernel")
    assert [(k["registers"], k["smem"], k["barriers"]) for k in p3] == [
        (24, 8704, 2)]
    assert kernel_lib.ptxas_report("cached", "track_scan_kernel") == []


def test_cached_library_keeps_its_build_log(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    for name, text in FILES.items():
        (src / name).write_text(text)
    flags = GXX + ["-Wall", "-Wunused-variable"]
    (src / "probe.cpp").write_text(FILES["probe.cpp"]
                                   + "static int unused_probe_var;\n")
    first = kernel_lib._build("probe", flags, ["probe.cpp"], csrc=str(src),
                              build_dir=str(tmp_path / "build"))
    log = kernel_lib.build_info["probe"]["log"]
    assert "unused_probe_var" in log
    assert not kernel_lib.build_info["probe"]["cached"]
    assert kernel_lib._build("probe", flags, ["probe.cpp"], csrc=str(src),
                             build_dir=str(tmp_path / "build")) == first
    assert kernel_lib.build_info["probe"] == {"seconds": 0.0, "cached": True,
                                              "log": log, "path": first}
