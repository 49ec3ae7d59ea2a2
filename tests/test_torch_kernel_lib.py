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
    assert kernel_lib.build_info["probe"]["log"] == "cached"
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
