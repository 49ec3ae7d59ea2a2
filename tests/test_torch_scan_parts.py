"""The K1 epoch-part probe (probes/scan_parts.py) on the CPU: every
build's patched sources, the anchor check and the command line.  Its
builds run only on the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from stm32f4_sdr_gps_torch.ops import kernel_lib
from stm32f4_sdr_gps_torch.probes import scan_parts as sp


def _shipped(name):
    with open(f"{kernel_lib.CSRC}/{name}") as f:
        return f.read()


@pytest.mark.parametrize("build", sp.BUILDS)
def test_patched_sources(build):
    files = sp.patched_sources(build)
    cu, cuh = files["track_scan.cu"], files["track_epoch.cuh"]
    if build in sp.PARTS:
        assert cuh == _shipped("track_epoch.cuh")
        for old, new in sp.PATCHES:
            assert cu.count(new) == 1
        assert cu.count("scan_parts_rec") >= 4
    else:
        assert cu == _shipped("track_scan.cu")
        n = build.split("_")[1]
        assert f"constexpr int K1_THREADS = {n};" in cuh
        assert sp.THREADS_ANCHOR not in cuh


def test_patches_leave_the_shipped_kernel_alone():
    """With every macro 0 the patched kernel is the shipped one: each
    patch adds only code under an SP_ macro or SP_REPLAY."""
    cu = _shipped("track_scan.cu")
    assert "SP_" not in cu and "scan_parts_rec" not in cu
    for old, new in sp.PATCHES[1:]:
        assert "SP_" in new


def test_missing_anchor_fails():
    with pytest.raises(RuntimeError, match="anchor found 0 times"):
        sp._replace_once("int x;", "int y;", "", "track_scan.cu")
    with pytest.raises(RuntimeError, match="anchor found 2 times"):
        sp._replace_once("a a", "a", "b", "track_scan.cu")
    with pytest.raises(ValueError):
        sp.patched_sources("threads_96")


@pytest.mark.parametrize("argv,rc", [(["x", "abc"], 2), (["x", "0"], 2),
                                     (["x"], 1), (["x", "4", "32"], 1)])
def test_cli_exit_codes(monkeypatch, argv, rc):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sp.main(argv) == rc
