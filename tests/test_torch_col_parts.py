"""The col-kernel part probe (probes/col_parts.py) on the CPU: every
build's patched source, the anchor check and the command line.  Its
builds run only on the card."""

import pytest
import torch

from stm32f4_sdr_gps_torch.ops import kernel_lib
from stm32f4_sdr_gps_torch.probes import col_parts as cp


def _shipped():
    with open(f"{kernel_lib.CSRC}/forest.cu") as f:
        return f.read()


@pytest.mark.parametrize("build", cp.BUILDS)
def test_patched_source(build):
    """Each patch applies once; the shipped build is the source itself;
    no_exchange leaves no exchange in the col loops."""
    cu = cp.patched_source(build)
    if build == "col":
        assert cu == _shipped()
        return
    assert cu != _shipped()
    for old, new in cp.PATCHES[build]:
        assert new in cu
    if build == "no_exchange":
        assert "push_halo<CG>(s_bar" not in cu
        assert "push4(dst" not in cu and "bar_expect(&s_bar[FULL" not in cu
    if build == "sm_ids":
        assert "%%smid" in cu
    if build == "slots4":
        assert cu.count("s_slot[sl]") == 2 and "it + 4 < iters" in cu


def test_missing_anchor_fails():
    with pytest.raises(RuntimeError, match="anchor found 0 times"):
        cp._replace_once("int x;", "int y;", "")
    with pytest.raises(RuntimeError, match="anchor found 2 times"):
        cp._replace_once("a a", "a", "b")
    with pytest.raises(ValueError):
        cp.patched_source("slots8")


@pytest.mark.parametrize("argv,rc", [(["x", "abc"], 2), (["x", "3"], 2),
                                     (["x"], 1), (["x", "4", "32"], 1)])
def test_cli_exit_codes(monkeypatch, argv, rc):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cp.main(argv) == rc
