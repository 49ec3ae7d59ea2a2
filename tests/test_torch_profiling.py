"""Profiler.device_trace (the port's counterpart of the JAX package's
jax.profiler trace, utils/profiling.py) on the CPU: a torch.profiler
trace around a block, written into the log directory as a Chrome trace
that names the ops run inside it and no op run outside it."""

import json

import pytest
import torch

from stm32f4_sdr_gps_torch.entry import entry_jnp_scan
from stm32f4_sdr_gps_torch.utils.profiling import Profiler

torch.set_num_threads(2)


def _names(logdir):
    with open(logdir / "trace.json") as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_device_trace_names_the_ops_inside(tmp_path):
    a = torch.randn(64, 64)
    torch.fft.fft(a)                        # outside the trace
    prof = Profiler()
    with prof.device_trace(str(tmp_path / "log")) as yielded:
        torch.mm(a, a)
    assert yielded is None
    names = _names(tmp_path / "log")
    assert "aten::mm" in names
    assert not any(n and "fft" in n for n in names)


def test_device_trace_of_a_tracking_block(tmp_path):
    """Around one call of the reference-scan block program: the trace
    holds its per-epoch torch ops (the carrier's sin/cos among them)."""
    fn, args = entry_jnp_scan(device="cpu", num_channels=2, num_epochs=3)
    with Profiler().device_trace(str(tmp_path)):
        fn(*args)
    names = _names(tmp_path)
    assert {"aten::sin", "aten::cos"} & names or "aten::sincos" in names


def test_device_trace_stops_on_error(tmp_path):
    prof = Profiler()
    with pytest.raises(ValueError):
        with prof.device_trace(str(tmp_path)):
            raise ValueError("inside")
    # the profiler was stopped: a new trace starts cleanly
    with prof.device_trace(str(tmp_path)):
        torch.ones(3).sum()
    assert "aten::sum" in _names(tmp_path)
