"""What a run loads: nothing whose top-level name is JAX's or the JAX
package's, and the reference nothing of the program either."""

import json
import os
import subprocess
import sys

from . import helpers

ROOT = os.path.dirname(helpers.HERE)

_PROBE = """
import json, sys
for m in {mods!r}:
    __import__(m)
{extra}
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""


def _top_level(mods, extra=""):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(mods=mods, extra=extra)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    # a whole cold start from wire words on the CPU, so the program's lazy imports load
    extra = """
from benchmark import run, spec
from benchmark.tests import helpers
import tempfile
cell = helpers.write_cell(
    tempfile.mkdtemp(),
    dict(helpers.WIRE_COLDSTART, capture_epochs=300, warm_starts=0),
    helpers.config(wire=True))
r = run.Run(cell, 7, "cpu"); r.setup(); r.window(0.01); r.finish()
r.judge()
for m in cell.per_layer:
    spec.reader(m["name"])
import benchmark.trace, benchmark.hostinfo, benchmark.readings
"""
    mods = _top_level(["benchmark.run", "benchmark.jobs"], extra)
    assert "stm32f4_sdr_gps_torch" in mods
    for bad in ("jax", "jaxlib", "flax", "stm32f4_sdr_gps_tpu"):
        assert bad not in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(["benchmark.truth", "benchmark.physics",
                       "benchmark.scene", "benchmark.gen",
                       "benchmark.gen_np", "benchmark.roofline"])
    for bad in ("jax", "jaxlib", "flax", "stm32f4_sdr_gps_tpu",
                "stm32f4_sdr_gps_torch"):
        assert bad not in mods


def test_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fw4_wire_coldstart", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
