"""The port imports without JAX and without the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "stm32f4_sdr_gps_torch")

# the modules ported from the JAX package's weak-signal chain, capture
# ingest, checkpoint, RTCM and command line, its mesh and multi-process
# runtime, the entry points, the profiler, the streaming soak, the
# firmware-oracle suites, the robustness suites, the wire-to-fix run, and
# the host-cost, capacity and sensitivity probes, and the captured
# programs
NEW_MODULES = ("track.aided_sync", "io.bits", "io.rtcm3", "signal.capture",
               "runtime.checkpoint", "__main__", "parallel.mesh",
               "parallel.streaming", "runtime.mesh_receiver",
               "runtime.multiprocess", "runtime.native",
               "probes.multiprocess_run", "probes.mesh_gather", "entry",
               "utils.profiling", "probes.soak", "probes.firmware_parity",
               "probes.stress", "probes.wire_e2e", "probes.host_cost",
               "probes.capacity", "probes.sensitivity", "probes.ext_pll",
               "probes.deep_cold", "utils.graphs")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import stm32f4_sdr_gps_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" and sys.modules[m] is not None
       or m.startswith("jax.") or m.startswith("stm32f4_sdr_gps_tpu")]
assert not bad, bad
print(" ".join(names))
print(len(names))
"""


def test_port_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr
    # every module of the package was imported
    n_files = sum(
        f.endswith(".py") and f != "__init__.py"
        for _, _, files in os.walk(PKG) for f in files)
    n_pkgs = sum("__init__.py" in files for _, _, files in os.walk(PKG)) - 1
    assert int(res.stdout.split()[-1]) == n_files + n_pkgs
    imported = res.stdout.split()[:-1]
    for mod in NEW_MODULES:
        assert f"stm32f4_sdr_gps_torch.{mod}" in imported, mod
