"""The port imports without JAX and without the JAX package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "stm32f4_sdr_gps_torch")

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
