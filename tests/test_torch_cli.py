"""The port's command line (``python -m stm32f4_sdr_gps_torch``) with
``--device cpu``: the smoke runs of tests/test_sensitivity.py:68-90, the
acquisition table against the JAX package's CLI (the same rows in PRN,
detection and Doppler to 0.1 Hz, as printed), ``run`` with its RTCM and
checkpoint outputs and the bits16 wire format, and the default device:
the card, so without one the command fails."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_tpu.__main__ import main as j_main
from stm32f4_sdr_gps_tpu.signal.simulator import SimSat, simulate_capture
from stm32f4_sdr_gps_torch.__main__ import main

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _table(out):
    """(PRN, detected, Doppler) rows of the acquisition table."""
    rows = []
    for line in out.splitlines()[1:]:
        f = line.split()
        det = f[1] == "*"
        rows.append((int(f[0]), det, f[2 if det else 1]))
    return rows


def test_cli_acquire_matches_jax(tmp_path, capsys):
    sat = SimSat(prn=17, doppler_hz=2500.0, code_phase_chips=50.0,
                 cn0_dbhz=46.0)
    x, _ = simulate_capture([sat], num_epochs=12, seed=5)
    cap = str(tmp_path / "cap.npy")
    np.save(cap, x)
    args = ["acquire", cap, "--prns", "15-20", "--epochs", "10"]
    assert main(args + ["--device", "cpu"]) == 0
    got = _table(capsys.readouterr().out)
    assert j_main(args) == 0
    want = _table(capsys.readouterr().out)
    assert sorted(got) == sorted(want)
    assert len(got) == 6
    assert [r[0] for r in got if r[1]] == [17]
    assert abs(float(got[0][2]) - 2500.0) < 10.0


def test_cli_simulate_and_run(tmp_path, capsys):
    cap = str(tmp_path / "sim.npy")
    rtcm = str(tmp_path / "out.rtcm")
    ck = str(tmp_path / "ck")
    assert main(["simulate", "--out", cap, "--seconds", "1.5",
                 "--sat", "7:1500:47:68.1"]) == 0
    assert main(["run", cap, "--prns", "7", "--device", "cpu",
                 "--rtcm-out", rtcm, "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "TRACKING" in out
    assert f"checkpoint saved to {ck}" in out
    assert os.path.exists(ck + ".npz")
    # 1.5 s completes no ephemeris, so no RTCM frame is written
    assert not os.path.exists(rtcm)


def test_cli_run_bits16(tmp_path, capsys):
    """``run --format bits16``: the reference front end's packed 1-bit
    words, conditioned to baseband on the way in."""
    from stm32f4_sdr_gps_torch.config import REFERENCE_PLAN
    from stm32f4_sdr_gps_torch.signal.capture import pack_bits_lsb16
    from stm32f4_sdr_gps_torch.signal.simulator import SimSat as TSimSat
    from stm32f4_sdr_gps_torch.signal.simulator import (
        simulate_capture as t_simulate,
    )

    sat = TSimSat(prn=19, doppler_hz=2500.0, cn0_dbhz=52.0, delay_ms=4.3)
    x, _ = t_simulate([sat], num_epochs=400, plan=REFERENCE_PLAN, seed=17)
    path = str(tmp_path / "cap.bin")
    pack_bits_lsb16(x).tofile(path)
    assert main(["run", path, "--format", "bits16", "--prns", "19",
                 "--device", "cpu"]) == 0
    row = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.split()[:1] == ["19"]]
    assert row and "TRACKING" in row[0]


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cap = str(tmp_path / "cap.npy")
    np.save(cap, np.zeros(12 * 2046, np.complex64))
    res = subprocess.run(
        [sys.executable, "-m", "stm32f4_sdr_gps_torch", "acquire", cap,
         "--prns", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode != 0
    assert "acquire(device='cuda')" in res.stderr
