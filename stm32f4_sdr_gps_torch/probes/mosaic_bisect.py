"""The roll at a power-of-two width, K2 and K1: the probe P4 on the card.

Counterpart of the JAX package's TPU probe ``tools/tpu_mosaic_bisect.py``,
which bisected the r5 divergence of K1 between the TPU and interpret mode.
Its stages (``STAGES``):

* ``roll`` / ``roll-neg``: P4 (``stage_roll.kernel``), each row r of an
  (R, 256) plane rolled by +shift[r] / -shift[r], shifts 0, 1, 2, 3, 5,
  17, 100, 255: P1's kernel (``roll_rows_kernel``, ``csrc/roll.cu``) at
  W = 256, behind its own wrapper :func:`roll_cuda`; "ALL EXACT" or the
  rows that are wrong;
* ``epl``: where the tool held the TPU's K2 against the reference
  correlator, the port's K2 (``csrc/epl.cu``) against its plain version on
  the card, one epoch of the tool's 60 dBHz PRN 7 signal on 8 channels;
* ``scan1``: K1 against its plain version on the card, 16 epochs, C = 1.

:func:`roll_cuda` launches for CUDA tensors, raises for CPU tensors and
counts its launches; beside it are its plain torch version
(``PLAIN``) and the one-call gather yardstick
(``roll_wide.library_call``).

    python -m stm32f4_sdr_gps_torch.probes.mosaic_bisect [roll|roll-neg|epl|scan1|all]

exits 1 without a CUDA device, 2 on an unknown stage and 3 when a stage
finds a wrong row.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.epl import S, upsampled_code_doubled
from ..signal.ca_code import ca_table_bipolar
from .common import queued_ms
from .roll_wide import (launch_roll_rows, roll_rows_reference, rows_verdict,
                        scan_stage)

ROWS = 8
W = 256
SHIFTS = [0, 1, 2, 3, 5, 17, 100, 255]              # the tool's :74
CHECK_SEED = 3
CASES = ["roll_pos", "roll_neg"]


def probe_inputs(case: str, rows: int = ROWS) -> tuple:
    """The tool's (arange plane, shifts), tiled to ``rows``; negated
    shifts for ``roll_neg``."""
    x = np.arange(rows * W, dtype=np.float32).reshape(rows, W)
    amt = np.resize(np.asarray(SHIFTS, np.int32), rows)
    return x, -amt if case == "roll_neg" else amt


def seeded_inputs(case: str, seed: int = CHECK_SEED,
                  rows: int = ROWS) -> tuple:
    """Uniform rows in [-1, 1) and amounts of the case's sign up to three
    widths in size."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (rows, W)).astype(np.float32)
    amt = np.abs(rng.integers(-3 * W, 3 * W, rows)).astype(np.int32)
    return x, -amt if case == "roll_neg" else amt


def check_args(case: str, which: str, device="cpu", rows: int = ROWS) -> tuple:
    """The kernel's (and plain version's) arguments on the tool's inputs
    (``which="probe"``) or the seeded ones."""
    arrays = (probe_inputs(case, rows) if which == "probe"
              else seeded_inputs(case, CHECK_SEED, rows))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def roll_cuda(x, amt, out=None) -> torch.Tensor:
    """P4 on the card: each row of an (R, 256) float32 plane rolled by its
    own int32 amount, any sign."""
    out = launch_roll_rows(x, amt, -1, out)
    roll_cuda.launches += 1
    return out


roll_cuda.launches = 0

KERNELS = dict.fromkeys(CASES, roll_cuda)
PLAIN = dict.fromkeys(CASES, roll_rows_reference)


def _roll_stage(case: str) -> bool:
    args = check_args(case, "probe", "cuda")
    got = roll_cuda(*args)
    ok = rows_verdict(f"{case} ({W} lanes)", got, roll_rows_reference(*args),
                      args[1].tolist())
    us = queued_ms(lambda: roll_cuda(*args, out=got), 5, 20) * 1e3
    print(f"{case}: {us:.2f} us per launch (device time, queued) on "
          f"{torch.cuda.get_device_name(0)}")
    return ok


def _epl_stage() -> bool:
    """K2 against its plain version on one epoch of the tool's signal."""
    from ..config import BASEBAND_PLAN
    from ..ops import epl
    from ..signal.simulator import SimSat, simulate_capture

    prn, cp, dop = 7, 300.25, 1234.0
    sat = SimSat(prn=prn, doppler_hz=dop, code_phase_chips=cp, cn0_dbhz=60.0,
                 codes_in_bit=20, nav_bits=[0, 1] * 8)
    x, _ = simulate_capture([sat], num_epochs=1, seed=3)
    dev = torch.device("cuda")
    args = [torch.as_tensor(a, device=dev) for a in (
        x[:S].astype(np.complex64),
        upsampled_code_doubled(ca_table_bipolar([prn] * 8)),
        np.full(8, cp, np.float32), np.full(8, dop, np.float32),
        np.zeros(8, np.float32))]
    fs = BASEBAND_PLAN.sample_rate_hz
    got = epl.epl_correlate_cuda(*args, fs)
    want = epl.epl_correlate_halfchip(*args, fs)
    g, w = got.abs()[0].tolist(), want.abs()[0].tolist()
    print("epl kernel |E,P,L| = " + ", ".join(f"{v:.0f}" for v in g)
          + "; plain = " + ", ".join(f"{v:.0f}" for v in w))
    d = (torch.view_as_real(got) - torch.view_as_real(want)).abs()
    ok = bool((d <= 1e-3 + 1e-4 * torch.view_as_real(want).abs()).all())
    print(f"epl: {'OK' if ok else 'WRONG'} (max |kernel - plain| "
          f"{float(d.max()):.3g}, rtol 1e-4 / atol 1e-3)")
    return ok


STAGES = {"roll": lambda: _roll_stage("roll_pos"),
          "roll-neg": lambda: _roll_stage("roll_neg"),
          "epl": _epl_stage,
          "scan1": lambda: scan_stage(16, False, "scan1")}


def main(argv) -> int:
    which = argv[1] if len(argv) > 1 else "all"
    if which != "all" and which not in STAGES:
        print(f"usage: {argv[0]} [{'|'.join(STAGES)}|all]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("mosaic_bisect: needs a CUDA device", file=sys.stderr)
        return 1
    names = list(STAGES) if which == "all" else [which]
    return 0 if all([STAGES[n]() for n in names]) else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv))
