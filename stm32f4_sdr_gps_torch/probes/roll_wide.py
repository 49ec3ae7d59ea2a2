"""Row rolls and K1's replica barrel: the roll probes P1-P3 on the card.

Counterpart of the JAX package's TPU probe ``tools/tpu_roll_wide_probe.py``,
which pinned the hazard behind the r5 divergence of K1 (a negative
``tpu.dynamic_rotate`` at a width that is not a power of two) at the
kernel's real widths.  Its stages (``STAGES``), each printing "ALL EXACT"
or the rows that are wrong:

* ``dynu2`` / ``dynwin``: P1 (``_roll_stage.kernel``), each row r of an
  (R, W) plane rolled by -shift[r] and by +shift[r], W = 4352 / 2176;
  kernel wrapper :func:`dyn_roll_cuda`;
* ``statwin``: P2 (``stage_statwin.kernel2``), row 0 of an (R, 2176) plane
  rolled by 1, 2, 4, 8, WIN-1, WIN-2, WIN-4, WIN-8, one amount per output
  row; :func:`statwin_cuda`;
* ``barrel``: P3 (``stage_barrel.kernel``), K1's replica compose: each
  u2 row rebuilt by the folded roll of ``mc``, cut to WIN, the masked
  4-stage barrel by ``es`` (7 on the tool's inputs), then P and L; also the
  tool's check of the consumed lanes [:2048] against np.roll of u2;
  :func:`barrel_cuda`;
* ``epoch0`` / ``raw16``: where the tool held the TPU's K1 against its
  interpret mode, the port's K1 against its plain version on the card, at
  T = 1 and 16 on the tool's 60 dBHz PRN 7 scenario with
  ``emit_correlators``.

P1 and P2 run one kernel, ``roll_rows_kernel`` (``csrc/roll.cu``), P3
``barrel_kernel``, a gather of E, P and L at the composed index of the
rebuild roll, the barrel's stages and P's and L's rolls; the plain
version keeps the tool's stage-by-stage form.  Each wrapper launches for CUDA tensors, raises for
CPU tensors and counts its launches (``launches``); beside it are its
plain torch version (``PLAIN``, a torch.roll per row as the tool's jnp.roll
reference) and the one-call gather with a prebuilt index
(:func:`library_call`), the yardstick timed beside the kernel.  The row
count R is a parameter: 8 as in the tool, 32 and 128 at K1's channel
counts (the tool's inputs are tiled to R rows).

    python -m stm32f4_sdr_gps_torch.probes.roll_wide [dynu2|dynwin|statwin|barrel|epoch0|raw16|all] [rows]

exits 1 without a CUDA device, 2 on an unknown stage and 3 when a stage
finds a wrong row.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.epl import S, U2P, upsampled_code_doubled
from ..signal.ca_code import ca_table_bipolar
from .common import check_aligned16, check_tensor, queued_ms, stream

ROWS = 8
WIN = 2176                    # K1's replica window, 2048 + 128 lanes
SPAN = 15                     # K1's barrel span; es = SPAN // 2 in the tool
STAGE_SHIFTS = (1, 2, 4, 8)
SHIFTS = [0, 1, 7, 292, 1015, 1789, 2038, 2045]     # the tool's :69
STAT_AMTS = [1, 2, 4, 8, WIN - 1, WIN - 2, WIN - 4, WIN - 8]
MCS = [1, 9, 600, 1023, 1500, 2000, 2045, 2046]     # :155
CHECK_SEED = 3
CASES = ["dynu2_neg", "dynu2_pos", "dynwin_neg", "dynwin_pos", "statwin",
         "barrel"]
ODD_WIDTH = WIN - 1           # a width the 16-byte path does not take


def width(case: str) -> int:
    """The lane width of a case's input rows."""
    return U2P if case.startswith(("dynu2", "barrel")) else WIN


def _tile(values, rows: int) -> np.ndarray:
    return np.resize(np.asarray(values, np.int32), rows)


def probe_inputs(case: str, rows: int = ROWS) -> tuple:
    """The tool's inputs, tiled to ``rows``: an arange plane and the
    shifts (negated for ``_neg``) or static amounts; for the barrel the
    doubled upsampled codes of PRNs 1, 2, ... (1-8 at 8 rows), the tool's
    mc values and es = 7."""
    if case == "barrel":
        prns = [(i % 32) + 1 for i in range(rows)]
        u2 = upsampled_code_doubled(ca_table_bipolar(prns)).astype(np.float32)
        return u2, _tile(MCS, rows), np.full(rows, SPAN // 2, np.int32)
    w = width(case)
    x = np.arange(rows * w, dtype=np.float32).reshape(rows, w)
    if case == "statwin":
        return x, _tile(STAT_AMTS, rows)
    amt = _tile(SHIFTS, rows)
    return x, -amt if case.endswith("_neg") else amt


def seeded_inputs(case: str, seed: int = CHECK_SEED, rows: int = ROWS,
                  lanes: int | None = None) -> tuple:
    """Seeded inputs: uniform rows in [-1, 1) (every lane distinct), amounts
    up to three widths in size of the case's sign (either sign for
    statwin); for the barrel mc anywhere in [1, 2046] and es in [0, 15].
    ``lanes`` replaces a roll case's lane width (ODD_WIDTH: the kernel's
    scalar path)."""
    rng = np.random.default_rng(seed)
    w = lanes or width(case)
    x = rng.uniform(-1.0, 1.0, (rows, w)).astype(np.float32)
    if case == "barrel":
        return (x, rng.integers(1, S + 1, rows).astype(np.int32),
                rng.integers(0, SPAN + 1, rows).astype(np.int32))
    amt = rng.integers(-3 * w, 3 * w, rows).astype(np.int32)
    if case.endswith("_pos"):
        amt = np.abs(amt)
    elif case.endswith("_neg"):
        amt = -np.abs(amt)
    return x, amt


def check_args(case: str, which: str, device="cpu", rows: int = ROWS,
               lanes: int | None = None) -> tuple:
    """A case's kernel (and plain version) arguments on the tool's inputs
    (``which="probe"``) or the seeded ones (at ``lanes`` lanes, if
    given)."""
    arrays = (probe_inputs(case, rows) if which == "probe"
              else seeded_inputs(case, CHECK_SEED, rows, lanes))
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


# ---- plain versions ----

def roll_rows_reference(x: torch.Tensor, amt: torch.Tensor,
                        src_row: int = -1) -> torch.Tensor:
    """Plain torch version of roll_rows_kernel: row r of the result is
    row r (src_row < 0) or row src_row of x, rolled right by amt[r] as
    np.roll rolls it."""
    return torch.stack([torch.roll(x[r if src_row < 0 else src_row], a)
                        for r, a in enumerate(amt.tolist())])


def statwin_reference(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """P2's plain version: row 0 rolled by amt[r] into row r."""
    return roll_rows_reference(x, amt, 0)


def barrel_reference(u2: torch.Tensor, mc: torch.Tensor,
                     es: torch.Tensor) -> tuple:
    """P3's plain version, the tool's kernel body in torch: the rebuild
    roll of each row by the folded amount, cut to WIN, the masked barrel,
    and P, L as left rolls by one of E, P.  (E, P, L), each (R, WIN)."""
    shift = mc - 1 - SPAN // 2
    amt = torch.where(shift > 0, U2P - shift, -shift)
    bw = torch.stack([torch.roll(u2[c], a)[:WIN]
                      for c, a in enumerate(amt.tolist())])
    for s in STAGE_SHIFTS:
        bw = torch.where(((es & s) != 0)[:, None], torch.roll(bw, WIN - s, 1),
                         bw)
    pw = torch.roll(bw, WIN - 1, 1)
    return bw, pw, torch.roll(pw, WIN - 1, 1)


# ---- kernels ----

def launch_roll_rows(x: torch.Tensor, amt: torch.Tensor, src_row: int = -1,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch roll_rows_kernel (csrc/roll.cu) on an (R, W) float32 plane x
    and (R,) int32 amounts on the card; the callers count their launches.
    Where W % 4 == 0 (the kernel's 16-byte stores) ``out`` must start on a
    16-byte boundary."""
    from ..ops.kernel_lib import roll_lib

    if not x.is_cuda:
        raise ValueError("the roll kernels need CUDA tensors")
    if x.dim() != 2:
        raise ValueError(f"x: want (R, W), got {tuple(x.shape)}")
    r, w = x.shape
    check_tensor("x", x, (r, w), torch.float32, x.device)
    check_tensor("amt", amt, (r,), torch.int32, x.device)
    if not -1 <= src_row < r:
        raise ValueError(f"src_row {src_row} outside [-1, {r})")
    out = torch.empty_like(x) if out is None else out
    check_tensor("out", out, (r, w), torch.float32, x.device)
    if w % 4 == 0:
        check_aligned16(out=out)
    with torch.cuda.device(x.device):
        rc = roll_lib().roll_rows_launch(x.data_ptr(), amt.data_ptr(),
                                         out.data_ptr(), r, w, src_row,
                                         stream(x.device))
    if rc != 0:
        raise RuntimeError(f"roll_rows launch failed: CUDA error {rc}")
    return out


def dyn_roll_cuda(x, amt, out=None) -> torch.Tensor:
    """P1 on the card: each row rolled by its own amount, any sign."""
    out = launch_roll_rows(x, amt, -1, out)
    dyn_roll_cuda.launches += 1
    return out


dyn_roll_cuda.launches = 0


def statwin_cuda(x, amt, out=None) -> torch.Tensor:
    """P2 on the card: row 0 rolled by amt[r] into row r."""
    out = launch_roll_rows(x, amt, 0, out)
    statwin_cuda.launches += 1
    return out


statwin_cuda.launches = 0


def barrel_cuda(u2, mc, es, out=None) -> tuple:
    """P3 on the card: (E, P, L), each (R, WIN) float32, from u2 (R, 4352)
    float32 and mc, es (R,) int32.  ``out``, if given, is the (E, P, L)
    triple to write, each starting on a 16-byte boundary."""
    from ..ops.kernel_lib import roll_lib

    if not u2.is_cuda:
        raise ValueError("barrel_cuda needs CUDA tensors")
    r = u2.shape[0]
    check_tensor("u2", u2, (r, U2P), torch.float32, u2.device)
    for name, t in (("mc", mc), ("es", es)):
        check_tensor(name, t, (r,), torch.int32, u2.device)
    if out is None:
        out = tuple(torch.empty((r, WIN), dtype=torch.float32,
                                device=u2.device) for _ in range(3))
    for name, t in zip("EPL", out):
        check_tensor(name, t, (r, WIN), torch.float32, u2.device)
    check_aligned16(**dict(zip("EPL", out)))
    if r == 0:
        return out
    with torch.cuda.device(u2.device):
        rc = roll_lib().barrel_launch(u2.data_ptr(), mc.data_ptr(),
                                      es.data_ptr(),
                                      *(t.data_ptr() for t in out), r,
                                      stream(u2.device))
    if rc != 0:
        raise RuntimeError(f"barrel launch failed: CUDA error {rc}")
    barrel_cuda.launches += 1
    return out


barrel_cuda.launches = 0


def roll_rows_host(x: torch.Tensor, amt: torch.Tensor,
                   src_row: int = -1) -> torch.Tensor:
    """roll_rows_kernel's lanes through the g++ host build, on CPU
    tensors."""
    from ..ops.kernel_lib import host_lib

    out = torch.empty_like(x)
    if host_lib().roll_rows_host(x.data_ptr(), amt.data_ptr(), out.data_ptr(),
                                 x.shape[0], x.shape[1], src_row):
        raise ValueError("roll_rows_host refused its arguments")
    return out


def barrel_host(u2: torch.Tensor, mc: torch.Tensor, es: torch.Tensor) -> tuple:
    """barrel_kernel through the g++ host build, on CPU tensors."""
    from ..ops.kernel_lib import host_lib

    out = tuple(torch.empty((u2.shape[0], WIN)) for _ in range(3))
    if host_lib().barrel_host(u2.data_ptr(), mc.data_ptr(), es.data_ptr(),
                              *(t.data_ptr() for t in out), u2.shape[0]):
        raise ValueError("barrel_host refused its arguments")
    return out


# each case's kernel wrapper and plain version (the same arguments)
KERNELS = {"dynu2_neg": dyn_roll_cuda, "dynu2_pos": dyn_roll_cuda,
           "dynwin_neg": dyn_roll_cuda, "dynwin_pos": dyn_roll_cuda,
           "statwin": statwin_cuda, "barrel": barrel_cuda}
PLAIN = {"dynu2_neg": roll_rows_reference, "dynu2_pos": roll_rows_reference,
         "dynwin_neg": roll_rows_reference, "dynwin_pos": roll_rows_reference,
         "statwin": statwin_reference, "barrel": barrel_reference}


def library_call(case: str, args: tuple):
    """The yardstick: a function of no arguments that computes the case
    in one torch.gather, its index built here, outside the timed call.
    Rolls give an (R, W) tensor, the barrel (3, R, WIN) stacked E, P, L."""
    if case == "barrel":
        u2, mc, es = args
        r = u2.shape[0]
        shift = mc.long() - 1 - SPAN // 2
        amt = torch.where(shift > 0, U2P - shift, -shift)
        lanes = torch.arange(WIN, device=u2.device)
        off = torch.arange(3, device=u2.device)[:, None, None]
        win = (lanes[None, None, :] + off + (es.long() & 15)[None, :, None]
               ) % WIN
        idx = (win - amt[None, :, None]) % U2P
        src = u2.expand(3, r, U2P)
        return lambda: torch.gather(src, 2, idx)
    x, amt = args
    r, w = x.shape
    idx = (torch.arange(w, device=x.device)[None, :]
           - amt.long()[:, None]) % w
    src = x[:1].expand(r, w) if case == "statwin" else x
    return lambda: torch.gather(src, 1, idx)


# ---- the tool's stages ----

def rows_verdict(label: str, got: torch.Tensor, want: torch.Tensor,
                 keys: list) -> bool:
    """Print the tool's line for one (R, W) result: "ALL EXACT", or the
    key and sum |got - want| of each row that differs."""
    diff = (got.double() - want.double()).abs().sum(1).cpu().tolist()
    wrong = (got != want).any(1).cpu().tolist()
    bad = [(keys[r], diff[r]) for r in range(len(keys)) if wrong[r]]
    print(f"{label}: per-row sum|kernel - plain| "
          f"{'ALL EXACT' if not bad else f'WRONG at {bad}'}")
    return not bad


def _launch_us(case: str, args: tuple) -> float:
    kernel = KERNELS[case]
    out = kernel(*args)
    return queued_ms(lambda: kernel(*args, out=out), 5, 20) * 1e3


def _roll_stage(case: str, rows: int) -> bool:
    args = check_args(case, "probe", "cuda", rows)
    got, want = KERNELS[case](*args), PLAIN[case](*args)
    ok = rows_verdict(f"{case}({width(case)}, {rows} rows)", got, want,
                      args[1].tolist())
    print(f"{case}: {_launch_us(case, args):.2f} us per launch (device "
          f"time, queued) on {torch.cuda.get_device_name(0)}")
    return ok


def _barrel_stage(rows: int) -> bool:
    u2, mc, es = args = check_args("barrel", "probe", "cuda", rows)
    got, want = barrel_cuda(*args), barrel_reference(*args)
    keys = mc.tolist()
    ok = all([rows_verdict(f"barrel {n} ({rows} rows)", g, w, keys)
              for n, g, w in zip("EPL", got, want)])
    # the tool's own check: with es = 7, lane k < 2048 of E / P / L is
    # u2[c, mc - 1 + k] / [mc + k] / [mc + 1 + k]
    u2n, mcn = u2.cpu().numpy(), mc.cpu().numpy()
    bad = []
    for c in range(rows):
        d = [float(np.abs(t[c, :2048].cpu().numpy()
                          - np.roll(u2n[c], -(int(mcn[c]) + off))[:2048]).sum())
             for t, off in zip(got, (-1, 0, 1))]
        if sum(d):
            bad.append((int(mcn[c]), *d))
    print(f"barrel: consumed lanes [:2048] against np.roll of u2: "
          f"{'ALL EXACT' if not bad else f'WRONG at (mc,dE,dP,dL) {bad}'}")
    print(f"barrel: {_launch_us('barrel', args):.2f} us per launch (device "
          f"time, queued) on {torch.cuda.get_device_name(0)}")
    return ok and not bad


def scan_stage(n_epochs: int, emit: bool, label: str) -> bool:
    """K1 on the card against its plain version on the card, C = 1, on the
    tools' clean 60 dBHz PRN 7 scenario (code phase 300.25 chips, Doppler
    1234 Hz): |P| (and |E| with the E/L slots) per epoch, then OK when the
    floats agree to the tolerances of tests/test_pallas_scan.py:68-117 and
    the integer slots exactly, DIVERGES otherwise."""
    from ..config import BASEBAND_PLAN, TrackConfig
    from ..ops import track_scan as ts
    from ..signal.simulator import SimSat, simulate_capture
    from ..track.state import init_state

    prn, cp, dop = 7, 300.25, 1234.0
    sat = SimSat(prn=prn, doppler_hz=dop, code_phase_chips=cp, cn0_dbhz=60.0,
                 codes_in_bit=20, nav_bits=[0, 1] * 8)
    x, _ = simulate_capture([sat], num_epochs=n_epochs, seed=3)
    dev = torch.device("cuda")
    ep = torch.as_tensor(x.reshape(n_epochs, S).astype(np.complex64),
                         device=dev)
    u2 = torch.as_tensor(upsampled_code_doubled(ca_table_bipolar([prn])),
                         device=dev)
    cfg = TrackConfig(pll_bad_state_threshold=10**9, emit_correlators=emit)
    ps0 = ts.state_from_track_state(init_state(
        1, np.array([cp]), np.array([dop]), window=cfg.pll_check_window,
        device=dev))
    _, k = ts.track_scan_cuda(ps0, ep, u2, BASEBAND_PLAN, cfg)
    _, r = ts.track_scan_reference(ps0, ep, u2, BASEBAND_PLAN, cfg)
    k, r = k[:, :, 0].double().cpu(), r[:, :, 0].double().cpu()
    n = min(16, n_epochs)
    mags = [("|P|", 0)] + ([("|E|", 11), ("|L|", 13)] if emit else [])
    for name, slot in mags:
        for side, o in (("kernel", k), ("plain ", r)):
            m = torch.hypot(o[:n, slot], o[:n, slot + 1])
            print(f"{label} T={n_epochs} {name} {side}: "
                  + " ".join(f"{v:.0f}" for v in m.tolist()))
    floats = {"ip/qp": ([0, 1], 2e-2, 2.0), "code phase": ([2], 0.0, 5e-3),
              "doppler": ([3], 0.0, 0.5)}
    if emit:
        floats["E/L"] = (list(range(11, 15)), 2e-2, 2.0)
    errs, ok = {}, True
    for name, (slots, rtol, atol) in floats.items():
        d = (k[:, slots] - r[:, slots]).abs()
        errs[name] = float(d.max())
        ok &= bool((d <= atol + rtol * r[:, slots].abs()).all())
    ints = [4, 5, 6, 7, 9]
    ok &= torch.equal(k[:, ints], r[:, ints])
    print(f"{label} scan T={n_epochs}: "
          + ("OK" if ok else "DIVERGES")
          + f" (max |kernel - plain| {errs}; integer slots "
          + ("equal)" if torch.equal(k[:, ints], r[:, ints]) else "differ)"))
    return ok


STAGES = {
    "dynu2": lambda rows: all([_roll_stage("dynu2_neg", rows),
                               _roll_stage("dynu2_pos", rows)]),
    "dynwin": lambda rows: all([_roll_stage("dynwin_neg", rows),
                                _roll_stage("dynwin_pos", rows)]),
    "statwin": lambda rows: _roll_stage("statwin", rows),
    "barrel": _barrel_stage,
    "epoch0": lambda rows: scan_stage(1, True, "epoch0"),
    "raw16": lambda rows: scan_stage(16, True, "raw16"),
}


def main(argv) -> int:
    which = argv[1] if len(argv) > 1 else "all"
    if which != "all" and which not in STAGES:
        print(f"usage: {argv[0]} [{'|'.join(STAGES)}|all] [rows]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("roll_wide: needs a CUDA device", file=sys.stderr)
        return 1
    rows = int(argv[2]) if len(argv) > 2 else ROWS
    names = list(STAGES) if which == "all" else [which]
    return 0 if all([STAGES[n](rows) for n in names]) else 3


if __name__ == "__main__":
    sys.exit(main(sys.argv))
