"""The port's mesh runtime across two processes on the CPU: two ranks of
``python -m stm32f4_sdr_gps_torch.probes.multiprocess_run`` over a gloo
process group on loopback TCP, 4 positions of one 2x4 mesh each (the
counterpart of tests/test_multihost.py, whose two jax.distributed
processes hold 4 virtual devices each).  Stages 1-3 of the probe, within
its 240 s limit; each stage's check runs inside the ranks, which exit
non-zero where one fails.  The acquisition cube and the halo across the
ranks against one process's, the tracking across the rank boundary
against the unsharded scan, and the per-rank decode of 8 PRNs; each
stage's launch counts (none on the CPU).  The ranks' waiter on stand-in
processes: a rank that fails stops its peer at once and its log is
raised; ranks past their limit are stopped and both logs' tails raised.
"""

import subprocess
import sys
import time

import pytest

from stm32f4_sdr_gps_torch.probes.multiprocess_run import (
    PRNS8,
    _wait_ranks,
    launch,
)


@pytest.fixture(scope="module")
def records():
    return launch("cpu", timeout_s=240.0)


def test_ranks_hold_contiguous_positions(records):
    assert [r["rank"] for r in records] == [0, 1]
    assert [r["positions"] for r in records] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(r["device"] == "cpu" for r in records)


def test_acquisition_cube_across_ranks(records):
    for r in records:
        assert r["acquisition"]["peak_rel_err"] < 2e-4


def test_tracking_across_the_rank_boundary(records):
    # on the CPU each position runs the same reference scan as the
    # unsharded call: equal, not only within the tolerances
    assert all(r["tracking"]["bit_equal"] for r in records)


def test_decode_per_rank(records):
    assert [r["decode"]["local_prns"] for r in records] == \
        [list(PRNS8[:4]), list(PRNS8[4:])]
    errs = {r["decode"]["max_rel_pseudorange_err_m"] for r in records}
    assert len(errs) == 1 and errs.pop() < 100.0


def test_stage_launches_recorded(records):
    """Each stage's counts start from 0: no kernel launch and no plain
    call on the CPU, whose positions run the reference scan."""
    for r in records:
        assert [r[s]["blocks"] for s in ("acquisition", "tracking",
                                         "decode")] == [0, 1, 8]
        for s in ("acquisition", "tracking", "decode"):
            assert r[s]["launches"] == {"k1": 0, "k1_by_mode": {},
                                        "plain": 0}, s


def _ranks(tmp_path, *codes):
    procs, logs = [], []
    for r, code in enumerate(codes):
        logs.append(open(tmp_path / f"rank{r}.log", "w+"))
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      stdout=logs[-1],
                                      stderr=subprocess.STDOUT))
    return procs, logs


SLEEPER = "print('waiting', flush=True); import time; time.sleep(120)"


def test_wait_ranks_returns_the_logs(tmp_path):
    procs, logs = _ranks(tmp_path, "print('zero')", "print('one')")
    assert _wait_ranks(procs, logs, 60.0) == ["zero\n", "one\n"]
    for log in logs:
        log.close()


def test_a_failing_rank_stops_its_peer(tmp_path):
    procs, logs = _ranks(
        tmp_path, SLEEPER, "import sys; print('rank fault'); sys.exit(3)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"rank 1 exited 3:\nrank fault"):
        _wait_ranks(procs, logs, 60.0)
    assert time.monotonic() - t0 < 30.0
    assert procs[0].returncode < 0          # stopped, not waited for
    for log in logs:
        log.close()


def test_ranks_past_their_limit_are_stopped(tmp_path):
    procs, logs = _ranks(tmp_path, SLEEPER, SLEEPER)
    with pytest.raises(RuntimeError, match="still running after 3.0 s") \
            as err:
        _wait_ranks(procs, logs, 3.0)
    assert str(err.value).count("waiting") == 2
    assert all(p.returncode < 0 for p in procs)
    for log in logs:
        log.close()
