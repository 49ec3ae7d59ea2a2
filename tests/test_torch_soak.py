"""The port's streaming soak (probes/soak.py, the counterpart of the JAX
package's tools/soak.py) on the CPU: the native SPSC ring, the paced
producer thread with the firmware staleness guard's drop accounting,
and the Receiver fed from the ring.

The CPU tracks slower than real time, so zero drops at a real pace is a
card measurement (chip_smoke.py phase 20).  Here: a ring that holds the
whole capture, where nothing can drop whatever the host's speed; and a
200 ms ring at 20x real time, which a CPU run cannot hold, where the
drops must be counted exactly."""

import json
import os

import pytest
import torch

from stm32f4_sdr_gps_torch.config import ReceiverConfig
from stm32f4_sdr_gps_torch.probes import soak
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband

torch.set_num_threads(2)


def test_whole_capture_ring_drops_nothing(tmp_path):
    """... and the streamed run decodes exactly what a direct
    Receiver.run of the same capture does (the ring, the pacing and the
    block-wise conditioning change nothing)."""
    out = soak.run_soak(capture_s=4, rate_x=1.0, block_epochs=500,
                        ring_ms=4000, device="cpu", state_dir=str(tmp_path))
    assert out["total_epochs"] == 4000 and out["head_epochs"] == 510
    assert out["dropped_epochs"] == 0
    assert out["pushed_epochs"] == out["total_epochs"] - out["head_epochs"]
    assert out["consumed_epochs"] == out["total_epochs"]
    assert out["channels_tracking"] == 4
    assert out["ring_high_water_ms"] <= out["ring_capacity_ms"]
    assert out["ok"]

    words, truth = soak.capture(4, 48.0, 9, str(tmp_path))   # the same file
    rx = Receiver(ReceiverConfig(prns=tuple(s["prn"] for s in truth["sats"]),
                                 track_block_epochs=500), device="cpu")
    rx.run(reference_to_baseband(native.unpack_bits16(words)))
    direct = soak.ledger(rx)
    assert all(c["bits"] > 0 for c in direct["channels"].values())
    assert {k: out[k] for k in direct} == direct


def test_small_ring_counts_its_drops(tmp_path, capsys):
    """Through the command line: one JSON line, exit code 1."""
    rc = soak.main(["--capture-s", "4", "--rate-x", "20", "--ring-ms", "200",
                    "--block-epochs", "100", "--device", "cpu",
                    "--state-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not out["ok"]
    assert out["dropped_epochs"] > 0
    assert (out["pushed_epochs"] + out["dropped_epochs"]
            == out["total_epochs"] - out["head_epochs"])
    # every epoch pushed is consumed, none twice
    assert out["consumed_epochs"] == out["head_epochs"] + out["pushed_epochs"]
    assert out["ring_high_water_ms"] <= 200


def test_soak_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError,
                       match=r"run_soak\(device='cuda'\).*device='cpu'"):
        soak.run_soak(capture_s=1)


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="set RUN_SLOW=1 to run")
def test_soak_capture_fix_turns_on_one_boundary(tmp_path):
    """The card soak's 30 s capture (seed 9, one frame) through four
    pipelines on the CPU: the JAX Pallas kernel in interpret mode, the
    JAX reference scan, the port's kernel plain version and its reference
    scan.  Their subframe ledgers agree but for PRN 2's last boundary
    (its bit edge sits mid-epoch), which lies on one of two adjacent
    epochs; a pipeline makes fixes exactly when it lies on the later one
    (the earlier one comes from a 2-2 tie of boundary residues that
    dejitter_boundary floors, in both packages).  Prints each ledger."""
    from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
    from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
    from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
    from stm32f4_sdr_gps_torch.config import TrackConfig

    words, truth = soak.capture(30, 48.0, 9, str(tmp_path))
    bb = reference_to_baseband(native.unpack_bits16(words))
    prns = tuple(s["prn"] for s in truth["sats"])
    runs = {
        "jax_kernel": JReceiver(JReceiverConfig(
            prns=prns, track_block_epochs=500, track=JTrackConfig(
                in_kernel_scan=True, pallas_interpret=True))),
        "jax_reference_scan": JReceiver(JReceiverConfig(
            prns=prns, track_block_epochs=500,
            track=JTrackConfig(in_kernel_scan=False))),
        "port_kernel_plain": Receiver(ReceiverConfig(
            prns=prns, track_block_epochs=500,
            track=TrackConfig(in_kernel_scan=True)), device="cpu"),
        "port_reference_scan": Receiver(ReceiverConfig(
            prns=prns, track_block_epochs=500,
            track=TrackConfig(in_kernel_scan=False)), device="cpu"),
    }
    ledgers = {}
    for name, rx in runs.items():
        rep = rx.run(bb)
        ledgers[name] = ({c.prn: c.subframe_time_ms for c in rep.channels},
                         len(rep.solutions))
        print(name, {c.prn: list(c.boundary_residues)
                     for c in rep.channels}, ledgers[name])
    prn2 = {ledger[2] for ledger, _ in ledgers.values()}
    assert max(prn2) - min(prn2) <= 1
    for ledger, fixes in ledgers.values():
        assert {p: b for p, b in ledger.items() if p != 2} == {
            p: b for p, b in ledgers["jax_reference_scan"][0].items()
            if p != 2}
        assert (fixes > 0) == (ledger[2] == max(prn2))
