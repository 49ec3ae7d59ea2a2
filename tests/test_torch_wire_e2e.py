"""``probes/wire_e2e.py`` (the port's counterpart of tools/tpu_e2e.py) on
the CPU.

* ``ChunkedDeviceCapture`` equals the host conditioner
  (``reference_to_baseband``) of the same words to 1e-5 (the device
  conditioner's exact quarter-rate mix against the host's), for ranges
  that straddle chunks and a short last chunk; it holds only the chunks
  at or after the read cursor.
* A short ``capture_gen`` capture (3 s at 3 codes a bit, the generator's
  own four satellites) through ``wire_e2e.run``: every block reaches
  ``process_block`` as a tensor and no stage copies samples from the host;
  it decodes the same subframe ledger as ``Receiver.run`` on the
  host-conditioned samples of the same epochs.
* The command line with the host-conditioned ingest.
* Behind RUN_SLOW: the tool's default 29 s capture to a fix within 500 m
  on the CPU.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.probes import soak, wire_e2e
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.utils import profiling
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband

torch.set_num_threads(2)

S = 2046
W = wire_e2e.WORDS_PER_EPOCH

slow = pytest.mark.skipif(
    os.environ.get("RUN_SLOW") != "1", reason="set RUN_SLOW=1 to run"
)


@pytest.fixture(scope="module")
def short_capture():
    with tempfile.TemporaryDirectory() as d:
        return native.capture_gen(d, "wire", cib=3, duration_ms=3000,
                                  cn0=48, seed=5)


def test_chunked_capture_equals_host_conditioner():
    words = np.random.default_rng(3).integers(
        0, 1 << 16, 13 * W, dtype=np.uint16)
    host = reference_to_baseband(native.unpack_bits16(words))
    cap = wire_e2e.ChunkedDeviceCapture(words, 4, S, "cpu")
    assert cap.total_epochs == 13
    for start, n in ((0, 3), (2, 5), (3, 6), (7, 1), (9, 4), (11, 5)):
        got = cap.epochs(start, n)
        end = min(start + n, 13)
        assert got.dtype == torch.complex64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), host[start * S: end * S],
                                   rtol=0, atol=1e-5)
        need = set(range(start // 4, (end - 1) // 4 + 1))
        assert need <= set(cap._chunks) and min(cap._chunks) == start // 4
    assert cap.uploads == 4         # each chunk conditioned once


def test_wire_run_decodes_what_the_host_run_does(short_capture):
    words, truth = short_capture
    copies = profiling.counters.get("upload.samples", 0)
    out, rx = wire_e2e.run(words, truth, cib=3, device="cpu")
    assert profiling.counters.get("upload.samples", 0) == copies
    assert out["blocks"] == out["blocks_on_device"] > 5
    assert out["epochs_processed"] == 10 + 256 * out["blocks"]
    host = reference_to_baseband(native.unpack_bits16(words))
    rx_h = Receiver(wire_e2e.receiver_config(rx.config.prns, 3, 256),
                    device="cpu")
    rx_h.run(host[: out["epochs_processed"] * S])
    wire, ref = soak.ledger(rx), soak.ledger(rx_h)
    assert wire["fixes_ecef_m"] == ref["fixes_ecef_m"]
    for prn, ch in ref["channels"].items():
        got = dict(wire["channels"][prn])
        assert abs(got.pop("doppler_hz") - ch.pop("doppler_hz")) < 0.05, prn
        assert got == ch, prn
        assert ch["subframes"] >= 1, prn


def test_command_line_host_ingest(capsys):
    rc = wire_e2e.main(["--duration-ms", "1200", "--cib", "3",
                        "--ingest", "baseband", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and out["pass"] is False     # no fix in 1.2 s
    assert out["ingest"] == "baseband" and out["device"] == "cpu"
    assert out["blocks"] == out["blocks_on_device"] == 4


@slow
def test_wire_to_fix_at_the_tool_defaults():
    """The tool's defaults (29 s, 48 dBHz, 20 codes a bit, seed 5,
    256-epoch blocks and chunks) on the CPU's reference scan: the last fix
    within 500 m, every ephemeris set full."""
    with tempfile.TemporaryDirectory() as d:
        words, truth = native.capture_gen(d, "wire", cib=20,
                                          duration_ms=29_000, cn0=48, seed=5)
    out, _ = wire_e2e.run(words, truth, device="cpu")
    print(json.dumps(out))
    assert out["pass"], out
