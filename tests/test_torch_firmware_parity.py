"""The port's Receiver held to the firmware oracle on the capture of
tests/test_firmware_parity.py (12 s of wire format at 48 dBHz, seed 11,
PRNs 24 and 7 with 500 Hz-grid hints), on the CPU, with that suite's
own bars: the oracle tracks and syncs; the nav bits equal the oracle's
on the shared 20 ms grid up to one global polarity (>= 300 matched, at
most 3 % unmatched); Doppler within 5 Hz and code delay within 0.32 chip.

The port runs on the reference scan and on the tracking-scan kernel's
plain version (the kernel's semantics: the half-chip replica, the
polynomial Costas).  The bars are applied twice: by the JAX suite's own
test functions, called on the port's results, and by the port's copy in
probes/firmware_parity.py (what chip_smoke.py applies on the card).
Last, the port's nav bits equal the JAX Receiver's on the same baseband,
bit for bit and epoch for epoch."""

import numpy as np
import pytest
import torch

import tests.test_firmware_parity as jax_suite
from stm32f4_sdr_gps_tpu.config import ReceiverConfig as JReceiverConfig
from stm32f4_sdr_gps_tpu.config import TrackConfig as JTrackConfig
from stm32f4_sdr_gps_tpu.runtime.receiver import Receiver as JReceiver
from stm32f4_sdr_gps_torch.probes import firmware_parity as fp
from stm32f4_sdr_gps_torch.runtime import native
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband

torch.set_num_threads(2)

SUITE = "firmware_parity"
# in_kernel_scan on the CPU: False = the reference scan, True = the
# tracking-scan kernel's plain version
BACKENDS = {"reference_scan": False, "kernel_plain": True}


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    assert native.get_lib() is not None, "native library unavailable"
    words, truth = fp.generate(SUITE, str(tmp_path_factory.mktemp("fw")))
    fw = fp.run_oracle(SUITE, words)
    bb = reference_to_baseband(native.unpack_bits16(words))
    return fw, truth, bb, {}


def _port_run(capture, backend):
    """The port's Receiver on the capture, once per backend: (report,
    nav bits)."""
    _, _, bb, runs = capture
    if backend not in runs:
        cfg = fp.receiver_config(SUITE, in_kernel_scan=BACKENDS[backend])
        _, report, bits, _, _ = fp.run_receiver(bb, cfg, device="cpu")
        runs[backend] = report, bits
    return runs[backend]


@pytest.fixture(scope="module", params=list(BACKENDS))
def port(request, capture):
    """The JAX suite's (fw, bits, channels, truth) tuple, with the
    port's Receiver in place of the JAX one."""
    fw, truth, _, _ = capture
    report, bits = _port_run(capture, request.param)
    return fw, bits, {ch.prn: ch for ch in report.channels}, truth


def test_firmware_pipeline_tracks_and_syncs(capture):
    fw, truth, _, _ = capture
    jax_suite.test_firmware_pipeline_tracks_and_syncs((fw, None, None, truth))
    fp.check_oracle_tracks(fw, truth)


def test_nav_bits_bit_exact_between_pipelines(port):
    jax_suite.test_nav_bits_bit_exact_between_pipelines(port)
    fw, bits, _, _ = port
    for prn, (agree, disagree, unmatched) in fp.check_bits_exact(
            fw, bits).items():
        assert agree + disagree >= 300 and min(agree, disagree) == 0, prn


def test_loop_states_agree_between_pipelines(port):
    jax_suite.test_loop_states_agree_between_pipelines(port)
    fw, _, channels, _ = port
    for prn, (d_dop, d_code) in fp.check_loop_states(fw, channels).items():
        assert abs(d_dop) < 5.0 and abs(d_code) < 0.32, prn


def test_nav_bits_equal_jax_receiver(capture):
    """The port on the reference scan and the JAX Receiver (the reference
    scan on the CPU) on the same baseband push the same nav bits at the
    same epochs."""
    _, _, bb, _ = capture
    cfg = fp.receiver_config(SUITE, in_kernel_scan=False)
    _, bits = _port_run(capture, "reference_scan")
    jrx = JReceiver(JReceiverConfig(
        prns=cfg.prns, doppler_hints_hz=cfg.doppler_hints_hz,
        track=JTrackConfig(pll_bad_state_threshold=10**9),
        enable_position=False, track_block_epochs=cfg.track_block_epochs))
    jbits = {p: [] for p in cfg.prns}
    push = jrx._push_channel_bit

    def hook(ch, value, epoch):
        jbits[ch.prn].append((int(epoch), int(value)))
        return push(ch, value, epoch)

    jrx._push_channel_bit = hook
    jrx.run(np.asarray(bb))
    for prn in cfg.prns:
        assert len(bits[prn]) > 250, prn
        assert bits[prn] == jbits[prn], prn
