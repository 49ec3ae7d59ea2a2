"""The port's entry points run on the card unless the caller asks for the
CPU, and raise where there is no card: acquisition (the FFT cube, the
epoch vote, the host fine-Doppler search), the DFT tables, the pre-track
code refinement, the tracking state and its conversions from the JAX
package's, the code FFT table, the wire-format conditioner, the
checkpoint loader, the Receiver, entry() (the last two also in
test_torch_receiver.py; the CLI in test_torch_cli.py) and
entry_jnp_scan(), and the mesh, MeshReceiver, dryrun_multichip and the
multi-process probe (the soak in test_torch_soak.py).  On the CPU
each call passes device="cpu" (CPU devices to the mesh)."""

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch import convert
from stm32f4_sdr_gps_torch.acquire.engine import (acquire,
                                                  acquire_epoch_vote,
                                                  refine_doppler)
from stm32f4_sdr_gps_torch.config import BASEBAND_PLAN, ReceiverConfig
from stm32f4_sdr_gps_torch.entry import (dryrun_multichip, entry,
                                         entry_jnp_scan)
from stm32f4_sdr_gps_torch.ops.correlate import (code_fft_conj,
                                                 dft_tables_device)
from stm32f4_sdr_gps_torch.parallel.mesh import make_mesh
from stm32f4_sdr_gps_torch.probes import multiprocess_run
from stm32f4_sdr_gps_torch.runtime.checkpoint import (load_receiver,
                                                      save_receiver)
from stm32f4_sdr_gps_torch.runtime.mesh_receiver import MeshReceiver
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal.ca_code import ca_table_bipolar
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband_device
from stm32f4_sdr_gps_torch.track.pretrack import refine_code_phase
from stm32f4_sdr_gps_torch.track.state import TrackState, init_state
from stm32f4_sdr_gps_torch.utils.device import card_or_cpu

S = BASEBAND_PLAN.samples_per_epoch
_X = np.zeros(12 * S, np.complex64)


def _load_receiver(tmp_path, **kw):
    """load_receiver of a checkpoint saved by a CPU receiver."""
    rx = Receiver(ReceiverConfig(prns=(1,)), device="cpu")
    return load_receiver(save_receiver(str(tmp_path / "ck"), rx), **kw)


def _track_state_from_numpy(**kw):
    leaves = [np.zeros((2, 4) if f == "ip_sign_window" else 2,
                       np.int8 if f == "ip_sign_window" else np.float32)
              for f in TrackState._fields]
    return convert.track_state_from_numpy(leaves, **kw)

CALLS = {
    "acquire": lambda **kw: acquire(_X, [1, 2], BASEBAND_PLAN, **kw),
    "refine_code_phase": lambda **kw: refine_code_phase(
        _X, ca_table_bipolar([1]), np.array([10.0]), np.array([0.0]),
        BASEBAND_PLAN, num_epochs=2, **kw),
    "init_state": lambda **kw: init_state(2, np.zeros(2), np.zeros(2), **kw),
    "code_fft_conj": lambda **kw: code_fft_conj([1, 2], BASEBAND_PLAN, **kw),
    "Receiver": lambda **kw: Receiver(ReceiverConfig(prns=(1,)), **kw),
    "entry": lambda **kw: entry(num_channels=2, num_epochs=2, **kw),
    "entry_jnp_scan": lambda **kw: entry_jnp_scan(num_channels=2,
                                                  num_epochs=2, **kw),
    "acquire_epoch_vote": lambda **kw: acquire_epoch_vote(
        _X, [1], BASEBAND_PLAN, num_epochs=2, **kw),
    "refine_doppler": lambda **kw: refine_doppler(
        _X, 1, 10.0, 0.0, BASEBAND_PLAN, num_epochs=2, **kw),
    "dft_tables_device": lambda **kw: dft_tables_device(8, **kw),
    "reference_to_baseband_device": lambda **kw:
        reference_to_baseband_device(np.zeros(8, np.uint16), **kw),
    "track_state_from_numpy": _track_state_from_numpy,
    "scan_state_from_jax": lambda **kw: convert.scan_state_from_jax(
        np.zeros((16, 2, 1)), np.zeros((14, 2, 1)), np.zeros((4, 2, 1)),
        **kw),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_default_device_is_the_card(name):
    """Called without a device, as the JAX package's counterparts are
    called, each raises on a machine without a card, and names the way
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError,
                       match=rf"{name}\(device='cuda'\).*device='cpu'"):
        CALLS[name]()


@pytest.mark.parametrize("name", list(CALLS))
def test_cpu_on_request(name):
    CALLS[name](device="cpu")


def test_card_or_cpu():
    assert card_or_cpu("cpu", "f") == torch.device("cpu")
    assert card_or_cpu(torch.device("cpu"), "f").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"f\(device='cuda:0'\)"):
            card_or_cpu("cuda:0", "f")


def test_load_receiver_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        assert _load_receiver(tmp_path).device.type == "cuda"
        return
    with pytest.raises(RuntimeError,
                       match=r"Receiver\(device='cuda'\).*device='cpu'"):
        _load_receiver(tmp_path)
    assert _load_receiver(tmp_path, device="cpu").device.type == "cpu"


MESH_CALLS = {
    "make_mesh": (lambda: make_mesh(time=2),
                  r"make_mesh\(devices=None\).*CUDA.*devices=\['cpu'\]"),
    "make_mesh_cuda_devices": (
        lambda: make_mesh(devices=["cuda"] * 2),
        r"make_mesh\(device='cuda'\).*device='cpu'"),
    "MeshReceiver": (lambda: MeshReceiver(ReceiverConfig(prns=(1,))),
                     r"make_mesh\(devices=None\).*CUDA"),
    "dryrun_multichip": (lambda: dryrun_multichip(8),
                         r"dryrun_multichip\(device='cuda'\).*device='cpu'"),
    "multiprocess_run": (
        lambda: multiprocess_run.main(["0", "1", "0", "--captures", "."]),
        r"multiprocess_run\(device='cuda'\).*device='cpu'"),
    "multiprocess_run_launch": (
        lambda: multiprocess_run.launch(),
        r"multiprocess_run\.launch\(device='cuda'\).*device='cpu'"),
}


@pytest.mark.parametrize("name", list(MESH_CALLS))
def test_mesh_entry_points_default_to_the_card(name):
    """The mesh, the MeshReceiver, the dry run and the multi-process
    probe run on the card unless given CPU devices: without a card they
    raise before any work (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call, match = MESH_CALLS[name]
    with pytest.raises(RuntimeError, match=match):
        call()


def test_mesh_receiver_on_cpu_devices():
    rx = MeshReceiver(ReceiverConfig(prns=(1, 2)),
                      make_mesh(time=1, devices=["cpu"] * 2))
    assert rx.device == torch.device("cpu") and rx.mesh.size == 2
