"""Entry point: one block of the port's per-block production program.

Counterpart of the JAX package's ``__graft_entry__.entry()``: 32 channels
x 96 epochs through the tracking scan (the kernel on a CUDA device, its
plain version on the CPU) carrying its own kernel state, followed by the
on-device block digest — the program ``Receiver.process_block`` runs per
block (runtime.receiver._track_and_digest_carried).  It runs on the card
unless the caller asks for the CPU, and raises where there is no card.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import BASEBAND_PLAN, TrackConfig
from .ops.epl import upsampled_code_doubled
from .ops.track_scan import state_from_track_state
from .runtime.receiver import _track_and_digest_carried
from .signal.ca_code import ca_table_bipolar
from .track.state import init_state
from .utils.device import card_or_cpu


def entry(device="cuda", num_channels: int = 32, num_epochs: int = 96):
    """(fn, example_args): ``fn(ps, epochs, u2) -> (ps2, track_state,
    digest)`` with the arguments made from seed 0 on ``device``."""
    device = card_or_cpu(device, "entry")
    plan = BASEBAND_PLAN
    cfg = TrackConfig(in_kernel_scan=True)
    s = plan.samples_per_epoch
    rng = np.random.default_rng(0)
    epochs = torch.as_tensor(
        (rng.standard_normal((num_epochs, s))
         + 1j * rng.standard_normal((num_epochs, s))).astype(np.complex64),
        device=device)
    state = init_state(
        num_channels,
        rng.uniform(0, 1023, num_channels),
        rng.uniform(-5000, 5000, num_channels),
        window=cfg.pll_check_window,
        device=device,
    )
    u2 = torch.as_tensor(upsampled_code_doubled(
        ca_table_bipolar([(i % 32) + 1 for i in range(num_channels)])),
        device=device)

    def fn(ps, epochs, u2):
        return _track_and_digest_carried(ps, epochs, u2, plan, cfg, 100, True)

    return fn, (state_from_track_state(state), epochs, u2)
