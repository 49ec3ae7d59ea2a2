"""Where the port's tensors live: the card unless the caller asks for the
CPU, and never the CPU in place of a missing card."""

from __future__ import annotations

import torch


def card_or_cpu(device, caller: str) -> torch.device:
    """``device`` as a torch.device.  Raises RuntimeError for a CUDA
    device where CUDA is not available: the port's entry points default
    to the card and do not fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={device!r}): CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
