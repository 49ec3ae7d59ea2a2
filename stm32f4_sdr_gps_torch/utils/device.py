"""Where the port's tensors live: the card unless the caller asks for the
CPU, and never the CPU in place of a missing card; and the counted
copies between host and device (:func:`upload`, :func:`readback`)."""

from __future__ import annotations

import numpy as np
import torch

from .profiling import count


def card_or_cpu(device, caller: str) -> torch.device:
    """``device`` as a torch.device.  Raises RuntimeError for a CUDA
    device where CUDA is not available: the port's entry points default
    to the card and do not fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={device!r}): CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def upload(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``, counted as
    one ``upload`` (``utils.profiling.count``) where ``data`` is host
    data (a numpy array, a list, a tuple).  The count does not depend on
    ``device``, so a CPU run counts the copies the card would make.  A
    tensor is passed through uncounted."""
    if not isinstance(data, torch.Tensor):
        count("upload")
    return torch.as_tensor(data, dtype=dtype, device=device)


def readback(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``, counted as one ``readback`` (on the card a
    device-to-host copy, which waits for the work queued before it)."""
    count("readback")
    return t.cpu().numpy()
