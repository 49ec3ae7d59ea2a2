"""What the probes' kernel wrappers and entry points share: argument
checks, the current stream, and CUDA-event timing."""

from __future__ import annotations

import time

import numpy as np
import torch


def check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype,
                 device) -> None:
    """Raise ValueError unless ``t`` has ``shape`` and ``dtype``, lies on
    ``device`` and is contiguous."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned16(**tensors) -> None:
    """Raise ValueError unless each tensor's data starts on a 16-byte
    boundary (the kernels' 16-byte loads and stores)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(data_ptr {t.data_ptr():#x})")


def stream(device) -> int:
    """The current CUDA stream of ``device`` as an int for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def event_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` calls of ``fn`` of its CUDA-event time in ms,
    after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# the probes' device sleep before a timed run: ~5 ms at the H100's 1.98 GHz,
# time for the host to enqueue ten launches
SLEEP_CYCLES = 10_000_000


def queued_ms(fn, reps: int, calls: int,
              sleep_cycles: int = 200_000_000) -> float:
    """Median over ``reps`` of the device time per call of ``calls`` calls
    of ``fn``, queued behind a device sleep of ``sleep_cycles`` (the
    default ~0.1 s) so the host enqueues them all before the device
    reaches them: the device time per call, without the host's per-call
    time even where that is longer.  Keep ``calls`` times the kernels per
    call under the launch queue's depth (about a thousand), and the sleep
    longer than the host takes to enqueue them."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def warm_up(fn, seconds: float = 0.3) -> None:
    """Call ``fn`` (and synchronise) for ``seconds``: the card's clocks
    rise under load, and a timing taken straight after idle reads low."""
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
