"""Pre-track code-phase refinement (torch port of the JAX package's
track/pretrack.py).

The firmware refines the coarse acquisition code phase by exhaustively
correlating a +/-15 half-chip zone over ~20-30 rounds, then voting for
the longest chain of identical argmax phases (``tracking.c:398-499``).
Here the whole zone is correlated for all channels over E epochs at
once, its power integrated non-coherently, and the (interpolated) argmax
taken.

The JAX package runs the zone's power as one ``jax.jit`` program over a
``lax.scan``; here :func:`refine_code_phase_device` picks by device:

* :func:`pretrack_power_cuda`, the hand-written kernels
  (``csrc/pretrack.cu``), every epoch of every channel in one launch and
  the sum over epochs in a second, for tensors on a CUDA device;
* :func:`_pretrack_power`, the plain torch loop over the epochs, for
  tensors on the CPU;
* :func:`pretrack_power_host`, the kernels' arithmetic built for the
  host with g++, which the CPU tests hold against the plain version.

There is no fallback from one to the other: a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..acquire.engine import _s_over_fs, check_handoff_inputs, epochs_on
from ..config import SignalPlan, TrackConfig
from ..ops.replica import sample_replicas
from ..ops.wipeoff import carrier_wipeoff
from ..utils import graphs
from ..utils.device import card_or_cpu, readback, upload

#: half-chip offsets the kernels take at most (csrc/pretrack.cuh)
MAX_OFFSETS = 64


def _pretrack_power(
    epochs: torch.Tensor,         # (E, S)
    code_table: torch.Tensor,     # (C, 1023)
    code_phase: torch.Tensor,     # (C,)
    doppler_hz: torch.Tensor,     # (C,)
    plan: SignalPlan,
    num_offsets: int,
) -> torch.Tensor:
    """(C, K) prompt power summed over epochs at K half-chip offsets."""
    s_cnt = plan.samples_per_epoch
    dev = epochs.device
    offsets = (torch.arange(num_offsets, dtype=torch.float32, device=dev)
               - (num_offsets - 1) / 2.0) * 0.5     # half-chip grid
    code_freq = torch.full_like(code_phase, plan.chips_per_sample)
    replicas = sample_replicas(code_table, code_phase, code_freq,
                               s_cnt, offsets)      # (C, K, S)
    acc = torch.zeros((code_table.shape[0], num_offsets),
                      dtype=torch.float32, device=dev)
    phase = torch.zeros_like(doppler_hz)
    for t in range(epochs.shape[0]):
        y, phase = carrier_wipeoff(epochs[t], doppler_hz, phase,
                                   plan.sample_rate_hz)
        corr = torch.complex(
            torch.einsum("cn,ckn->ck", y.real, replicas),
            torch.einsum("cn,ckn->ck", y.imag, replicas))
        acc = acc + torch.abs(corr) ** 2
    _pretrack_power.calls += 1
    return acc


_pretrack_power.calls = 0


def _check(epochs, code_table, code_phase, doppler_hz, plan, num_offsets):
    """Raise on what the kernels and their host build do not take."""
    check_handoff_inputs(epochs, code_table, code_phase, doppler_hz)
    if epochs.shape[1] != plan.samples_per_epoch:
        raise ValueError(f"epochs: {epochs.shape[1]} samples an epoch, the "
                         f"plan {plan.samples_per_epoch}")
    if not 1 <= num_offsets <= MAX_OFFSETS:
        raise ValueError(f"num_offsets: want 1 to {MAX_OFFSETS}, got "
                         f"{num_offsets}")


def _power_args(epochs, code_table, code_phase, doppler_hz, plan,
                num_offsets):
    """The (E, C, K) complex64 scratch, the (C, K) float32 output and the
    argument list both builds of the kernels take."""
    e, s = epochs.shape
    c = code_table.shape[0]
    corr = torch.empty((e, c, num_offsets), dtype=torch.complex64,
                       device=epochs.device)
    power = torch.empty((c, num_offsets), dtype=torch.float32,
                        device=epochs.device)
    args = [epochs.data_ptr(), code_table.data_ptr(), code_phase.data_ptr(),
            doppler_hz.data_ptr(), corr.data_ptr(), power.data_ptr(), e, c,
            s, num_offsets, float(plan.chips_per_sample),
            _s_over_fs(s, plan), plan.sample_rate_hz]
    return corr, power, args


def pretrack_power_cuda(epochs, code_table, code_phase, doppler_hz,
                        plan: SignalPlan, num_offsets: int) -> torch.Tensor:
    """:func:`_pretrack_power` on the card: the correlations of every
    epoch, channel and offset in one launch, their power summed over the
    epochs in a second (csrc/pretrack.cu), with no host synchronisation.
    ``pretrack_power_cuda.launches`` counts kernel launches, two a call
    (a replayed graph adds those its capture holds, utils.graphs)."""
    from ..ops.kernel_lib import pretrack_lib

    if not epochs.is_cuda:
        raise ValueError("pretrack_power_cuda needs CUDA tensors")
    _check(epochs, code_table, code_phase, doppler_hz, plan, num_offsets)
    _, power, args = _power_args(epochs, code_table, code_phase,
                                 doppler_hz, plan, num_offsets)
    if code_table.shape[0] == 0:
        return power
    lib = pretrack_lib()
    with torch.cuda.device(epochs.device):
        stream = torch.cuda.current_stream(epochs.device).cuda_stream
        rc = lib.pretrack_power_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"pretrack kernel launch failed: CUDA error {rc}")
    pretrack_power_cuda.launches += 2
    return power


pretrack_power_cuda.launches = 0
graphs.count_launches(pretrack_power_cuda)


def pretrack_power_host(epochs, code_table, code_phase, doppler_hz,
                        plan: SignalPlan, num_offsets: int) -> tuple:
    """The kernels' arithmetic built for the host with g++
    (csrc/pretrack_host.cpp) on CPU tensors, summed in the kernels'
    order: ``(corr, power)``, the (E, C, K) complex64 correlations and
    the (C, K) power.  The check of the CUDA source on a machine without
    a GPU."""
    from ..ops.kernel_lib import host_lib

    if epochs.device.type != "cpu":
        raise ValueError("pretrack_power_host needs CPU tensors")
    _check(epochs, code_table, code_phase, doppler_hz, plan, num_offsets)
    corr, power, args = _power_args(epochs, code_table, code_phase,
                                    doppler_hz, plan, num_offsets)
    host_lib().pretrack_power_host(*args)
    return corr, power


def refine_code_phase_device(
    epochs: torch.Tensor,         # (E, S) complex epochs, on the device
    code_table: torch.Tensor,     # (C, 1023) bipolar codes
    code_phase: torch.Tensor,     # (C,) coarse code phase, chips
    doppler_hz: torch.Tensor,     # (C,) refined Doppler
    plan: SignalPlan,
    num_offsets: int,
) -> torch.Tensor:
    """(C, K) prompt power summed over the epochs at K half-chip offsets
    around each channel's code phase, on the epochs' device: the kernels
    for CUDA tensors, the plain loop for CPU tensors.  Every input stays
    where it is; only the caller's readback of the power leaves the
    card."""
    if epochs.is_cuda:
        return pretrack_power_cuda(epochs, code_table, code_phase,
                                   doppler_hz, plan, num_offsets)
    if epochs.device.type == "cpu":
        return _pretrack_power(epochs, code_table, code_phase, doppler_hz,
                               plan, num_offsets)
    raise ValueError(f"no code search for device {epochs.device}")


def code_search_power(
    samples,
    code_table,                    # (C, 1023) bipolar
    code_phase_chips: np.ndarray,  # (C,) coarse acquisition result
    doppler_hz,                    # (C,)
    plan: SignalPlan,
    cfg: TrackConfig = TrackConfig(),
    num_epochs: int | None = None,
    device="cuda",
    code_phase_device: torch.Tensor | None = None,
) -> np.ndarray:
    """The code search's (C, K) power on the host: K =
    ``cfg.pre_track_zone_halfchips + 1`` half-chip offsets centred on each
    channel's code phase, summed over the first ``num_epochs`` (else
    ``cfg.pre_track_epochs``) epochs of ``samples``, computed on
    ``device`` (the card unless the caller asks for the CPU; raises
    without a card) and read back once.

    ``code_table`` and ``doppler_hz`` are numpy arrays, each uploaded, or
    float32 tensors already on ``device``, used in place;
    ``code_phase_device`` is the float32 copy of ``code_phase_chips``
    where the caller already holds one on ``device`` (none is uploaded
    then)."""
    device = card_or_cpu(device, "refine_code_phase")
    s_cnt = plan.samples_per_epoch
    e = min(num_epochs or cfg.pre_track_epochs, len(samples) // s_cnt)
    if code_phase_device is None:
        code_phase_device = upload(code_phase_chips, device, torch.float32)
    return readback(refine_code_phase_device(
        epochs_on(samples, e, s_cnt, device),
        upload(code_table, device, torch.float32),
        code_phase_device,
        upload(doppler_hz, device, torch.float32),
        plan,
        cfg.pre_track_zone_halfchips + 1,
    ))


def refine_code_phase(
    samples,
    code_table,                    # (C, 1023) bipolar
    code_phase_chips: np.ndarray,  # (C,) coarse acquisition result
    doppler_hz,                    # (C,)
    plan: SignalPlan,
    cfg: TrackConfig = TrackConfig(),
    num_epochs: int | None = None,
    device="cuda",
    code_phase_device: torch.Tensor | None = None,
    power: np.ndarray | None = None,
) -> np.ndarray:
    """Return refined (C,) code phases (chips, sub-half-chip accurate),
    computed on ``device``: the card unless the caller asks for the CPU;
    raises without a card.

    :func:`interpolate_code_phase` of :func:`code_search_power`'s
    power (same arguments), or of ``power``, that search's (C, K) result
    where the caller holds it already on the host (the handoff, which
    also reads it for its weak-prompt check): then nothing is searched,
    uploaded or read back."""
    if power is None:
        power = code_search_power(samples, code_table, code_phase_chips,
                                  doppler_hz, plan, cfg, num_epochs, device,
                                  code_phase_device)
    return interpolate_code_phase(power, code_phase_chips)


def interpolate_code_phase(power: np.ndarray,
                           code_phase_chips: np.ndarray) -> np.ndarray:
    """Refined (C,) code phases (chips) from the code search's (C, K)
    ``power``, K half-chip offsets centred on ``code_phase_chips``: the
    peak offset, moved by a parabola through it and its neighbours."""
    k = power.shape[1]
    best = power.argmax(axis=1)
    # parabolic interpolation around the peak (clamped at zone edges)
    refined = []
    for c, b in enumerate(best):
        if 0 < b < k - 1:
            ym1, y0, yp1 = power[c, b - 1], power[c, b], power[c, b + 1]
            denom = ym1 - 2 * y0 + yp1
            frac = 0.5 * (ym1 - yp1) / denom if abs(denom) > 1e-12 else 0.0
        else:
            frac = 0.0
        off = (b - (k - 1) / 2.0 + np.clip(frac, -0.5, 0.5)) * 0.5
        refined.append((code_phase_chips[c] + off) % 1023.0)
    return np.asarray(refined)
