"""The capture generator: a scene's satellites as samples, made on the
device in float64 and a few large calls a chunk, then copied once into
host memory in the front end's own form (``frontends/<kind>.py``).

The physics follow the port's ``signal/simulator.py`` (code and carrier
from one delay polynomial, 50 bps bits on code-period boundaries,
complex or real-IF signal at a calibrated C/N0 against unit-variance
noise) and the wire packing ``native/capture_gen.cpp`` (1-bit signs,
16 to a uint16 word, LSB first).  ``gen_np`` is a frozen NumPy copy of
the noiseless signal and the packing that the CPU tests hold this module
to.  A front end states ``complex`` (complex samples, or real IF at
``if_hz``) and ``sample_rate_hz``; its module makes the host form.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import physics as ph
from . import spec


def samples_per_epoch(fe: dict) -> int:
    return int(round(fe["sample_rate_hz"] * 1e-3))


def signal_chunk(scene, fe: dict, sample0: int, n: int,
                 device) -> torch.Tensor:
    """The noiseless signal of samples [sample0, sample0 + n): complex128
    for a complex front end, float64 for a real one."""
    fs = fe["sample_rate_hz"]
    real = not fe["complex"]
    t = (torch.arange(n, dtype=torch.float64, device=device) + sample0) / fs
    acc = torch.zeros(n, dtype=torch.float64 if real else torch.complex128,
                      device=device)
    for sat in scene.sats:
        code = torch.as_tensor(ph.ca_bipolar(sat.prn), device=device)
        bits = torch.as_tensor(1.0 - 2.0 * sat.bits.astype(np.float64),
                               device=device)
        dop = t * (sat.doppler_hz + 0.5 * sat.doppler_rate_hz_s * t)
        chips = ph.CODE_RATE_HZ * (t + dop / ph.FREQ_L1_HZ - sat.delay_s)
        idx = torch.floor(chips).to(torch.int64)
        period = torch.div(idx, ph.CODE_LENGTH, rounding_mode="floor")
        bit = torch.remainder(torch.div(period, scene.codes_in_bit, rounding_mode="floor"),
                              bits.shape[0])
        dc = code[torch.remainder(idx, ph.CODE_LENGTH)] * bits[bit]
        phase = sat.carrier_phase_cycles + fe.get("if_hz", 0.0) * t + dop
        phase = 2.0 * math.pi * (phase - torch.floor(phase))
        amp = math.sqrt(10.0 ** (sat.cn0_dbhz / 10.0) / fs)
        if real:
            acc += (amp * math.sqrt(2.0)) * dc * torch.cos(phase)
        else:
            acc += amp * dc * torch.polar(torch.ones_like(phase), phase)
    return acc


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """Signs of real samples (a multiple of 16) as int32 words holding
    uint16 values, LSB first (bit 1 = sample >= 0)."""
    b = (x >= 0).to(torch.int32).reshape(-1, 16)
    w = torch.bitwise_left_shift(
        torch.ones(16, dtype=torch.int32, device=x.device),
        torch.arange(16, dtype=torch.int32, device=x.device))
    return (b * w).sum(dim=1, dtype=torch.int32)


def synthesize(scene, fe: dict, n_epochs: int, seed: int, device,
               chunk_epochs: int = 500, frontend=None) -> np.ndarray:
    """The whole capture in host memory, in the front end's host form:
    ``frontend``'s, or that of ``frontends/<fe["kind"]>.py`` beside this
    file.  The noise comes from a generator on ``device`` seeded with
    ``seed``; the same seed gives the same capture."""
    if frontend is None:
        frontend = spec.frontend(fe["kind"])
    spe = samples_per_epoch(fe)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    upe = frontend.units_per_epoch(fe)
    out = np.empty(n_epochs * upe, dtype=frontend.HOST_DTYPE)
    raw = out.view(np.uint8)
    per = upe * out.itemsize                        # bytes an epoch
    for e0 in range(0, n_epochs, chunk_epochs):
        k = min(chunk_epochs, n_epochs - e0)
        n = k * spe
        s = signal_chunk(scene, fe, e0 * spe, n, device)
        if fe["complex"]:
            noise = torch.randn(n, 2, generator=gen, device=device,
                                dtype=torch.float32) * math.sqrt(0.5)
            x = s.to(torch.complex64) + torch.view_as_complex(noise)
        else:
            x = s.to(torch.float32) + torch.randn(
                n, generator=gen, device=device, dtype=torch.float32)
        host = frontend.to_host(x, fe).reshape(-1).view(torch.uint8)
        torch.from_numpy(raw[e0 * per: (e0 + k) * per]).copy_(host)
    return out
