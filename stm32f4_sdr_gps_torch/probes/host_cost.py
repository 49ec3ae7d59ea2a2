"""The host side of the receiver loop against the channel count (the port
of the JAX package's tools/host_cost_probe.py).

    python -m stm32f4_sdr_gps_torch.probes.host_cost [--block-epochs 2000]
        [--blocks 30] [--channels 32 128 256] [--device cuda]

The tracking kernel's capacity is a device number; the per-channel host
work that follows each block (``Receiver._consume_digest``: nav framer
bit pushes, subframe decode, ChannelStatus bookkeeping) grows linearly
with the channels and bounds the SYSTEM.  This probe times exactly that
path on digests that carry a real LNAV stream on every channel (preamble
lock, parity and subframe decode all exercised), one bit per
``codes_in_bit`` epochs, with the solve left out (its cost is set by its
cadence, not by the channel count).

Prints one JSON line per channel count: host ms a block, us an epoch and
an epoch-channel, the host-only real-time multiple, the subframes
decoded, and the host CPU's model (this is a host number).  The
Receiver is made on ``--device`` (the card by default; it raises without
one unless given ``cpu``); the timed loop is host code either way.
Combined with the per-block program's multiple by probes/capacity.py.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

from ..config import CODES_IN_BIT, ReceiverConfig
from ..runtime.digest import BlockDigest
from ..runtime.receiver import Receiver
from ..signal.nav_message import build_bitstream
from ..signal.scenarios import CANONICAL_EPH


def cpu_model() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``; where that says
    "unknown" (some virtual machines), its vendor, family and model numbers and
    clock instead; else what ``platform`` reports.  With the CPU count."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                   # the first processor's block
                key, _, val = line.partition(":")
                info[key.strip()] = val.strip()
    except OSError:
        pass
    name = info.get("model name", "")
    if name in ("", "unknown") and "vendor_id" in info:
        name = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                f"model {info.get('model', '?')} at "
                f"{info.get('cpu MHz', '?')} MHz (model name unknown)")
    name = name or platform.processor() or platform.machine()
    return f"{name}, {os.cpu_count()} CPUs"


def make_digests(n_chan: int, block_epochs: int, n_blocks: int,
                 cib: int = CODES_IN_BIT) -> list:
    """``n_blocks`` BlockDigests (numpy leaves, as ``digest_to_host``
    gives them) carrying a real decodable LNAV bitstream per channel,
    each channel offset by its index mod 37 so the framer states
    differ."""
    bits = build_bitstream(dict(CANONICAL_EPH, week=2290),
                           start_tow_6s=58810, num_subframes=5,
                           subframe_ids=(5, 1, 2, 3, 4))
    bits = np.tile(bits, 8)                 # long enough for any run
    rng = np.random.default_rng(0)
    cap = block_epochs // cib + 8
    digests = []
    bit_cursor = np.arange(n_chan) % 37     # desync the channels
    for b in range(n_blocks):
        epoch0 = b * block_epochs
        n_bits = block_epochs // cib
        bit_value = np.zeros((cap, n_chan), np.int8)
        bit_epoch = np.zeros((cap, n_chan), np.int32)
        for k in range(n_bits):
            idx = (bit_cursor + k) % len(bits)
            bit_value[k] = bits[idx]
            bit_epoch[k] = epoch0 + k * cib
        bit_cursor += n_bits
        digests.append(BlockDigest(
            bit_count=np.full(n_chan, n_bits, np.int32),
            bit_value=bit_value,
            bit_epoch=bit_epoch,
            code_phase_chips=rng.uniform(0, 1023, n_chan).astype(np.float32),
            code_phase_filtered=rng.uniform(0, 1023, n_chan)
            .astype(np.float32),
            doppler_hz=rng.uniform(-4e3, 4e3, n_chan).astype(np.float32),
            doppler_sum=rng.uniform(-4e6, 4e6, n_chan).astype(np.float32),
            snr_db=np.full(n_chan, 12.0, np.float32),
            period_sync_ok=np.ones(n_chan, bool),
            sync_any_loss=np.zeros(n_chan, bool),
            last_unsync_epoch=np.full(n_chan, -1, np.int32),
            cn0_m2=np.full(n_chan, 1e5, np.float32),
            cn0_m4=np.full(n_chan, 1.5e10, np.float32),
            cn0_n=np.full(n_chan, block_epochs - 2 * n_bits, np.int32),
            flip_hist=np.zeros((cib, n_chan), np.int32),
            first_ip_sign=np.ones(n_chan, np.int8),
            last_ip_sign=np.ones(n_chan, np.int8),
            code_phase_first=rng.uniform(0, 1023, n_chan)
            .astype(np.float32),
            swap_residue=np.zeros(n_chan, np.int32),
        ))
    return digests


def receiver(n_chan: int, device="cuda") -> Receiver:
    """A fresh Receiver of ``n_chan`` channels (PRNs 1-32 cycled) with the
    solve disabled: it is cadence-bound (one fit per 500 ms whatever the
    channel count), while this probe isolates the per-channel work."""
    cfg = ReceiverConfig(prns=tuple((i % 32) + 1 for i in range(n_chan)),
                         enable_position=False)
    return Receiver(cfg, device=device)


def decode(rx: Receiver, digests: list, block_epochs: int) -> float:
    """The first digest as a warm-up block (the framers' preamble search
    ramps up), then the rest through ``rx._consume_digest``; returns the
    host seconds of the timed blocks."""
    rx._consume_digest(digests[0], block_epochs)
    rx.epoch_cursor += block_epochs
    t0 = time.perf_counter()
    for d in digests[1:]:
        rx._consume_digest(d, block_epochs)
        rx.epoch_cursor += block_epochs
    return time.perf_counter() - t0


def measure(n_chan: int, block_epochs: int, n_blocks: int,
            device="cuda") -> dict:
    """The host cost of ``n_blocks - 1`` timed blocks at ``n_chan``
    channels; the digests are built before the timed window."""
    rx = receiver(n_chan, device)
    digests = make_digests(n_chan, block_epochs, n_blocks)
    wall = decode(rx, digests, block_epochs)
    n = n_blocks - 1
    return {
        "channels": n_chan,
        "block_epochs": block_epochs,
        "host_ms_per_block": wall / n * 1e3,
        "host_us_per_epoch": wall / n / block_epochs * 1e6,
        "host_us_per_epoch_per_chan": wall / n / block_epochs / n_chan * 1e6,
        "host_only_rt_x": block_epochs * 1e-3 / (wall / n),
        "subframes_decoded": sum(ch.subframe_count for ch in rx.channels),
        "host_cpu": cpu_model(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block-epochs", type=int, default=2000)
    ap.add_argument("--blocks", type=int, default=30)
    ap.add_argument("--channels", type=int, nargs="+", default=[32, 128, 256])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for n_chan in args.channels:
        print(json.dumps(measure(n_chan, args.block_epochs, args.blocks,
                                 args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
