"""The system under test, driven as the cell's traffic says: the only
module of the benchmark that calls the program.

* ``replay``: a closed loop of jobs, one at a time, each a fresh
  ``Receiver`` over a whole capture, alternating between the run's
  captures: the cold start as ``Receiver.run`` makes it, then
  ``process_block`` over ``block_epochs`` at a time.  ``ingest`` says how
  the samples reach it: ``host`` hands each block over as a slice of
  complex64 host memory (a replayed file); ``wire_chunks`` uploads
  ``chunk_epochs`` of SPI words at a time and conditions them on the
  card, each block a view of them.
* ``coldstart``: a closed loop of cold starts, each a fresh ``Receiver``
  handed ``window_epochs`` of a capture at an offset drawn from the
  seed: ``acquire_all`` and ``start_tracking``, ended by a synchronise.
  ``ingest`` says how the window reaches it: ``host`` hands it complex64
  host memory; ``wire`` uploads its SPI words and conditions them on the
  card first, inside the timed start (a receiver powering on).

Each step returns the epochs it tracked; each finished job or start
leaves a record of plain numbers for ``truth`` to judge.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband_device

WORDS_PER_EPOCH = 1023
S = 2046


def receiver_config(cfg: dict, traffic: dict,
                    control: bool = False) -> ReceiverConfig:
    """The configuration's receiver.  Its control is the shortcut that
    would tempt a later change: a replay solves half as often as the
    configuration's cadence; a cold start acquires on half the
    non-coherent epochs (and is judged on the acquisition's own,
    unrefined Doppler, ``Run.judge(handoff="acq")``)."""
    rc = cfg["receiver"]
    block = traffic.get("block_epochs", 1000)
    acq = AcqConfig()
    period = rc["solve_period_ms"]
    if control and traffic["kind"] == "coldstart":
        acq = dataclasses.replace(
            acq, noncoherent_epochs=acq.noncoherent_epochs // 2)
    elif control:
        period = 2 * max(period, block)
    return ReceiverConfig(
        prns=tuple(rc["prns"]), track_block_epochs=block,
        solve_period_ms=period, acq=acq,
        track=TrackConfig(codes_in_bit=cfg["nav"].get("codes_in_bit", 20)))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WireChunks:
    """Whole-epoch ranges of a wire capture as complex64 baseband on
    the device: ``chunk_epochs`` of words uploaded and conditioned at a
    time (the port's ``probes/wire_e2e.ChunkedDeviceCapture``), the
    chunks behind the cursor dropped.  ``condition_s`` is the host clock
    around each upload and conditioning, ended by a synchronise."""

    def __init__(self, words: np.ndarray, chunk_epochs: int, device):
        self.words = words
        self.chunk = chunk_epochs
        self.device = device
        self.total_epochs = len(words) // WORDS_PER_EPOCH
        self._chunks: dict = {}
        self.condition_s = 0.0

    def _get(self, i: int) -> torch.Tensor:
        c = self._chunks.get(i)
        if c is None:
            w0 = i * self.chunk * WORDS_PER_EPOCH
            w1 = min(w0 + self.chunk * WORDS_PER_EPOCH,
                     self.total_epochs * WORDS_PER_EPOCH)
            t0 = time.perf_counter()
            c = reference_to_baseband_device(self.words[w0:w1],
                                             device=self.device)
            _sync(self.device)
            self.condition_s += time.perf_counter() - t0
            self._chunks[i] = c
        return c

    def epochs(self, start: int, n: int) -> torch.Tensor:
        end = min(start + n, self.total_epochs)
        i0, i1 = start // self.chunk, (end - 1) // self.chunk
        parts = [self._get(i) for i in range(i0, i1 + 1)]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        for k in [k for k in self._chunks if k < i0]:
            del self._chunks[k]
        off = (start - i0 * self.chunk) * S
        return flat[off: off + (end - start) * S]


def _eph_fields(eph) -> dict:
    if not eph.has_full_set:
        return None
    return {k: getattr(eph, k) for k in (
        "A", "e", "i0", "OMG0", "omg", "M0", "deln", "OMGd", "idot", "crc",
        "crs", "cuc", "cus", "cic", "cis", "toes", "f0", "f1", "f2", "tgd",
        "iode", "iodc", "week")}


class ReplayJob:
    """One job: a fresh Receiver over capture ``capture``."""

    def __init__(self, data, capture: int, rcfg: ReceiverConfig,
                 traffic: dict, device):
        self.capture = capture
        self.rx = Receiver(rcfg, device=device)
        self.block = rcfg.track_block_epochs
        self.acq = rcfg.acq.noncoherent_epochs
        self.total = traffic["job_epochs"]
        self.wire = (WireChunks(data, traffic["chunk_epochs"], device)
                     if traffic["ingest"] == "wire_chunks" else None)
        self.data = data
        self.pos = None

    @property
    def done(self) -> bool:
        return self.pos is not None and self.pos + self.block > self.total

    def _samples(self, start: int, n: int):
        if self.wire is not None:
            return self.wire.epochs(start, n)
        return self.data[start * S: (start + n) * S]

    def step(self) -> int:
        rx = self.rx
        if self.pos is None:
            # Receiver.run's cold start; the wire ingest hands it the
            # first window of conditioned epochs (probes/wire_e2e.run)
            if self.wire is not None:
                x = self._samples(0, max(256 + self.acq, self.wire.chunk))
            else:
                x = self.data
            rx.acquire_all(x)
            rx.start_tracking(x[self.acq * S:], start_epoch=self.acq)
            rx.epoch_cursor = self.acq
            self.pos = self.acq
            return 0
        rx.process_block(self._samples(self.pos, self.block))
        self.pos += self.block
        return self.block

    @property
    def condition_s(self) -> float:
        return self.wire.condition_s if self.wire is not None else 0.0

    def record(self) -> dict:
        rx = self.rx
        fixes = [(int(e), np.asarray(s.rr[:3], float).tolist(),
                  None if s.vel is None else np.asarray(s.vel, float).tolist())
                 for e, s in zip(rx.solution_epochs, rx.solutions)]
        return dict(capture=self.capture,
                    live=[ch.prn for ch in rx.channels],
                    eph={ch.prn: _eph_fields(ch.eph) for ch in rx.channels
                         if _eph_fields(ch.eph) is not None},
                    fixes=fixes, start_epoch=self.acq, end_epoch=self.pos,
                    block=self.block,
                    subframes={ch.prn: ch.subframe_count
                               for ch in rx.channels},
                    cn0={ch.prn: ch.cn0_dbhz for ch in rx.channels})


class ColdStart:
    """One cold start on a window of capture ``capture`` at ``offset``.
    ``condition_s`` is the host clock around the wire ingest's upload
    and conditioning, ended by a synchronise (0 for host ingest)."""

    def __init__(self, data, capture: int, offset: int,
                 rcfg: ReceiverConfig, traffic: dict, device):
        self.capture, self.offset = capture, offset
        self.rx = Receiver(rcfg, device=device)
        self.acq = rcfg.acq.noncoherent_epochs
        n = traffic["window_epochs"]
        self.wire = traffic.get("ingest", "host") == "wire"
        per = WORDS_PER_EPOCH if self.wire else S
        self.x = data[offset * per: (offset + n) * per]
        self.device = torch.device(device)
        self.wall_s = None
        self.condition_s = 0.0

    def run(self) -> None:
        t0 = time.perf_counter()
        x = self.x
        if self.wire:
            x = reference_to_baseband_device(x, device=self.device)
            _sync(self.device)
            self.condition_s = time.perf_counter() - t0
        self.rx.acquire_all(x)
        self.rx.start_tracking(x[self.acq * S:], start_epoch=self.acq)
        _sync(self.device)
        self.wall_s = time.perf_counter() - t0

    def record(self) -> dict:
        """Each live channel's Doppler and code phase as the acquisition
        found them (at the window's first epoch) and as they were handed
        to tracking (at epoch ``start_epoch`` of the window)."""
        rx = self.rx
        ts = rx.track_state
        return dict(capture=self.capture, offset=self.offset,
                    start_epoch=self.acq,
                    live=[ch.prn for ch in rx.channels],
                    handoff_doppler=ts.doppler_hz.cpu().double().tolist(),
                    handoff_code=ts.code_phase_chips.cpu().double()
                    .tolist(),
                    acq_doppler=[float(ch.acq.doppler_hz)
                                 for ch in rx.channels],
                    acq_code=[float(ch.acq.code_phase_chips)
                              for ch in rx.channels])


def coldstart_offsets(seed: int, n_captures: int, capture_epochs: int,
                      window_epochs: int):
    """The seed's endless sequence of (capture, offset): captures in
    turn, offsets uniform over whole epochs."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 0x0FF5])
    i = 0
    while True:
        yield i % n_captures, int(rng.integers(0, capture_epochs
                                               - window_epochs + 1))
        i += 1
