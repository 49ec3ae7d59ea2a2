"""The system under test, driven as the cell's traffic says: the only
module of the benchmark that calls the program.

* ``replay``: a closed loop of jobs, one at a time, each a fresh
  ``Receiver`` over a whole capture, alternating between the run's
  captures: the cold start as ``Receiver.run`` makes it, then
  ``process_block`` over ``block_epochs`` at a time.  ``ingest`` says how
  the samples reach it: ``host`` hands each block over as a slice of
  the front end's host form (a replayed file); ``wire_chunks`` uploads
  ``chunk_epochs`` of it at a time and conditions them on the card, each
  block a view of them.
* ``coldstart``: a closed loop of cold starts, each a fresh ``Receiver``
  handed ``window_epochs`` of a capture at an offset drawn from the
  seed: ``acquire_all`` and ``start_tracking``, ended by a synchronise.
  ``ingest`` says how the window reaches it: ``host`` hands it the host
  form; ``wire`` uploads it and conditions it on the card first, inside
  the timed start (a receiver powering on).

The front end's module (``frontends/<kind>.py``) says how long an epoch
of the host form is and conditions it (``to_baseband``); ``host`` takes
only a front end without that ingest, ``wire`` and ``wire_chunks`` only
one with it.  Each step returns the epochs it tracked; each finished job
or start leaves a record of plain numbers for ``truth`` to judge.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.runtime.receiver import Receiver

#: samples an epoch of 2.046 MHz baseband, what ``to_baseband`` gives
S = 2046

#: the ``ingest`` values each traffic kind takes
INGESTS = {"coldstart": ("host", "wire"), "replay": ("host", "wire_chunks")}

#: ReceiverConfig fields that ``receiver.settings`` may not set: the
#: configuration and the traffic state them elsewhere
_NOT_SETTINGS = ("prns", "acq", "track", "solve_period_ms",
                 "track_block_epochs")


def _apply(obj, fields: dict, where: str):
    """``obj`` with ``fields`` put in over its values (a JSON object over
    a nested dataclass applies to it, a list becomes a tuple).  A field
    that ``obj`` lacks raises TypeError naming it."""
    known = {f.name for f in dataclasses.fields(obj) if f.init}
    new = {}
    for k, v in fields.items():
        if k not in known:
            raise TypeError(f"{where}: {type(obj).__name__} has no field "
                            f"{k!r}")
        cur = getattr(obj, k)
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            v = _apply(cur, v, f"{where}.{k}")
        elif isinstance(v, list):
            v = tuple(v)
        new[k] = v
    return dataclasses.replace(obj, **new)


def receiver_config(cfg: dict, traffic: dict,
                    control: bool = False) -> ReceiverConfig:
    """The configuration's receiver: the program's defaults, under the
    ``receiver`` object's ``acq``, ``track`` and ``settings`` (fields of
    ``AcqConfig``, ``TrackConfig`` and ``ReceiverConfig``).  Its control
    is the shortcut that would tempt a later change: a replay solves half
    as often as the configuration's cadence; a cold start acquires on
    half the configured non-coherent epochs (and is judged on the
    acquisition's own, unrefined Doppler, ``Run.judge(handoff="acq")``)."""
    rc = cfg["receiver"]
    settings = rc.get("settings", {})
    fixed = sorted(set(settings) & set(_NOT_SETTINGS))
    if fixed:
        raise ValueError(f"receiver.settings sets {', '.join(fixed)}, "
                         "which the configuration and traffic state")
    cib = cfg["nav"].get("codes_in_bit", 20)
    track = rc.get("track", {})
    if track.get("codes_in_bit", cib) != cib:
        raise ValueError(f"receiver.track.codes_in_bit "
                         f"{track['codes_in_bit']} is not nav.codes_in_bit "
                         f"{cib}")
    block = traffic.get("block_epochs", 1000)
    acq = _apply(AcqConfig(), rc.get("acq", {}), "receiver.acq")
    period = rc["solve_period_ms"]
    if control and traffic["kind"] == "coldstart":
        acq = dataclasses.replace(
            acq, noncoherent_epochs=acq.noncoherent_epochs // 2)
    elif control:
        period = 2 * max(period, block)
    return _apply(ReceiverConfig(
        prns=tuple(rc["prns"]), track_block_epochs=block,
        solve_period_ms=period, acq=acq,
        track=_apply(TrackConfig(), dict(track, codes_in_bit=cib),
                     "receiver.track")), settings, "receiver.settings")


@dataclasses.dataclass(frozen=True)
class Feed:
    """How a cell's captures reach the receiver: ``per_epoch`` elements
    of the host form a millisecond, and ``to_baseband``, the front end's
    ingest on the card, or None where the host form is handed over as
    it is."""
    per_epoch: int
    to_baseband: object


def feed(frontend, fe: dict, traffic: dict) -> Feed:
    """The traffic's ``ingest`` on the front end ``frontend`` (its
    module, for the configuration's ``fe``).  Raises where the two do
    not fit: ``host`` on a front end that needs its ``to_baseband``, or
    ``wire`` / ``wire_chunks`` on one that has none."""
    kind, mode = traffic["kind"], traffic.get("ingest", "host")
    name = fe["kind"]
    if mode not in INGESTS[kind]:
        raise ValueError(f"a {kind} traffic takes ingest "
                         f"{' or '.join(INGESTS[kind])}, not {mode!r}")
    if mode == "host" and frontend.to_baseband is not None:
        raise ValueError(f"ingest 'host' hands the receiver the host form "
                         f"as it is, and front end {name!r} needs its "
                         "to_baseband")
    if mode != "host" and frontend.to_baseband is None:
        raise ValueError(f"ingest {mode!r} conditions the host form with "
                         f"the front end's to_baseband, and front end "
                         f"{name!r} has none")
    return Feed(frontend.units_per_epoch(fe),
                None if mode == "host" else frontend.to_baseband)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WireChunks:
    """Whole-epoch ranges of a capture's host form as complex64 baseband
    on the device: ``chunk_epochs`` of it uploaded and conditioned at a
    time by ``feed.to_baseband`` (the port's
    ``probes/wire_e2e.ChunkedDeviceCapture``), the chunks behind the
    cursor dropped.  ``condition_s`` is the host clock around each upload
    and conditioning, ended by a synchronise."""

    def __init__(self, words: np.ndarray, chunk_epochs: int, feed: Feed,
                 device):
        self.words = words
        self.chunk = chunk_epochs
        self.per = feed.per_epoch
        self.to_baseband = feed.to_baseband
        self.device = device
        self.total_epochs = len(words) // self.per
        self._chunks: dict = {}
        self.condition_s = 0.0

    def _get(self, i: int) -> torch.Tensor:
        c = self._chunks.get(i)
        if c is None:
            w0 = i * self.chunk * self.per
            w1 = min(w0 + self.chunk * self.per,
                     self.total_epochs * self.per)
            t0 = time.perf_counter()
            c = self.to_baseband(self.words[w0:w1], self.device)
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
                 traffic: dict, feed: Feed, device):
        self.capture = capture
        self.rx = Receiver(rcfg, device=device)
        self.block = rcfg.track_block_epochs
        self.acq = rcfg.acq.noncoherent_epochs
        self.spe = rcfg.plan.samples_per_epoch
        self.total = traffic["job_epochs"]
        self.wire = (WireChunks(data, traffic["chunk_epochs"], feed, device)
                     if feed.to_baseband is not None else None)
        self.data = data
        self.pos = None

    @property
    def done(self) -> bool:
        return self.pos is not None and self.pos + self.block > self.total

    def _samples(self, start: int, n: int):
        if self.wire is not None:
            return self.wire.epochs(start, n)
        return self.data[start * self.spe: (start + n) * self.spe]

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
            rx.start_tracking(x[self.acq * self.spe:],
                              start_epoch=self.acq)
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
                 rcfg: ReceiverConfig, traffic: dict, feed: Feed, device):
        self.capture, self.offset = capture, offset
        self.rx = Receiver(rcfg, device=device)
        self.acq = rcfg.acq.noncoherent_epochs
        self.spe = rcfg.plan.samples_per_epoch
        n = traffic["window_epochs"]
        self.to_baseband = feed.to_baseband
        self.x = data[offset * feed.per_epoch: (offset + n) * feed.per_epoch]
        self.device = torch.device(device)
        self.wall_s = None
        self.condition_s = 0.0

    def run(self) -> None:
        t0 = time.perf_counter()
        x = self.x
        if self.to_baseband is not None:
            x = self.to_baseband(x, self.device)
            _sync(self.device)
            self.condition_s = time.perf_counter() - t0
        self.rx.acquire_all(x)
        self.rx.start_tracking(x[self.acq * self.spe:], start_epoch=self.acq)
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
