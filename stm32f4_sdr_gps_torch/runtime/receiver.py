"""Streaming receiver: acquisition → pre-track → tracking → decode →
PVT (torch port of the JAX package's runtime/receiver.py, default path).

The counterpart of the firmware's orchestration layer (``main.c``
dispatch loop + ``gps_master.c`` channel sequencing), as an explicit
batched program per stage over a recorded capture:

1. **Acquire** — FFT cube over all PRNs at once on the device.
2. **Pre-track** — fine Doppler and code-phase refinement
   (tracking.c:398-499).
3. **Track** — one tracking call per block of epochs, all channels
   batched: on a CUDA device the tracking-scan kernel, carrying its own
   state between blocks, followed by the on-device block digest; only
   the digest is copied to the host.
4. **Decode** — per-channel nav framers consume bit events; subframes
   update ephemerides (nav_data.c / nav_data_decode.c roles).
5. **Solve** — observables formed on the sample ledger at the solve
   cadence, Gauss-Newton PVT (gps_master.c:392-425).

Not ported yet (ROADMAP Queue 1): the coherent weak-signal chain and its
aided bit sync, background re-acquisition and channel demotion, RTCM
output, checkpointing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..acquire.engine import AcqResult, acquire, refine_doppler_device
from ..config import (
    CODE_LENGTH,
    FREQ_L1_HZ,
    WORD_LENGTH_BITS,
    WORDS_IN_SUBFRAME,
    ReceiverConfig,
    resolve_in_kernel_scan,
)
from ..nav.ephemeris import Ephemeris, decode_subframe, getbitu
from ..nav.frame import NavFramer
from ..ops.epl import upsampled_code_doubled
from ..ops.track_scan import (
    outputs_from_raw,
    state_from_track_state,
    state_to_track_state,
    track_scan,
)
from ..pvt.observables import (ChannelObservables, HatchState,
                               boundary_arrival_ms, form_observations)
from ..pvt.solve import (Solution, identify_grid_fault, pntpos,
                         solution_plausible)
from ..signal.ca_code import ca_table_bipolar
from ..track.pretrack import refine_code_phase
from ..track.scan import check_supported, track_block
from ..track.state import TrackOutputs, TrackState, init_state
from ..utils.profiling import Profiler
from .digest import cn0_from_moments, digest_block, digest_to_host


def _track_and_digest(state, epochs, code_table, plan, cfg,
                      code_filter_len, enable_code_filter):
    """Tracking scan + on-device block digest: the (T, C) outputs stay
    on the device."""
    state, outs = track_block(state, epochs, code_table, plan, cfg)
    return state, digest_block(outs, state, cfg, code_filter_len,
                               enable_code_filter)


def _track_and_digest_carried(ps, epochs, code_table, plan, cfg,
                              code_filter_len, enable_code_filter):
    """Kernel variant of _track_and_digest that takes and returns the
    kernel's own ScanState, so every carried plane (the latched SNR
    window sums included) survives block boundaries instead of being
    rebuilt from the TrackState each call.  Also returns the TrackState
    view for the host-side channel logic."""
    ps2, raw = track_scan(ps, epochs, code_table, plan, cfg)
    outs = outputs_from_raw(raw)
    ts = state_to_track_state(ps2)
    return ps2, ts, digest_block(
        outs, ts, cfg, code_filter_len, enable_code_filter)


@dataclass
class ChannelStatus:
    """Host-side per-channel bookkeeping (the gps_ch_t role)."""

    prn: int
    acq: Optional[AcqResult] = None
    framer: NavFramer = field(default_factory=NavFramer)
    eph: Ephemeris = field(default_factory=Ephemeris)
    subframe_time_ms: int = 0     # last subframe boundary (ledger ms)
    subframe_tow_s: float = 0.0   # TOW labelling that boundary
    # recent boundary residues on the nav-bit grid, for de-jittering
    boundary_residues: list = field(default_factory=list)
    hatch: HatchState = field(default_factory=HatchState)
    subframe_count: int = 0
    bit_count: int = 0
    snr_db: float = 0.0
    cn0_dbhz: float = 0.0
    carrier_cycles: float = 0.0   # integrated Doppler (L observable)
    # Costas half-cycle ambiguity state: +1 = carrier in phase with nav
    # bits, -1 = PLL locked pi out of phase (the framer sees inverted
    # polarity; true phase = measured + 1/2 cycle), 0 = never resolved.
    half_cycle: int = 0
    half_cycle_known: bool = False
    doppler_hz: float = 0.0
    code_phase_chips: float = 0.0
    state_name: str = "IDLE"
    bit_synced: bool = False      # period sync
    # persistent integer-ms correction to the channel's subframe boundary
    # ledger, set when identify_grid_fault pins a wrong nav-bit grid
    grid_bias_ms: int = 0
    grid_faults: int = 0


def _m2m4_cn0(ip: np.ndarray, qp: np.ndarray,
              epoch_s: float = 1e-3) -> float:
    """C/N0 (dB-Hz) from prompt correlator moments (M2M4 estimator)."""
    p = ip.astype(np.float64) ** 2 + qp.astype(np.float64) ** 2
    if len(p) < 16:
        return 0.0
    m2 = p.mean()
    m4 = (p * p).mean()
    pd = np.sqrt(max(2.0 * m2 * m2 - m4, 0.0))
    pn = m2 - pd
    if pd <= 0.0 or pn <= 0.0:
        return 0.0
    return float(10.0 * np.log10(pd / pn / epoch_s))


def dejitter_boundary(ch: ChannelStatus, boundary: int, cib: int) -> int:
    """Snap a detected subframe boundary to the channel's nav-bit grid.

    Bit-edge detection can slip +/-1 epoch under noise when the edge lies
    near an epoch midpoint, which would shift the reconstructed
    pseudorange by a full ms (300 km).  Boundaries repeat on the bit
    grid, so the median residue of recent detections identifies and
    removes isolated slips.
    """
    res = boundary % cib
    hist = ch.boundary_residues
    hist.append(res)
    del hist[:-5]
    if len(hist) >= 3:
        med = int(np.median(hist))
        delta = (res - med + cib // 2) % cib - cib // 2
        boundary -= delta
    return boundary


def push_channel_bit(ch: ChannelStatus, value: int, epoch: int,
                     codes_in_bit: int) -> None:
    """One demodulated nav bit → framer → subframe/ephemeris/ledger."""
    ch.bit_count += 1
    for sf in ch.framer.push_bit(value, epoch):
        decode_subframe(sf.bits, ch.eph)
        ch.eph.sat = ch.prn
        ch.subframe_count += 1
        # boundary the HOW TOW labels = subframe start + 6 s
        # (300 bits x codes_in_bit ms per bit)
        sf_ms = WORDS_IN_SUBFRAME * WORD_LENGTH_BITS * codes_in_bit
        boundary = dejitter_boundary(
            ch, sf.start_epoch_ms + sf_ms, codes_in_bit)
        ch.subframe_time_ms = boundary
        ch.subframe_tow_s = getbitu(sf.bits, 30, 17) * 6.0


@dataclass
class ReceiverReport:
    """Result of processing a capture."""

    channels: List[ChannelStatus]
    solutions: List[Solution]
    solution_epochs_ms: List[int]
    epochs_processed: int = 0


class Receiver:
    """Multi-channel GPS L1 C/A receiver over a sample stream, with its
    tensors on ``device``."""

    def __init__(self, config: ReceiverConfig, device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Receiver(device={device!r}): CUDA is not "
                               "available")
        check_supported(config.track)
        if config.enable_rtcm:
            raise NotImplementedError(
                "enable_rtcm: RTCM output is not ported yet (ROADMAP "
                "Queue 1, io/rtcm3.py)")
        if config.reacquire_period_ms:
            raise NotImplementedError(
                "reacquire_period_ms: background re-acquisition and "
                "channel demotion are not ported yet (ROADMAP Queue 1, "
                "maybe_reacquire / drop_dead_channels)")
        self.config = config
        self.channels: List[ChannelStatus] = [
            ChannelStatus(prn=p, framer=self._new_framer())
            for p in config.prns
        ]
        self.track_state: Optional[TrackState] = None
        self.code_table = None
        # canonical (C, 1023) bipolar table behind code_table
        self.code_table_np: Optional[np.ndarray] = None
        self.epoch_cursor = 0        # global sample ledger, epochs (= ms)
        self.solutions: List[Solution] = []
        self.solution_epochs: List[int] = []
        self.standby_channels: List[ChannelStatus] = []
        self._last_solve_ms = 0
        # carried tracking-scan kernel state; valid only while
        # track_state IS _scan_carry_ref (identity check — any mutation
        # builds a new NamedTuple and invalidates it)
        self._scan_carry = None
        self._scan_carry_ref = None
        # sticky reference channel for carrier-phase clock re-basing
        # (_relative_L); 0 = unset, chosen at first observable formation
        self._phase_ref_prn = 0
        # per-stage wall-clock profiler; the 'track' stage budget is the
        # real-time budget of one block
        self.profiler = Profiler()

    def _new_framer(self) -> NavFramer:
        """Framer with the polarity re-detect timeout scaled to the
        actual on-air bit duration (2 subframes = 600 bits)."""
        return NavFramer(
            polarity_timeout_ms=600 * self.config.track.codes_in_bit)

    @property
    def _kernel_scan(self) -> bool:
        return resolve_in_kernel_scan(self.config.track, self.device)

    def _device_code_table(self, table_np: np.ndarray) -> torch.Tensor:
        """Code table in the form the tracking path needs: the doubled
        upsampled table for the half-chip paths (cfg.track.use_pallas /
        the tracking-scan kernel), the raw (C, 1023) bipolar table for the
        fractional-phase reference scan."""
        if self.config.track.use_pallas or self._kernel_scan:
            table_np = upsampled_code_doubled(table_np)
        return torch.as_tensor(table_np, device=self.device)

    def _to_device(self, samples: np.ndarray, n_epochs: int) -> torch.Tensor:
        """(n_epochs, S) complex64 block on the device: one host-to-device
        copy."""
        spe = self.config.plan.samples_per_epoch
        block = np.ascontiguousarray(
            samples[: n_epochs * spe].reshape(n_epochs, spe),
            dtype=np.complex64)
        return torch.as_tensor(block, device=self.device)

    # -- stages -----------------------------------------------------------

    def acquire_all(self, samples: np.ndarray,
                    extra_hints: Optional[dict] = None) -> List[AcqResult]:
        """Stage 1: cold acquisition for every configured PRN.

        Doppler hints (main.c:59-73 capability) confine the grid for the
        hinted channel; ``extra_hints`` (e.g. from a warm reset) override
        the configured ones."""
        cfg = self.config
        hints = {}
        for prn, h in zip(cfg.prns, cfg.doppler_hints_hz or ()):
            if h is not None:
                hints[int(prn)] = float(h)
        if extra_hints:
            hints.update(extra_hints)
        with self.profiler.stage("acquire").time():
            results = acquire(samples, list(cfg.prns), cfg.plan, cfg.acq,
                              doppler_hints_hz=hints or None,
                              device=self.device)
        for ch, res in zip(self.channels, results):
            ch.acq = res
            ch.state_name = "ACQ_DONE" if res.detected else "ACQ_FAILED"
        return results

    def start_tracking(self, samples: np.ndarray,
                       start_epoch: int = 0) -> None:
        """Stages 2-3 init: fine Doppler, pre-track refinement, tracking
        state."""
        cfg = self.config
        live = [ch for ch in self.channels if ch.acq and ch.acq.detected]
        if not live:
            raise RuntimeError("no channels acquired")
        prns = [ch.prn for ch in live]
        self.standby_channels = [
            ch for ch in self.channels if ch not in live
        ]
        self.channels = live
        table_np = ca_table_bipolar(prns)
        phases = np.array([ch.acq.code_phase_chips for ch in live])
        spe = cfg.plan.samples_per_epoch
        e = min(32, len(samples) // spe)
        dev = self.device
        with self.profiler.stage("pretrack").time():
            # fine Doppler: long coherent FFT at the acquired code phase
            # shrinks the handoff error from tens of Hz to ~1 Hz
            dopplers = refine_doppler_device(
                self._to_device(samples, e),
                torch.as_tensor(table_np, device=dev),
                torch.as_tensor(phases, dtype=torch.float32, device=dev),
                torch.as_tensor([ch.acq.doppler_hz for ch in live],
                                dtype=torch.float32, device=dev),
                cfg.plan,
            ).cpu().numpy().astype(np.float64)
            refined = refine_code_phase(
                samples, table_np, phases, dopplers, cfg.plan, cfg.track,
                device=dev)
        self.code_table_np = table_np
        self.code_table = self._device_code_table(table_np)
        self.track_state = init_state(
            len(live), refined, dopplers, start_epoch=start_epoch,
            window=cfg.track.pll_check_window, device=dev,
        )
        for ch in live:
            ch.state_name = "TRACKING"

    @property
    def _digest_active(self) -> bool:
        """Device-digest readback mode (runtime.digest): on unless
        correlator diagnostics need the full (T, C) outputs on the
        host."""
        cfg = self.config
        return cfg.device_digest and not cfg.track.emit_correlators

    def process_block(self, samples: np.ndarray) -> None:
        """Stages 3-5 for one block of whole epochs."""
        cfg = self.config
        n_epochs = len(samples) // cfg.plan.samples_per_epoch
        epochs = self._to_device(samples, n_epochs)
        if self._digest_active:
            # device-resident loop: the (T, C) outputs never leave the
            # device; the stage ends when the digest is on the host
            with self.profiler.stage(
                "track", budget_s=n_epochs * 1e-3
            ).time():
                if self._kernel_scan:
                    # carry the kernel's own ScanState between blocks;
                    # any host-side mutation of track_state replaces the
                    # NamedTuple, so the identity check invalidates it
                    ps = (self._scan_carry
                          if self.track_state is self._scan_carry_ref
                          else state_from_track_state(self.track_state))
                    ps, ts, d = _track_and_digest_carried(
                        ps, epochs, self.code_table, cfg.plan, cfg.track,
                        cfg.code_filter_len, cfg.enable_code_filter
                    )
                    self.track_state = ts
                    self._scan_carry = ps
                    self._scan_carry_ref = ts
                else:
                    self.track_state, d = _track_and_digest(
                        self.track_state, epochs, self.code_table,
                        cfg.plan, cfg.track, cfg.code_filter_len,
                        cfg.enable_code_filter
                    )
                d = digest_to_host(d)
            with self.profiler.stage("decode").time():
                self._consume_digest(d, n_epochs)
            self.epoch_cursor += n_epochs
            return
        with self.profiler.stage("track", budget_s=n_epochs * 1e-3).time():
            self.track_state, outs = track_block(
                self.track_state, epochs, self.code_table, cfg.plan,
                cfg.track
            )
            outs = TrackOutputs(*(v.cpu().numpy() for v in outs))
        with self.profiler.stage("decode").time():
            self._consume_outputs(outs, n_epochs)
        self.epoch_cursor += n_epochs

    def _consume_outputs(self, outs: TrackOutputs, n_epochs: int) -> None:
        """Host side of the full-readback path (numpy leaves): bits →
        framers → subframes → ephemeris; solve."""
        cfg = self.config
        bit_ready = outs.bit_ready
        dop = outs.doppler_hz
        cp = outs.code_phase_chips
        for c, ch in enumerate(self.channels):
            for t in np.nonzero(bit_ready[:, c])[0]:
                self._push_channel_bit(
                    ch, int(outs.bit_value[t, c]), int(outs.bit_epoch[t, c])
                )
            ch.snr_db = float(outs.snr_db[-1, c])
            ch.bit_synced = bool(outs.period_sync_ok[-1, c])
            # exclude nav-bit-edge epochs (the edge epoch and its
            # predecessor carry attenuated prompts)
            br_c = bit_ready[:, c]
            clean = ~(br_c | np.concatenate([br_c[1:], [False]]))
            ch.cn0_dbhz = _m2m4_cn0(outs.ip[clean, c], outs.qp[clean, c])
            ch.doppler_hz = float(dop[-1, c])
            # integrated Doppler = carrier-phase observable (cycles);
            # float64 host accumulation avoids f32 drift
            ch.carrier_cycles += float(
                np.sum(dop[:, c].astype(np.float64)) * 1e-3
            )
            ch.code_phase_chips = float(cp[-1, c])
            if cfg.enable_code_filter:
                ch.code_phase_chips = self._filtered_code_phase(
                    cp[:, c], ch.doppler_hz
                )
        self._run_cadences(self.epoch_cursor + n_epochs)

    def _push_channel_bit(self, ch: ChannelStatus, value: int,
                          epoch: int) -> None:
        push_channel_bit(ch, value, epoch, self.config.track.codes_in_bit)

    def _consume_digest(self, d, n_epochs: int) -> None:
        """Host side of the device-resident loop: the BlockDigest, already
        on the host as numpy leaves."""
        cfg = self.config
        bit_count = d.bit_count.tolist()
        bit_value = d.bit_value.T.tolist()      # (C, K) int lists
        bit_epoch = d.bit_epoch.T.tolist()
        snr_db = d.snr_db.tolist()
        sync_ok = d.period_sync_ok.tolist()
        cn0_m2 = d.cn0_m2.tolist()
        cn0_m4 = d.cn0_m4.tolist()
        cn0_n = d.cn0_n.tolist()
        doppler = d.doppler_hz.tolist()
        doppler_sum = d.doppler_sum.tolist()
        cp = (d.code_phase_filtered if cfg.enable_code_filter
              else d.code_phase_chips).tolist()
        for c, ch in enumerate(self.channels):
            bv, be = bit_value[c], bit_epoch[c]
            for k in range(bit_count[c]):
                self._push_channel_bit(ch, bv[k], be[k])
            ch.snr_db = snr_db[c]
            ch.bit_synced = sync_ok[c]
            ch.cn0_dbhz = cn0_from_moments(cn0_m2[c], cn0_m4[c], cn0_n[c])
            ch.doppler_hz = doppler[c]
            ch.carrier_cycles += doppler_sum[c] * 1e-3
            ch.code_phase_chips = cp[c]
        self._run_cadences(self.epoch_cursor + n_epochs)

    def _update_half_cycle(self, ch: ChannelStatus) -> None:
        """Resolve the Costas half-cycle ambiguity from nav polarity.

        A Costas loop locks indistinguishably at 0 or pi; once the framer
        pins the bit polarity, an inverted polarity means the carrier is
        pi out of phase.  A polarity CHANGE breaks carrier continuity:
        reset the Hatch filter."""
        if not ch.framer.polarity_found:
            ch.half_cycle_known = False   # ambiguous until re-pinned
            return
        hc = -1 if ch.framer.inv_polarity else 1
        if hc != ch.half_cycle:
            if ch.half_cycle != 0:        # a real slip, not first pin
                ch.hatch = HatchState()
            ch.half_cycle = hc
        ch.half_cycle_known = True

    def _L_cycles(self, ch: ChannelStatus) -> float:
        """Half-cycle-corrected carrier-phase observable (cycles)."""
        return ch.carrier_cycles + (0.5 if ch.half_cycle < 0 else 0.0)

    def _relative_L(self, ready: List[ChannelStatus]) -> dict:
        """Carrier phase re-based to the pseudorange time base (cycles).

        form_observations pins the reference satellite's pseudorange to
        68.802 ms (gps_master.c:199-201), so subtracting a sticky
        reference channel's L puts the carrier on the same clock
        realization as P; the same PRN is pinned into form_observations
        (ref_prn).  When the reference channel leaves the ready set the
        clock base jumps and the Hatch histories restart."""
        by_prn = {ch.prn: ch for ch in ready}
        if self._phase_ref_prn not in by_prn:
            is_switch = self._phase_ref_prn != 0
            # earliest boundary arrival = closest satellite
            # (gps_master.c:180-184), sticky from here on
            self._phase_ref_prn = min(
                ready,
                key=lambda c: boundary_arrival_ms(
                    c.subframe_time_ms, c.code_phase_chips)
                - c.subframe_tow_s * 1000.0,
            ).prn
            if is_switch:
                for ch in self.channels:
                    ch.hatch = HatchState()
        ref_l = self._L_cycles(by_prn[self._phase_ref_prn])
        return {ch.prn: self._L_cycles(ch) - ref_l for ch in ready}

    def _run_cadences(self, end_ms: int) -> None:
        """PVT at the solve cadence (gps_master.c:392-425)."""
        cfg = self.config
        for ch in self.channels:
            self._update_half_cycle(ch)
        if (
            cfg.enable_position
            and end_ms - self._last_solve_ms >= cfg.solve_period_ms
        ):
            self._last_solve_ms = end_ms
            self._try_solve(end_ms - 1)

    def _filtered_code_phase(self, cp_hist: np.ndarray,
                             doppler_hz: float) -> float:
        """Code-phase smoothing: drift-detrended average of the last K
        epochs, referenced to the final epoch (the capability of
        gps_master_filter_code_phase, gps_master.c:332-388)."""
        k = min(self.config.code_filter_len, len(cp_hist))
        seg = np.asarray(cp_hist[-k:], dtype=np.float64)
        drift = CODE_LENGTH * doppler_hz / FREQ_L1_HZ   # chips per epoch
        expected = drift * (np.arange(k) - (k - 1))
        resid = seg - seg[-1] - expected
        resid = (resid + CODE_LENGTH / 2) % CODE_LENGTH - CODE_LENGTH / 2
        return float((seg[-1] + resid.mean()) % CODE_LENGTH)

    def _try_solve(self, meas_epoch_ms: int) -> None:
        cfg = self.config
        ready = [ch for ch in self.channels if ch.eph.has_full_set
                 and ch.subframe_time_ms > 0]
        if len(ready) < 4:
            return
        chobs = [
            ChannelObservables(
                prn=ch.prn,
                subframe_time_ms=ch.subframe_time_ms + ch.grid_bias_ms,
                tow_s=ch.subframe_tow_s,
                week=ch.eph.week,
                code_phase_chips=ch.code_phase_chips,
                doppler_hz=ch.doppler_hz,
                snr_db=ch.snr_db,
            )
            for ch in ready
        ]
        # sticky reference first: the same PRN pins both the carrier
        # re-basing and the pseudorange convention below
        rel_l = self._relative_L(ready)
        obs = form_observations(chobs, meas_epoch_ms,
                                ref_prn=self._phase_ref_prn)
        if obs is None:
            return
        # carrier smoothing (Hatch)
        for o, ch in zip(obs, ready):
            o.L = rel_l[ch.prn]
            o.P = ch.hatch.update(o.P, o.L, epoch_ms=meas_epoch_ms)
        eph_map = {ch.prn: ch.eph for ch in ready}
        x0 = self.solutions[-1].rr if self.solutions else None
        with self.profiler.stage(
            "solve", budget_s=cfg.solve_period_ms * 1e-3
        ).time():
            sol = pntpos(obs, eph_map, x0=x0,
                         raim_threshold_m=cfg.raim_threshold_m)
        if not sol.ok:
            return
        # residual sanity gate (solving.c:436-439): a single channel with
        # a wrong integer-ms boundary converges hundreds of km off with
        # km-scale residuals
        if cfg.max_resid_rms_m > 0 and sol.residuals is not None:
            rms = float(np.sqrt(np.mean(sol.residuals ** 2)))
            if rms > cfg.max_resid_rms_m:
                return
        # physical plausibility gate + single-channel grid-fault
        # identification (a wrong bit grid converges with ZERO residuals
        # at 4 sats, so only physics can catch it)
        gates = dict(min_altitude_m=cfg.min_altitude_m,
                     max_altitude_m=cfg.max_altitude_m,
                     min_clock_bias_ms=cfg.min_clock_bias_ms,
                     max_clock_bias_ms=cfg.max_clock_bias_ms,
                     max_speed_mps=cfg.max_speed_mps)
        if cfg.min_altitude_m < cfg.max_altitude_m and not \
                solution_plausible(sol, **gates):
            if not cfg.grid_fault_search:
                return
            hit = identify_grid_fault(obs, eph_map, x0=x0, **gates)
            if hit is None:
                return                      # ambiguous: reject the epoch
            sol, idx, shift_ms = hit
            ch = ready[idx]
            ch.grid_bias_ms += shift_ms
            ch.grid_faults += 1
            ch.hatch = HatchState()         # history spans the fault
        self.solutions.append(sol)
        self.solution_epochs.append(meas_epoch_ms)

    def warm_reset(self, samples: np.ndarray) -> None:
        """Operator warm reset: drop tracking/nav state but keep each
        channel's learned Doppler as the new acquisition hint
        (gps_master_reset_to_aqc_start, gps_master.c:490-510)."""
        hints = {
            ch.prn: ch.doppler_hz
            for ch in self.channels
            if ch.framer.words_decoded > 1
        }
        for ch in self.channels:
            ch.framer = self._new_framer()
            ch.subframe_time_ms = 0
            ch.subframe_tow_s = 0.0
            ch.subframe_count = 0
            ch.bit_count = 0
            ch.state_name = "IDLE"
            ch.half_cycle = 0
            ch.half_cycle_known = False
        self.track_state = None
        self.acquire_all(samples, extra_hints=hints)
        self.start_tracking(samples, start_epoch=self.epoch_cursor)

    # -- top level --------------------------------------------------------

    def run(self, samples: np.ndarray,
            status_callback=None) -> ReceiverReport:
        """Process a whole capture end-to-end."""
        cfg = self.config
        spe = cfg.plan.samples_per_epoch
        self.acquire_all(samples)
        acq_epochs = cfg.acq.noncoherent_epochs
        self.start_tracking(samples[acq_epochs * spe:],
                            start_epoch=acq_epochs)
        self.epoch_cursor = acq_epochs

        block = cfg.track_block_epochs * spe
        pos = acq_epochs * spe
        while pos + spe <= len(samples):
            chunk = samples[pos: pos + block]
            self.process_block(chunk)
            pos += (len(chunk) // spe) * spe
            if status_callback is not None:
                status_callback(self)
        return ReceiverReport(
            channels=self.channels,
            solutions=self.solutions,
            solution_epochs_ms=self.solution_epochs,
            epochs_processed=self.epoch_cursor,
        )
