"""Receiver status reporting: terminal dashboard + ASCII position plot.

The capability of the firmware's VT100 UI (``print_state.c``): per
channel acquisition state / tracking line (SNR, carrier offset, code
phase, word & subframe counters, print_state.c:221-317), runtime clock,
solution lat/lon (:157-211), and the position scatter plot on an 8x6
grid (:322-441).  Renders to a string; the caller decides where it goes
(stdout, log, notebook) — the UART DMA plumbing has no equivalent here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# Scatter grid: 8 x 6 cells of ~88 m x 77 m (print_state.c:44-45)
PLOT_COLS = 8
PLOT_ROWS = 6
CELL_EW_M = 88.0
CELL_NS_M = 77.0
EARTH_R = 6371000.0


@dataclass
class PositionPlot:
    """ASCII scatter of solutions around the first fix
    (print_state_draw_position, print_state.c:322-441)."""

    origin_llh: Optional[np.ndarray] = None
    grid: np.ndarray = field(
        default_factory=lambda: np.zeros((PLOT_ROWS, PLOT_COLS), dtype=int)
    )

    def add(self, llh_rad: np.ndarray):
        if self.origin_llh is None:
            self.origin_llh = np.asarray(llh_rad[:2]).copy()
        dlat = (llh_rad[0] - self.origin_llh[0]) * EARTH_R
        dlon = (
            (llh_rad[1] - self.origin_llh[1])
            * EARTH_R * np.cos(self.origin_llh[0])
        )
        col = int(np.clip(PLOT_COLS // 2 + dlon / CELL_EW_M, 0,
                          PLOT_COLS - 1))
        row = int(np.clip(PLOT_ROWS // 2 - dlat / CELL_NS_M, 0,
                          PLOT_ROWS - 1))
        self.grid[row, col] += 1

    def render(self) -> str:
        lines = ["+" + "-" * PLOT_COLS + "+"]
        for r in range(PLOT_ROWS):
            row = "".join(
                "*" if self.grid[r, c] else "." for c in range(PLOT_COLS)
            )
            lines.append("|" + row + "|")
        lines.append("+" + "-" * PLOT_COLS + "+")
        return "\n".join(lines)


def _eph_utc_line(receiver) -> str:
    """UTC wall time from the freshest decoded subframe TOW."""
    import datetime

    from ..config import GPS_UTC_OFFSET_S, UNIX2GPS_S

    best = None
    for ch in receiver.channels:
        if getattr(ch, "subframe_tow_s", 0) and ch.eph.week:
            t = (UNIX2GPS_S + ch.eph.week * 604800
                 + ch.subframe_tow_s - GPS_UTC_OFFSET_S)
            best = max(best or 0, t)
    if not best:
        return ""
    dt = datetime.datetime.fromtimestamp(best, datetime.timezone.utc)
    return f"EPH UTC  {dt.strftime('%Y-%m-%d %H:%M:%S')}"


def _sync_marker(receiver, ch) -> str:
    """Bit-sync column: '-' until period sync; then 'COH' when the
    20 ms coherent PLL is engaged (TrackConfig.coherent_pll), 'BIT'
    otherwise."""
    if not getattr(ch, "bit_synced", False):
        return "-"
    coherent = getattr(receiver.config.track, "coherent_pll", False)
    return "COH" if coherent else "BIT"


def render_status(receiver, vt100: bool = False,
                  profile: bool = False) -> str:
    """One status screen for a runtime.Receiver.

    ``profile=True`` appends the per-stage timing report
    (utils.profiling.Profiler — the DWT-timer observability role)."""
    out = []
    if vt100:
        out.append("\x1b[2J\x1b[H")
    t_s = receiver.epoch_cursor / 1000.0
    out.append(f"RUNTIME {t_s:8.1f} s   epochs={receiver.epoch_cursor}")
    # GPS->UTC clock from decoded ephemeris time (print_state.c:157-176
    # displays the eph UTC time the same way)
    utc = _eph_utc_line(receiver)
    if utc:
        out.append(utc)
    out.append(
        f"{'PRN':>4} {'STATE':>10} {'SNR dB':>7} {'C/N0':>6} {'DOPP Hz':>9} "
        f"{'CODE':>8} {'BITS':>6} {'SUBFR':>6} {'SYNC':>5}"
    )
    for ch in receiver.channels:
        if ch.state_name == "TRACKING":
            out.append(
                f"{ch.prn:>4} {ch.state_name:>10} {ch.snr_db:7.1f} "
                f"{getattr(ch, 'cn0_dbhz', 0.0):6.1f} "
                f"{ch.doppler_hz:9.1f} {ch.code_phase_chips:8.2f} "
                f"{ch.bit_count:6d} {ch.subframe_count:6d} "
                f"{_sync_marker(receiver, ch):>5}"
            )
        else:
            pct = ""
            if ch.acq is not None:
                pct = f"ratio={ch.acq.peak_ratio:.2f}"
            out.append(f"{ch.prn:>4} {ch.state_name:>10} {pct}")
    if receiver.solutions:
        sol = receiver.solutions[-1]
        lat, lon, hgt = np.degrees(sol.pos_llh[0]), np.degrees(
            sol.pos_llh[1]), sol.pos_llh[2]
        out.append(
            f"POS  lat={lat:+.6f}  lon={lon:+.6f}  h={hgt:7.1f} m  "
            f"ns={sol.ns}  iters={sol.iterations}"
        )
        if sol.vel is not None:
            v = np.linalg.norm(sol.vel)
            out.append(
                f"VEL  |v|={v:6.2f} m/s  clk drift="
                f"{sol.dtr_drift_s * 1e9:+.2f} ns/s"
            )
        plot = PositionPlot()
        for s in receiver.solutions:
            plot.add(s.pos_llh)
        out.append(plot.render())
    else:
        out.append("POS  (no fix)")
    if profile and getattr(receiver, "profiler", None) is not None \
            and receiver.profiler.stages:
        out.append("")
        out.append(receiver.profiler.report())
    return "\n".join(out)
