"""Command-line receiver: ``python -m stm32f4_sdr_gps_torch <cmd>``.

The reference firmware is an appliance (flash it, watch the VT100
dashboard); this CLI is the equivalent front door:

  acquire   — cold acquisition table for a capture
  run       — full receiver over a capture, dashboard + solutions
              (--rtcm-out writes its RTCM3 frames, --checkpoint saves it)
  simulate  — synthesize a capture (with nav message) to a file

``acquire`` and ``run`` compute on the card unless ``--device cpu`` is
given, and fail without one.

Examples:
  python -m stm32f4_sdr_gps_torch simulate --out cap.npy --prn 7 \\
      --doppler 1500 --cn0 45 --seconds 30
  python -m stm32f4_sdr_gps_torch acquire cap.npy --prns 1-32
  python -m stm32f4_sdr_gps_torch run cap.npy --prns 7
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _parse_prns(spec: str):
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return tuple(sorted(set(out)))


def _load(path: str, fmt: str):
    from .signal.capture import read_capture

    return read_capture(path, fmt)


def cmd_acquire(args):
    from .acquire.engine import acquire
    from .config import AcqConfig, BASEBAND_PLAN

    x = _load(args.capture, args.format)
    cfg = AcqConfig(doppler_span_hz=args.span,
                    noncoherent_epochs=args.epochs)
    results = acquire(x, _parse_prns(args.prns), BASEBAND_PLAN, cfg,
                      device=args.device)
    print(f"{'PRN':>4} {'DET':>4} {'DOPPLER':>9} {'CODE':>9} "
          f"{'RATIO':>7} {'P/MEAN':>7}")
    for r in sorted(results, key=lambda r: -r.peak_ratio):
        print(f"{r.prn:>4} {'*' if r.detected else '':>4} "
              f"{r.doppler_hz:9.1f} {r.code_phase_chips:9.2f} "
              f"{r.peak_ratio:7.2f} {r.peak_to_mean:7.2f}")
    return 0


def cmd_run(args):
    from .config import ReceiverConfig
    from .io.status import render_status
    from .runtime.receiver import Receiver

    x = _load(args.capture, args.format)
    cfg = ReceiverConfig(prns=_parse_prns(args.prns),
                         enable_rtcm=bool(args.rtcm_out))
    rx = Receiver(cfg, device=args.device)

    def status(r):
        if args.watch:
            print(render_status(r, vt100=True))

    report = rx.run(x, status_callback=status if args.watch else None)
    print(render_status(rx))
    for sol, t in zip(report.solutions, report.solution_epochs_ms):
        lat = np.degrees(sol.pos_llh[0])
        lon = np.degrees(sol.pos_llh[1])
        print(f"FIX t={t} ms lat={lat:+.6f} lon={lon:+.6f} "
              f"h={sol.pos_llh[2]:.1f} m ns={sol.ns}")
    if args.rtcm_out and rx.rtcm_frames:
        with open(args.rtcm_out, "wb") as f:
            for frame in rx.rtcm_frames:
                f.write(frame)
        print(f"wrote {len(rx.rtcm_frames)} RTCM frames to {args.rtcm_out}")
    if args.checkpoint:
        from .runtime.checkpoint import save_receiver

        save_receiver(args.checkpoint, rx)
        print(f"checkpoint saved to {args.checkpoint}")
    return 0


def _default_eph():
    return dict(
        week=2290, iodc=57, iode=57, sva=2, svh=0, tgd=-1.2e-08,
        toc_s=352800.0, f0=2.56e-04, f1=-3.5e-12, f2=0.0, crs=-115.2,
        deln=4.05e-09, M0=-2.23, cuc=-6.06e-06, e=0.0111, cus=5.16e-06,
        A=26560278.1, toes=352800.0, fit=0, cic=-1.1e-08, OMG0=-0.597,
        cis=1.15e-07, i0=0.988, crc=287.47, omg=0.681, OMGd=-8.16e-09,
        idot=-4.89e-10,
    )


def cmd_simulate_real(args):
    from .signal.nav_message import build_bitstream
    from .signal.simulator import SimSat, simulate_capture

    bits = build_bitstream(_default_eph(), start_tow_6s=58800,
                           num_subframes=max(2, int(args.seconds // 6) + 1))
    sats = []
    for spec in args.sat:
        prn, dop, cn0, delay = (spec.split(":") + ["45", "68.1"])[:4]
        sats.append(SimSat(prn=int(prn), doppler_hz=float(dop),
                           cn0_dbhz=float(cn0), nav_bits=bits,
                           delay_ms=float(delay)))
    if not sats:
        sats = [SimSat(prn=args.prn, doppler_hz=args.doppler,
                       cn0_dbhz=args.cn0, nav_bits=bits, delay_ms=68.1)]
    x, _ = simulate_capture(sats, num_epochs=int(args.seconds * 1000),
                            seed=args.seed)
    np.save(args.out, x)
    print(f"wrote {len(x)} samples ({args.seconds} s, "
          f"{len(sats)} satellites) to {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="stm32f4_sdr_gps_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default="cuda",
                           help="torch device (default: the card)")

    pa = sub.add_parser("acquire", help="cold acquisition table",
                        parents=[on_device])
    pa.add_argument("capture")
    pa.add_argument("--format", default="auto")
    pa.add_argument("--prns", default="1-32")
    pa.add_argument("--span", type=float, default=7000.0)
    pa.add_argument("--epochs", type=int, default=10)
    pa.set_defaults(fn=cmd_acquire)

    pr = sub.add_parser("run", help="full receiver over a capture",
                        parents=[on_device])
    pr.add_argument("capture")
    pr.add_argument("--format", default="auto")
    pr.add_argument("--prns", default="1-32")
    pr.add_argument("--watch", action="store_true",
                    help="VT100 live dashboard")
    pr.add_argument("--rtcm-out", default=None)
    pr.add_argument("--checkpoint", default=None)
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("simulate", help="synthesize a capture")
    ps.add_argument("--out", required=True)
    ps.add_argument("--prn", type=int, default=7)
    ps.add_argument("--doppler", type=float, default=1500.0)
    ps.add_argument("--cn0", type=float, default=45.0)
    ps.add_argument("--seconds", type=float, default=30.0)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--sat", action="append", default=[],
                    help="prn:doppler[:cn0[:delay_ms]] (repeatable)")
    ps.set_defaults(fn=cmd_simulate_real)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
