"""The complete receiver from the firmware's wire format to a fix, with
the conditioning on the card: the port's counterpart of the JAX
package's tools/tpu_e2e.py.

* stimulus: the independent C++ generator's wire capture
  (``runtime.native.capture_gen``: 1-bit real signs at 16.368 MHz packed
  into uint16 SPI words, 2 046 bytes a millisecond, signal_capture.c:
  9-11, 143-177), with its planted truth;
* ingest (``--ingest``): ``wire`` uploads one chunk of words at a time
  and conditions it to complex baseband on the device
  (``signal.capture.reference_to_baseband_device``), cutting at whole
  epochs (1023 words) and freeing the chunks behind the read cursor, so
  the 16x larger complex stream only ever exists in device memory;
  ``baseband`` conditions the whole capture on the host and uploads each
  block's complex64 samples;
* pipeline: the stock Receiver with the tool's config (``codes_in_bit``,
  the watchdog off, the matmul-DFT acquisition): cold start on the device
  from the first ``max(256 + acquisition epochs, chunk)`` epochs, then
  ``process_block`` fed straight from the device chunks (the
  tracking-scan kernel on the card, or the reference scan with
  ``--jnp-track``);
* verdict: the last fix within 500 m of the planted position, with every
  channel's ephemeris set full.

The tool's transport workarounds are not ported: its hard-deadline
thread, the checkpoint-resume across runs and the host-acquisition
fallback.  A failure on the device fails the run.

    python -m stm32f4_sdr_gps_torch.probes.wire_e2e [--duration-ms 29000]
        [--cn0 48] [--cib 20] [--seed 5] [--repeats 1]
        [--block-epochs 256] [--chunk-epochs 256]
        [--ingest wire|baseband] [--jnp-track] [--device cuda]
        [--state-dir DIR]

prints the result as one JSON line (``upload_s`` is the upload plus the
conditioning) and exits 0 where it passes, 1 where it does not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

WORDS_PER_EPOCH = 1023          # 16368 samples a millisecond / 16 bits


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ChunkedDeviceCapture:
    """Serves whole-epoch ranges of a wire capture as flat complex64
    tensors on ``device``, uploading and conditioning fixed-size chunks of
    words on demand and dropping the chunks behind the read cursor."""

    def __init__(self, words: np.ndarray, chunk_epochs: int, spe: int,
                 device):
        from ..utils.device import card_or_cpu

        self.words = np.asarray(words, np.uint16)
        self.chunk_epochs = chunk_epochs
        self.spe = spe
        self.device = card_or_cpu(device, "ChunkedDeviceCapture")
        self.total_epochs = len(self.words) // WORDS_PER_EPOCH
        self._chunks: dict = {}
        self.upload_s = 0.0
        self.uploads = 0

    def _chunk(self, idx: int):
        from ..signal.capture import reference_to_baseband_device

        c = self._chunks.get(idx)
        if c is not None:
            return c
        w0 = idx * self.chunk_epochs * WORDS_PER_EPOCH
        w1 = min(w0 + self.chunk_epochs * WORDS_PER_EPOCH,
                 self.total_epochs * WORDS_PER_EPOCH)
        t0 = time.perf_counter()
        bb = reference_to_baseband_device(self.words[w0:w1],
                                          device=self.device)
        _sync(self.device)
        self.upload_s += time.perf_counter() - t0
        self.uploads += 1
        self._chunks[idx] = bb
        return bb

    def epochs(self, start_epoch: int, n_epochs: int):
        """Epochs [start, start + n) as a flat (n * spe,) tensor."""
        import torch

        end = min(start_epoch + n_epochs, self.total_epochs)
        i0 = start_epoch // self.chunk_epochs
        i1 = (end - 1) // self.chunk_epochs
        parts = [self._chunk(i) for i in range(i0, i1 + 1)]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        off = (start_epoch - i0 * self.chunk_epochs) * self.spe
        for k in [k for k in self._chunks if k < i0]:
            del self._chunks[k]
        return flat[off: off + (end - start_epoch) * self.spe]


class BasebandDeviceCapture:
    """The host-conditioned ingest: the whole capture conditioned on the
    host once, each range's complex64 samples uploaded to ``device``."""

    def __init__(self, words: np.ndarray, spe: int, device):
        from ..runtime import native
        from ..signal.capture import reference_to_baseband
        from ..utils.device import card_or_cpu

        self.device = card_or_cpu(device, "BasebandDeviceCapture")
        self.bb = reference_to_baseband(native.unpack_bits16(
            np.asarray(words, np.uint16)))
        self.spe = spe
        self.total_epochs = len(self.bb) // spe
        self.upload_s = 0.0
        self.uploads = 0

    def epochs(self, start_epoch: int, n_epochs: int):
        import torch

        end = min(start_epoch + n_epochs, self.total_epochs)
        t0 = time.perf_counter()
        out = torch.as_tensor(
            self.bb[start_epoch * self.spe: end * self.spe]).to(self.device)
        _sync(self.device)
        self.upload_s += time.perf_counter() - t0
        self.uploads += 1
        return out


def receiver_config(prns, cib: int = 20, block_epochs: int = 256,
                    jnp_track: bool = False):
    """The tool's ReceiverConfig (tools/tpu_e2e.py:332-342)."""
    import dataclasses

    from ..config import ReceiverConfig, TrackConfig

    cfg = ReceiverConfig(
        prns=tuple(prns),
        track=TrackConfig(codes_in_bit=cib, pll_bad_state_threshold=10**9,
                          in_kernel_scan=False if jnp_track else None),
        track_block_epochs=block_epochs)
    return cfg.replace(acq=dataclasses.replace(cfg.acq, use_matmul_dft=True))


def run(words, truth, cib: int = 20, block_epochs: int = 256,
        chunk_epochs: int = 256, ingest: str = "wire",
        jnp_track: bool = False, device="cuda") -> tuple:
    """One wire-to-fix run on ``device``: (result dict, receiver).  The
    result carries the tool's keys, and ``blocks_on_device`` (the blocks
    handed to ``process_block`` as tensors on the receiver's device)."""
    import torch

    from ..config import BASEBAND_PLAN
    from ..runtime.receiver import Receiver

    spe = BASEBAND_PLAN.samples_per_epoch
    cap = (ChunkedDeviceCapture(words, chunk_epochs, spe, device)
           if ingest == "wire" else BasebandDeviceCapture(words, spe, device))
    prns = tuple(s["prn"] for s in truth["sats"])
    cfg = receiver_config(prns, cib, block_epochs, jnp_track)
    rx = Receiver(cfg, device=cap.device)
    acq_e = cfg.acq.noncoherent_epochs
    t0 = time.perf_counter()
    samples0 = cap.epochs(0, max(256 + acq_e, chunk_epochs))
    rx.acquire_all(samples0)
    rx.start_tracking(samples0[acq_e * spe:], start_epoch=acq_e)
    rx.epoch_cursor = acq_e
    _sync(cap.device)
    cold_start_s = time.perf_counter() - t0
    del samples0

    cursor, walls, on_device = acq_e, [], 0
    while cursor + block_epochs <= cap.total_epochs:
        t0 = time.perf_counter()
        block = cap.epochs(cursor, block_epochs)
        on_device += (isinstance(block, torch.Tensor)
                      and block.device.type == rx.device.type
                      and rx.device.index in (None, block.device.index))
        rx.process_block(block)
        walls.append(time.perf_counter() - t0)
        cursor += block_epochs

    out = {"device": str(rx.device), "ingest": ingest,
           "epochs_processed": cursor, "cold_start_s": cold_start_s,
           "blocks": len(walls), "block_epochs": block_epochs,
           "blocks_on_device": on_device, "uploads": cap.uploads,
           "upload_s": cap.upload_s, "solutions": len(rx.solutions)}
    if walls:
        bw = np.asarray(walls)
        steady = bw[1:] if len(bw) > 1 else bw
        out["block_wall_s_min_med_max"] = [
            float(f(steady)) for f in (np.min, np.median, np.max)]
        out["sustained_rt_x"] = block_epochs * 1e-3 / float(np.median(steady))
        out["whole_capture_rt_x"] = (len(bw) * block_epochs * 1e-3
                                     / float(bw.sum()))
    out["pass"] = False
    if rx.solutions:
        rr_true = np.asarray(truth["rr_ecef"])
        errs = [float(np.linalg.norm(s.rr - rr_true)) for s in rx.solutions]
        out["fix_error_m_last"] = errs[-1]
        out["fix_error_m_min"] = min(errs)
        out["fix_error_m_all"] = errs
        out["pass"] = bool(errs[-1] < 500.0 and all(
            ch.eph.has_full_set for ch in rx.channels))
    return out, rx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="wire capture -> conditioning on the device -> fix")
    ap.add_argument("--duration-ms", type=int, default=29_000)
    ap.add_argument("--cn0", type=float, default=48.0)
    ap.add_argument("--cib", type=int, default=20)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--block-epochs", type=int, default=256)
    ap.add_argument("--chunk-epochs", type=int, default=256)
    ap.add_argument("--ingest", default="wire", choices=("wire", "baseband"))
    ap.add_argument("--jnp-track", action="store_true",
                    help="the reference scan in place of the tracking-scan "
                         "kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--state-dir", default=None,
                    help="where the capture is written (default: a "
                         "temporary directory)")
    args = ap.parse_args(argv)

    from ..runtime import native

    if args.state_dir:
        os.makedirs(args.state_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        words, truth = native.capture_gen(
            args.state_dir or tmp, "wire_e2e", cib=args.cib,
            duration_ms=args.duration_ms, cn0=args.cn0, seed=args.seed,
            repeats=args.repeats)
    out, _ = run(words, truth, cib=args.cib, block_epochs=args.block_epochs,
                 chunk_epochs=args.chunk_epochs, ingest=args.ingest,
                 jnp_track=args.jnp_track, device=args.device)
    print(json.dumps(out), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
