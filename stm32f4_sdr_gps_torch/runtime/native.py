"""ctypes bindings to the native ingest library (native/sdr_native.cpp),
the port's own copy of the JAX package's runtime/native.py (numpy and
ctypes only; the fallbacks use the port's signal/capture.py).

Builds the library on demand with the repo Makefile (g++).  Where the
toolchain is unavailable only the bit codecs degrade: ``unpack_bits16``
and ``pack_bits16`` fall back to NumPy, which is exact.  What the
library alone provides reports its absence: the firmware oracles
(``correlate_1bit_oracle``, ``firmware_receiver_run``,
``firmware_master_run``) return None, and ``NativeRing`` raises.  The
wire-format generator ``native/capture_gen`` is built and run by
:func:`capture_gen`, which raises where it cannot be.  The module itself
imports anywhere.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(NATIVE_DIR, "libsdr_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _make(*targets: str) -> None:
    """Bring TARGETS in native/ up to date with its Makefile, one of this
    package's processes at a time (an exclusive lock on
    native/.build.lock).  A stale target is built in a scratch directory
    beside the sources and moved into place in one rename: no process
    loads or runs a file this function is still writing."""
    import fcntl
    import tempfile

    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stale = [t for t in targets if subprocess.run(
            ["make", "-q", t], cwd=NATIVE_DIR,
            capture_output=True).returncode != 0]
        if not stale:
            return
        with tempfile.TemporaryDirectory(prefix=".build-",
                                         dir=NATIVE_DIR) as tmp:
            for f in os.listdir(NATIVE_DIR):
                if f.endswith(".cpp"):
                    os.symlink(os.path.join(NATIVE_DIR, f),
                               os.path.join(tmp, f))
            subprocess.run(
                ["make", "-s", "-f", os.path.join(NATIVE_DIR, "Makefile"),
                 *stale], cwd=tmp, check=True, capture_output=True)
            for t in stale:
                os.replace(os.path.join(tmp, t), os.path.join(NATIVE_DIR, t))


def _build() -> bool:
    try:
        _make("libsdr_native.so")
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.sdr_unpack_bits16.argtypes = [u16p, ctypes.c_int64, f32p]
    lib.sdr_pack_bits16.argtypes = [f32p, ctypes.c_int64, u16p]
    lib.sdr_correlate_1bit.argtypes = [
        u8p, u8p, u8p, ctypes.c_int32, ctypes.c_int32, i32p, i32p
    ]
    lib.sdr_correlation_search.argtypes = [
        u8p, u8p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p
    ]
    lib.sdr_correlation_search.restype = ctypes.c_int32
    lib.sdr_ring_create.argtypes = [ctypes.c_int64]
    lib.sdr_ring_create.restype = ctypes.c_void_p
    lib.sdr_ring_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("sdr_ring_available", "sdr_ring_space"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int64
    lib.sdr_ring_push.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.sdr_ring_push.restype = ctypes.c_int64
    lib.sdr_ring_pop.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.sdr_ring_pop.restype = ctypes.c_int64
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32a = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.fw_rx_run.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        i8p, i32a, ctypes.c_int32, i32p,
        f32p, f32p, i32a, ctypes.c_int32, i32p,
        i32p, i32p, i32p, i32p,
    ]
    lib.fw_rx_run.restype = ctypes.c_int32
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.fw_master_run.argtypes = [
        u8p, ctypes.c_int64, i32a, i32a, ctypes.c_int32,
        i32a, i32a, i32a, i32a, i32a,
        i8p, i32a, ctypes.c_int32, i32a,
        f32p, f32p, i32a, ctypes.c_int32, i32a,
        i32a, f64p, f64p, ctypes.c_int32, i32p,
    ]
    lib.fw_master_run.restype = ctypes.c_int32
    _lib = lib
    return _lib


def unpack_bits16(words: np.ndarray) -> np.ndarray:
    """uint16 LSB-first words -> float32 +/-1 samples (native fast path;
    NumPy fallback matches capture.unpack_bits_lsb16)."""
    words = np.ascontiguousarray(words, dtype=np.uint16)
    lib = get_lib()
    if lib is None:
        from ..signal.capture import unpack_bits_lsb16

        return unpack_bits_lsb16(words)
    out = np.empty(len(words) * 16, dtype=np.float32)
    lib.sdr_unpack_bits16(words, len(words), out)
    return out


def pack_bits16(signs: np.ndarray) -> np.ndarray:
    signs = np.ascontiguousarray(signs, dtype=np.float32)
    if len(signs) % 16:
        raise ValueError("sample count must be a multiple of 16")
    lib = get_lib()
    if lib is None:
        from ..signal.capture import pack_bits_lsb16

        return pack_bits_lsb16(signs)
    out = np.empty(len(signs) // 16, dtype=np.uint16)
    lib.sdr_pack_bits16(signs, len(out), out)
    return out


def correlate_1bit_oracle(data_i: np.ndarray, data_q: np.ndarray,
                          prn: np.ndarray, offset: int):
    """Firmware-exact packed-bit correlation (gps_correlation_iq
    semantics); None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    si = ctypes.c_int32()
    sq = ctypes.c_int32()
    lib.sdr_correlate_1bit(
        np.ascontiguousarray(data_i, np.uint8),
        np.ascontiguousarray(data_q, np.uint8),
        np.ascontiguousarray(prn, np.uint8),
        len(prn), offset, ctypes.byref(si), ctypes.byref(sq),
    )
    return si.value, sq.value


def firmware_receiver_run(words: np.ndarray, prn: int,
                          doppler_hint_hz: int):
    """Run the firmware-semantics single-channel 1-bit receiver
    (native/firmware_rx.cpp — acquisition, pre-track, TDM tracking,
    bit extraction with the reference's exact numerics) over a packed
    uint16 wire-format capture.  Returns a dict of nav bits / loop
    trajectories / milestones, or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint16)
    n_ms = len(words) // 1023
    byts = words[: n_ms * 1023].view(np.uint8)
    bit_cap = int(n_ms // 20 + 4)
    traj_cap = int(n_ms // 17 + 4)
    bits = np.zeros(bit_cap, np.int8)
    bit_times = np.zeros(bit_cap, np.int32)
    cp = np.zeros(traj_cap, np.float32)
    dop = np.zeros(traj_cap, np.float32)
    tt = np.zeros(traj_cap, np.int32)
    n_bits = ctypes.c_int32()
    n_traj = ctypes.c_int32()
    acq_cp = ctypes.c_int32()
    track_ms = ctypes.c_int32()
    sync_ms = ctypes.c_int32()
    n_sf = ctypes.c_int32()
    rc = lib.fw_rx_run(
        np.ascontiguousarray(byts), n_ms, prn, int(doppler_hint_hz),
        bits, bit_times, bit_cap, ctypes.byref(n_bits),
        cp, dop, tt, traj_cap, ctypes.byref(n_traj),
        ctypes.byref(acq_cp), ctypes.byref(track_ms),
        ctypes.byref(sync_ms), ctypes.byref(n_sf),
    )
    nb, nt = n_bits.value, n_traj.value
    return dict(
        tracking=rc == 0,
        bits=bits[:nb],
        bit_times=bit_times[:nb],
        code_phase_fine=cp[:nt],
        doppler_hz=dop[:nt],
        traj_times=tt[:nt],
        acq_code_phase_halfchips=acq_cp.value,
        track_start_ms=track_ms.value,
        sync_ms=sync_ms.value,
        subframes=n_sf.value,
    )


def firmware_master_run(words: np.ndarray, prns, hints=None):
    """Run the firmware-semantics MULTI-channel receiver
    (native/firmware_rx.cpp fw_master_run — gps_master sequencing, cold
    frequency search when unhinted, TDM tracking, subframe-time ledger,
    relative pseudoranges) over a packed uint16 wire-format capture.

    ``hints`` maps per-channel Doppler hints in Hz (0 / None = cold
    frequency search, the firmware's given_freq_offset_hz convention).
    Returns a dict of per-channel results + the relative pseudorange
    series, or None if the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint16)
    n_ms = len(words) // 1023
    byts = np.ascontiguousarray(words[: n_ms * 1023].view(np.uint8))
    n_ch = len(prns)
    prns_a = np.ascontiguousarray(prns, dtype=np.int32)
    if hints is None:
        hints = [0] * n_ch
    hints_a = np.ascontiguousarray(
        [int(h or 0) for h in hints], dtype=np.int32)
    bit_cap = int(n_ms // 20 + 4)
    traj_cap = int(n_ms // 17 + 4)
    pr_cap = int(n_ms // 17 + 4)
    found_freq = np.zeros(n_ch, np.int32)
    found_cp = np.zeros(n_ch, np.int32)
    track_ms = np.zeros(n_ch, np.int32)
    sync_ms = np.zeros(n_ch, np.int32)
    n_sf = np.zeros(n_ch, np.int32)
    bits = np.zeros((n_ch, bit_cap), np.int8)
    bit_times = np.zeros((n_ch, bit_cap), np.int32)
    n_bits = np.zeros(n_ch, np.int32)
    cp = np.zeros((n_ch, traj_cap), np.float32)
    dop = np.zeros((n_ch, traj_cap), np.float32)
    tt = np.zeros((n_ch, traj_cap), np.int32)
    n_traj = np.zeros(n_ch, np.int32)
    pr_times = np.zeros(pr_cap, np.int32)
    pr_m = np.zeros((n_ch, pr_cap), np.float64)
    tow_s = np.zeros((n_ch, pr_cap), np.float64)
    n_pr = ctypes.c_int32()
    rc = lib.fw_master_run(
        byts, n_ms, prns_a, hints_a, n_ch,
        found_freq, found_cp, track_ms, sync_ms, n_sf,
        bits.reshape(-1), bit_times.reshape(-1), bit_cap, n_bits,
        cp.reshape(-1), dop.reshape(-1), tt.reshape(-1), traj_cap, n_traj,
        pr_times, pr_m.reshape(-1), tow_s.reshape(-1), pr_cap,
        ctypes.byref(n_pr),
    )
    npr = n_pr.value
    chans = []
    for i in range(n_ch):
        nb, nt = int(n_bits[i]), int(n_traj[i])
        chans.append(dict(
            prn=int(prns_a[i]),
            found_freq_hz=int(found_freq[i]),
            acq_code_phase_halfchips=int(found_cp[i]),
            track_start_ms=int(track_ms[i]),
            sync_ms=int(sync_ms[i]),
            subframes=int(n_sf[i]),
            bits=bits[i, :nb].copy(),
            bit_times=bit_times[i, :nb].copy(),
            code_phase_fine=cp[i, :nt].copy(),
            doppler_hz=dop[i, :nt].copy(),
            traj_times=tt[i, :nt].copy(),
        ))
    return dict(
        tracking_count=rc,
        channels=chans,
        pr_times_ms=pr_times[:npr].copy(),
        pseudorange_m=pr_m[:, :npr].copy(),
        tow_s=tow_s[:, :npr].copy(),
    )


class NativeRing:
    """SPSC ring buffer over the native library (streaming ingest)."""

    def __init__(self, capacity_floats: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.sdr_ring_create(capacity_floats)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sdr_ring_destroy(self._h)
            self._h = None

    def push(self, arr: np.ndarray) -> bool:
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        return bool(self._lib.sdr_ring_push(self._h, arr, len(arr)))

    def pop(self, n: int) -> Optional[np.ndarray]:
        out = np.empty(n, dtype=np.float32)
        if not self._lib.sdr_ring_pop(self._h, out, n):
            return None
        return out

    @property
    def available(self) -> int:
        return self._lib.sdr_ring_available(self._h)


def capture_gen(directory: str, name: str = "cap", **flags):
    """Build (if needed) and run the independent wire-format generator
    ``native/capture_gen`` with ``--flag value`` for each keyword
    (underscores become dashes), writing ``name.bin`` and
    ``name.truth.json`` into ``directory``.  Returns (uint16 SPI words,
    truth dict); raises CalledProcessError where make or the generator
    fails."""
    _make("capture_gen")
    cap = os.path.join(directory, f"{name}.bin")
    truth = os.path.join(directory, f"{name}.truth.json")
    args = [os.path.join(NATIVE_DIR, "capture_gen"), "--out", cap,
            "--truth", truth]
    for k, v in flags.items():
        args += [f"--{k.replace('_', '-')}", str(v)]
    subprocess.run(args, check=True, capture_output=True)
    with open(truth) as f:
        return np.fromfile(cap, dtype=np.uint16), json.load(f)
