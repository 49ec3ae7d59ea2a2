"""Where the port's tensors live: the card unless the caller asks for the
CPU, and never the CPU in place of a missing card; and the counted
copies between host and device (:func:`upload`, :func:`upload_window`,
:func:`readback`), the host buffers page-locked for them
(:class:`HostPages`)."""

from __future__ import annotations

import ctypes
import threading
import weakref

import numpy as np
import torch

from .profiling import count


def card_or_cpu(device, caller: str) -> torch.device:
    """``device`` as a torch.device.  Raises RuntimeError for a CUDA
    device where CUDA is not available: the port's entry points default
    to the card and do not fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device={device!r}): CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def upload(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)``, counted as
    one ``upload`` (``utils.profiling.count``) where ``data`` is host
    data (a numpy array, a list, a tuple).  The count does not depend on
    ``device``, so a CPU run counts the copies the card would make.  A
    tensor is passed through uncounted."""
    if not isinstance(data, torch.Tensor):
        count("upload")
    return torch.as_tensor(data, dtype=dtype, device=device)


def readback(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``, counted as one ``readback`` (on the card a
    device-to-host copy, which waits for the work queued before it)."""
    count("readback")
    return t.cpu().numpy()


def _owner(a: np.ndarray):
    """The ndarray at the end of ``a``'s ``.base`` chain that owns the
    memory ``a`` lies in (``a`` itself where it owns it), or None where
    the chain ends in another object (a mapped file, a tensor, bytes)."""
    while not a.flags.owndata:
        a = a.base
        if not isinstance(a, np.ndarray):
            return None
    return a


class HostPages:
    """Host buffers page-locked for the card's copy engines: one
    registration for each ndarray that owns the memory of the windows
    uploaded from it, made the first time a window of it crosses and
    released when the owner is collected (numpy clears an array's weak
    references before it frees its memory, so a buffer allocated again
    at the same address is never read through a stale registration).

    A window takes part only where it is a view into an owner that
    holds at least two windows' bytes: a caller that hands over such
    windows (a recording held whole, a front end's ring) hands over more
    of the same buffer, and locking a buffer to copy it once costs more
    than the copy.  An owner CUDA refuses (registered elsewhere
    already, a limit) is not tried again; its windows cross pageable.

    :meth:`register` and :meth:`unregister` are the one seam to CUDA,
    which a test replaces.  They call libcuda's ``cuMemHostRegister_v2``
    (with ``CU_MEMHOSTREGISTER_PORTABLE``: every context of the process)
    and ``cuMemHostUnregister``, not the runtime's ``cudaHostRegister``: a
    runtime call that fails leaves its error as the runtime's last
    error, which torch's next kernel-launch check raises as that
    kernel's, and torch binds no ``cudaGetLastError`` to clear it; a
    libcuda call returns its error and leaves nothing behind."""

    PORTABLE = 0x01

    def __init__(self):
        # (data pointer, bytes) -> (weak reference to the owner, locked?)
        self._owners: dict = {}
        self._lock = threading.RLock()
        self._libcuda = None

    def _cuda(self):
        if self._libcuda is None:
            lib = ctypes.CDLL("libcuda.so.1")
            lib.cuMemHostRegister_v2.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint]
            lib.cuMemHostRegister_v2.restype = ctypes.c_int
            lib.cuMemHostUnregister.argtypes = [ctypes.c_void_p]
            lib.cuMemHostUnregister.restype = ctypes.c_int
            self._libcuda = lib
        return self._libcuda

    def register(self, ptr: int, nbytes: int) -> int:
        """Page-locks ``nbytes`` at ``ptr`` for every card of the
        process (the current device's context must exist); libcuda's
        error code, 0 on success."""
        try:
            lib = self._cuda()
        except OSError:
            return -1
        return lib.cuMemHostRegister_v2(ptr, nbytes, self.PORTABLE)

    def unregister(self, ptr: int) -> int:
        """Releases the registration at ``ptr``; libcuda's error
        code."""
        return self._cuda().cuMemHostUnregister(ptr)

    def locked(self, window: np.ndarray) -> bool:
        """Whether ``window`` lies in memory page-locked here, registering
        its owner first where the owner qualifies and was not tried
        before (counted: ``upload.register`` once an owner locked,
        ``upload.register_failed`` once an owner refused)."""
        owner = _owner(window)
        # a window that owns its memory holds one window's bytes
        if owner is None or 2 * window.nbytes > owner.nbytes:
            return False
        key = (owner.ctypes.data, owner.nbytes)
        with self._lock:
            entry = self._owners.get(key)
            if entry is not None and entry[0]() is owner:
                return entry[1]
            ok = self.register(*key) == 0
            count("upload.register" if ok else "upload.register_failed")
            self._owners[key] = (weakref.ref(owner), ok)
            weakref.finalize(owner, self._release, key, ok).atexit = False
        return ok

    def _release(self, key, ok: bool) -> None:
        with self._lock:
            self._owners.pop(key, None)
        if ok:
            self.unregister(key[0])


#: the process's page-locked host buffers
host_pages = HostPages()


def upload_window(host, device) -> torch.Tensor:
    """``host`` (a C-contiguous ndarray, or a host tensor already
    page-locked) copied to ``device``, counted as one ``upload``.  On the
    card a window of a larger buffer (:class:`HostPages`) crosses by DMA
    from the caller's page-locked memory, as a pinned tensor does
    (counted ``upload.registered``); any other crosses as in
    :func:`upload`, through CUDA's pageable staging.  Either way
    the copy is done when the call returns, so the caller may overwrite
    its buffer at once.  On the CPU nothing is registered."""
    count("upload")
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.as_tensor(host, device=dev)
    tensor = isinstance(host, torch.Tensor)
    src = host if tensor else torch.from_numpy(host)
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    if tensor:
        locked = host.is_pinned()
    else:
        with torch.cuda.device(out.device):    # the context registers
            locked = host_pages.locked(host)
    if locked:
        count("upload.registered")
    out.copy_(src, non_blocking=False)
    return out
