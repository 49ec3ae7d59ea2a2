"""Page-locked uploads of windows (utils/device.py ``HostPages``,
``upload_window``): which windows register their owner, once, and how
the registration ends, through fakes of the register and unregister
calls.  The copies themselves, and libcuda's own answers, are tested on
the card (tests/test_torch_cuda.py)."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from stm32f4_sdr_gps_torch.signal import capture as cap
from stm32f4_sdr_gps_torch.utils import device, profiling

W = 4096
#: the real-IF front end (SoftGNSS): 38,192 int8 samples a millisecond
FS, IF, SPE = 38192000.0, 9548000.0, 38192


class FakePages(device.HostPages):
    """HostPages with its register and unregister calls recorded;
    ``refuse`` is the error code every register returns."""

    def __init__(self, refuse=0):
        super().__init__()
        self.refuse = refuse
        self.registered, self.unregistered = [], []

    def register(self, ptr, nbytes):
        self.registered.append((ptr, nbytes))
        return self.refuse

    def unregister(self, ptr):
        # the owner's bytes, read where its registration is released:
        # still its own pattern, so its memory was not freed before
        self.unregistered.append((ptr, ctypes.string_at(ptr, 8)))
        return 0


class Untouchable(device.HostPages):
    def register(self, ptr, nbytes):
        raise AssertionError("registered")

    def unregister(self, ptr):
        raise AssertionError("unregistered")


def _moved(before, *names):
    return {k: profiling.counters.get(k, 0) - before.get(k, 0)
            for k in names}


def test_one_owner_is_registered_once_across_many_windows():
    pages = FakePages()
    owner = np.zeros(10 * W, np.int8)
    before = dict(profiling.counters)
    for k in range(10):
        assert pages.locked(owner[k * W:(k + 1) * W])
    # a view of a view finds the same owner
    assert pages.locked(owner[W:5 * W][W:2 * W])
    assert pages.registered == [(owner.ctypes.data, owner.nbytes)]
    assert _moved(before, "upload.register", "upload.register_failed") == {
        "upload.register": 1, "upload.register_failed": 0}


@pytest.mark.parametrize("how", ["standalone", "copy", "whole_owner",
                                 "tensor_memory", "bytes"])
def test_a_window_that_owns_its_memory_is_never_registered(how):
    pages = FakePages()
    big = np.zeros(10 * W, np.int8)
    window = {"standalone": lambda: np.zeros(W, np.int8),
              "copy": lambda: big[:W].copy(),
              "whole_owner": lambda: big,
              # chains that end in another object than an ndarray
              "tensor_memory": lambda: torch.zeros(10 * W,
                                                   dtype=torch.int8)
              .numpy()[:W],
              "bytes": lambda: np.frombuffer(bytes(10 * W),
                                             np.int8)[:W]}[how]()
    assert not pages.locked(window)
    assert pages.registered == []


@pytest.mark.parametrize("owner_windows,locked", [(1.0, False), (1.5, False),
                                                  (2.0, True), (26.0, True)])
def test_an_owner_under_two_windows_is_never_registered(owner_windows,
                                                        locked):
    pages = FakePages()
    owner = np.zeros(int(owner_windows * W), np.int8)
    assert pages.locked(owner[:W]) is locked
    assert len(pages.registered) == int(locked)


def test_collection_unregisters_before_the_memory_is_freed():
    pages = FakePages()
    owner = np.full(256 * W, 0x5A, np.int8)
    ptr = owner.ctypes.data
    window = owner[3 * W:4 * W]
    assert pages.locked(window)
    del owner
    gc.collect()
    assert pages.unregistered == []          # the window holds its owner
    del window
    gc.collect()
    assert pages.unregistered == [(ptr, b"\x5a" * 8)]
    # the entry went with its owner: a new buffer of the size is tried
    # afresh, at the same address or another
    again = np.full(256 * W, 1, np.int8)
    assert pages.locked(again[:W])
    assert len(pages.registered) == 2


@pytest.mark.parametrize("code", [712, 1, -1])
def test_a_refused_registration_falls_back_once(code):
    pages = FakePages(refuse=code)
    owner = np.zeros(8 * W, np.int8)
    before = dict(profiling.counters)
    for k in range(5):
        assert not pages.locked(owner[k * W:(k + 1) * W])
    assert len(pages.registered) == 1
    assert _moved(before, "upload.register", "upload.register_failed") == {
        "upload.register": 0, "upload.register_failed": 1}
    del owner
    gc.collect()
    assert pages.unregistered == []          # nothing was locked


def test_the_cpu_never_touches_the_seam(monkeypatch):
    monkeypatch.setattr(device, "host_pages", Untouchable())
    capture = np.random.default_rng(5).integers(-127, 128, 6 * SPE,
                                                dtype=np.int8)
    window = capture[SPE:2 * SPE]
    before = dict(profiling.counters)
    got = device.upload_window(window, "cpu")
    assert torch.equal(got, torch.from_numpy(window))
    y = cap.if_to_baseband_device(window, FS, IF, device="cpu")
    assert torch.equal(y, cap.if_to_baseband_device(window.copy(), FS, IF,
                                                    device="cpu"))
    assert _moved(before, "upload", "upload.registered", "upload.register",
                  "condition.bytes") == {
        "upload": 3, "upload.registered": 0, "upload.register": 0,
        "condition.bytes": 2 * SPE}
