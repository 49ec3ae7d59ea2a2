"""The wire ingest: blocks served from chunks conditioned one at a time
equal the whole capture conditioned at once.  The receiver each
committed configuration and traffic build, with and without the
control, is the one the benchmark built before receiver settings came
from the configuration."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import gen, jobs, scene, spec
from stm32f4_sdr_gps_torch.config import AcqConfig, ReceiverConfig, TrackConfig
from stm32f4_sdr_gps_torch.signal.capture import reference_to_baseband_device

from . import helpers


def test_wire_chunks_serve_the_conditioned_capture():
    with open(os.path.join(helpers.HERE, "configs",
                           "fw_max2769_4sat.json")) as f:
        cfg = json.load(f)
    sc = scene.build(cfg, 2 ** 31 + 77, 0, 0.02)
    words = gen.synthesize(sc, cfg["frontend"], 20, 77, "cpu",
                           chunk_epochs=8)
    whole = reference_to_baseband_device(words, device="cpu")
    feed = jobs.feed(spec.frontend("wire_1bit"), cfg["frontend"],
                     {"kind": "replay", "ingest": "wire_chunks"})
    wc = jobs.WireChunks(words, chunk_epochs=6, feed=feed,
                         device=torch.device("cpu"))
    assert wc.total_epochs == 20
    # blocks inside one chunk, across a chunk boundary, and at the end
    for start, n in ((0, 4), (4, 5), (9, 10), (19, 1)):
        got = wc.epochs(start, n).numpy()
        np.testing.assert_array_equal(
            got, whole[start * jobs.S: (start + n) * jobs.S].numpy())
    assert wc.condition_s > 0
    assert min(wc._chunks) >= 3       # chunks behind the cursor dropped


FW, ALL = (2, 7, 15, 24), tuple(range(1, 33))

#: (configuration, traffic, control): prns, track_block_epochs,
#: solve_period_ms, acq.noncoherent_epochs and track.codes_in_bit of the
#: receiver the benchmark built before; every other field the program's
#: default
BUILT_BEFORE = {
    ("fw_max2769_4sat", "coldstart266", False): (FW, 1000, 500, 10, 20),
    ("fw_max2769_4sat", "coldstart266", True): (FW, 1000, 500, 5, 20),
    ("fw_max2769_4sat", "iq_replay36s", False): (FW, 1000, 500, 10, 20),
    ("fw_max2769_4sat", "iq_replay36s", True): (FW, 1000, 2000, 10, 20),
    ("fw_max2769_4sat", "wire_coldstart266", False): (FW, 1000, 500, 10, 20),
    ("fw_max2769_4sat", "wire_coldstart266", True): (FW, 1000, 500, 5, 20),
    ("fw_max2769_4sat", "wire_replay36s", False): (FW, 100, 500, 10, 20),
    ("fw_max2769_4sat", "wire_replay36s", True): (FW, 100, 1000, 10, 20),
    ("iq2046k_allview32", "coldstart266", False): (ALL, 1000, 500, 10, 20),
    ("iq2046k_allview32", "coldstart266", True): (ALL, 1000, 500, 5, 20),
    ("iq2046k_allview32", "iq_replay36s", False): (ALL, 1000, 500, 10, 20),
    ("iq2046k_allview32", "iq_replay36s", True): (ALL, 1000, 2000, 10, 20),
    ("iq2046k_allview32", "wire_coldstart266", False):
        (ALL, 1000, 500, 10, 20),
    ("iq2046k_allview32", "wire_coldstart266", True):
        (ALL, 1000, 500, 5, 20),
    ("iq2046k_allview32", "wire_replay36s", False): (ALL, 100, 500, 10, 20),
    ("iq2046k_allview32", "wire_replay36s", True): (ALL, 100, 1000, 10, 20),
}


def _fields(obj, prefix=""):
    """Every field of a config dataclass, nested ones by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def _load(folder, name):
    with open(os.path.join(helpers.HERE, folder, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config,traffic,control", sorted(BUILT_BEFORE))
def test_receiver_config_is_the_one_built_before(config, traffic, control):
    prns, block, period, nc, cib = BUILT_BEFORE[config, traffic, control]
    want = ReceiverConfig(prns=prns, track_block_epochs=block,
                          solve_period_ms=period,
                          acq=AcqConfig(noncoherent_epochs=nc),
                          track=TrackConfig(codes_in_bit=cib))
    got = jobs.receiver_config(_load("configs", config),
                               _load("traffic", traffic), control)
    assert _fields(got) == _fields(want)
