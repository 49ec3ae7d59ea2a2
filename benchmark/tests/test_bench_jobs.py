"""The wire ingest: blocks served from chunks conditioned one at a time
equal the whole capture conditioned at once."""

import json
import os

import numpy as np
import torch

from benchmark import gen, jobs, scene
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
    wc = jobs.WireChunks(words, chunk_epochs=6, device=torch.device("cpu"))
    assert wc.total_epochs == 20
    # blocks inside one chunk, across a chunk boundary, and at the end
    for start, n in ((0, 4), (4, 5), (9, 10), (19, 1)):
        got = wc.epochs(start, n).numpy()
        np.testing.assert_array_equal(
            got, whole[start * jobs.S: (start + n) * jobs.S].numpy())
    assert wc.condition_s > 0
    assert min(wc._chunks) >= 3       # chunks behind the cursor dropped
