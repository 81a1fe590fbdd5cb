"""The frame's i16 wire format (`render/wire.py`): a value quantized on the
host comes back from the device's de-quantize as the value itself when it
lies on its column's 1/scale grid, and held to ±32767 steps beyond it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_git_tpu_torch.render import wire as W


@pytest.mark.parametrize("part", range(len(W.PARTS)),
                         ids=[name for name, _ in W.PARTS])
def test_quantize_dequantize_round_trip(part):
    rng = np.random.default_rng(part)
    ci, cols, scale = W.PART_CLS[part], W.PARTS[part][1], W.SCALES[part]
    n = 40
    caps = tuple(48 if c == ci else 8 for c in range(3))
    used = tuple(n if c == ci else 0 for c in range(3))
    steps = rng.integers(-32767, 32768, (n, cols))
    steps[0], steps[1] = 32767, -32767
    # Every scale is a power of two, so steps / scale is exact in f32.
    vals = (steps / scale).astype(np.float32)
    vals[2], vals[3] = 1e9, -1e9   # beyond the format: clamped
    want_steps = steps.copy()
    want_steps[2], want_steps[3] = 32767, -32767
    tables = [np.zeros((caps[c], k), np.float32)
              for (_, k), c in zip(W.PARTS, W.PART_CLS)]
    tables[part][:n] = vals

    blob = W.quantize(tuple(tables), used, caps)
    assert blob.dtype == np.int16 and blob.size == W.words(caps)
    at = W.table_offsets(0, caps, ci)[W.CLS_TABLES[ci].index(part)]
    assert np.array_equal(blob[at:at + n * cols].reshape(n, cols),
                          want_steps)
    got = W.dequantize(torch.from_numpy(blob), caps)
    assert [tuple(t.shape) for t in got] == \
        [(caps[c], k) for (_, k), c in zip(W.PARTS, W.PART_CLS)]
    assert got[part].dtype == torch.float32
    assert np.array_equal(got[part][:n].numpy(),
                          (want_steps / scale).astype(np.float32))
    assert not got[part][n:].any()
