"""`transfer.upload_fused` on the CPU: one blob, each array's view equal to
`transfer.upload` of it in values, shape and dtype, contiguous and at a
multiple of 256 B, and the upload counted once for the blob's bytes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from whisper_git_tpu_torch import tracing
from whisper_git_tpu_torch.render import transfer


def _mixed():
    rng = np.random.default_rng(20)
    return [rng.standard_normal((37, 16)).astype(np.float32),
            rng.standard_normal((5, 4)).astype(np.float32),
            rng.integers(-1, 900, (12, 8)).astype(np.int32),
            rng.standard_normal((3, 8)).astype(np.float32),
            rng.integers(-1, 40, (12, 32)).astype(np.int32)]


def _zero_rows():
    return [np.zeros((0, 16), np.float32), np.ones((2, 4), np.float32),
            np.zeros((0, 8), np.float32), np.zeros((0, 4), np.float32),
            np.full((6, 8), -1, np.int32)]


def _single():
    return [np.arange(300, dtype=np.int32).reshape(30, 10)]


@pytest.mark.parametrize("case", [_mixed, _zero_rows, _single],
                         ids=["mixed", "zero_rows", "single"])
def test_fused_views_equal_single_uploads(case):
    arrays = case()
    before = tracing.counters()
    views = transfer.upload_fused(arrays, "cpu")
    now = tracing.counters()
    delta = {k: now[k] - before[k] for k in before if now[k] != before[k]}
    storage = views[0].untyped_storage()
    assert len(views) == len(arrays)
    for a, v in zip(arrays, views):
        want = transfer.upload(a, "cpu")
        assert v.dtype == want.dtype and v.shape == want.shape
        assert torch.equal(v, want) and v.is_contiguous()
        assert v.untyped_storage().data_ptr() == storage.data_ptr()
        assert (v.storage_offset() * v.element_size()) % 256 == 0
    assert delta == {"upload.calls": 1, "upload.bytes": storage.nbytes(),
                     "upload.fused_calls": 1,
                     "upload.fused_parts": len(arrays)}
    assert storage.nbytes() == transfer.fused_offsets(arrays)[1]
    assert storage.nbytes() >= sum(a.nbytes for a in arrays)
