"""The port's exact EDT (`whisper_git_tpu_torch/ops/sdf.py`) against the
reference's (`whisper_git_tpu/ops/sdf.py`, JAX on the CPU) on seeded
coverages. The arithmetic is the same f32 ops in the same order, so the
tolerance is none: the f32 distances are equal and the u8 cells
identical."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_git_tpu.ops import sdf as ref
from whisper_git_tpu_torch.ops import sdf as port

torch.set_num_threads(2)


def _coverage(kind: str, shape, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape).astype(np.float32)
    if kind == "sparse":
        return (rng.random(shape) < 0.03).astype(np.float32)
    if kind == "empty":
        return np.zeros(shape, np.float32)
    if kind == "full":
        return np.ones(shape, np.float32)
    if kind == "pixel":
        c = np.zeros(shape, np.float32)
        c[shape[0] // 3, shape[1] - 1] = 1.0
        return c
    if kind == "disc":
        ys, xs = np.mgrid[0:shape[0], 0:shape[1]]
        r = np.hypot(ys - shape[0] / 2, xs - shape[1] / 2)
        return np.clip(min(shape) / 3 - r, 0.0, 1.0).astype(np.float32)
    raise ValueError(kind)


KINDS = ("random", "sparse", "empty", "full", "pixel", "disc")
SHAPES = ((128, 128), (1, 40), (40, 1), (17, 33), (31, 16), (64, 5))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_row_dist_and_edt_equal_the_reference(kind, shape):
    seeds = _coverage(kind, shape) > 0.5
    got_row = port._row_dist(torch.from_numpy(seeds)).numpy()
    want_row = np.asarray(ref._row_dist(jnp.asarray(seeds)))
    assert got_row.dtype == np.float32
    assert np.array_equal(got_row, want_row)
    got = port._edt(torch.from_numpy(seeds)).numpy()
    want = np.asarray(ref._edt(jnp.asarray(seeds)))
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_signed_distance_field_and_u8_equal_the_reference(kind, shape):
    cov = _coverage(kind, shape, seed=1)
    got = port.signed_distance_field(torch.from_numpy(cov), max_dist=16.0)
    want = np.asarray(ref.signed_distance_field(jnp.asarray(cov),
                                                max_dist=16.0))
    assert np.array_equal(got.numpy(), want)
    got_u8 = port.sdf_to_u8(got / 2, spread=8.0).numpy()
    want_u8 = np.asarray(ref.sdf_to_u8(jnp.asarray(want) / 2, spread=8.0))
    assert got_u8.dtype == np.uint8 and np.array_equal(got_u8, want_u8)
    assert np.array_equal(port.u8_to_sdf(torch.from_numpy(got_u8)).numpy(),
                          np.asarray(ref.u8_to_sdf(jnp.asarray(want_u8))))


@pytest.mark.parametrize("chunk_elems", [port._MAX_BLOCK_ELEMS["cpu"],
                                         port._MAX_BLOCK_ELEMS["cuda"],
                                         2 * 16 * 128 * 128,
                                         3 * 2 * 16 * 128 * 128])
def test_batch_equals_the_reference_in_any_chunking(monkeypatch,
                                                    chunk_elems):
    """A padded bank batch (16 cells of 128×128, a few empty) through the
    batched EDT in chunks of 2 cells (the CPU's), all 16 (the card's), one
    and three: the same cells as the reference's sequential map."""
    monkeypatch.setitem(port._MAX_BLOCK_ELEMS, "cpu", chunk_elems)
    cov = np.stack([_coverage(KINDS[i % len(KINDS)], (128, 128), seed=i)
                    for i in range(13)] + [np.zeros((128, 128), np.float32)]
                   * 3)
    got = port.signed_distance_field_batch(torch.from_numpy(cov), 16.0)
    want = np.asarray(ref.signed_distance_field_batch(jnp.asarray(cov),
                                                      max_dist=16.0))
    assert got.shape == cov.shape and np.array_equal(got.numpy(), want)


def test_sdf_circle():
    """The reference's own checks of the transform (tests/test_ops.py)."""
    H = W = 64
    ys, xs = np.mgrid[0:H, 0:W]
    r = np.hypot(ys - 32, xs - 32)
    coverage = (r <= 20).astype(np.float32)
    sdf = port.signed_distance_field(torch.from_numpy(coverage)).numpy()
    assert sdf[32, 32] < -10          # deep inside
    assert sdf[0, 0] > 10             # far outside
    ring = np.abs(r - 20) < 1.0       # near the boundary
    assert np.abs(sdf[ring]).max() < 2.5


def test_sdf_u8_roundtrip():
    vals = torch.tensor([[-8.0, -1.0, 0.0, 1.0, 8.0]])
    dec = port.u8_to_sdf(port.sdf_to_u8(vals)).numpy()
    np.testing.assert_allclose(dec, vals.numpy(), atol=0.08)


def test_encode_sdf_cells_equals_the_reference():
    """The atlas pipeline's back half: the same coverages give the same
    u8 cells through `render/atlas.py::encode_sdf_cells` of each
    package."""
    from whisper_git_tpu.render.atlas import encode_sdf_cells as ref_encode
    from whisper_git_tpu_torch.render.atlas import encode_sdf_cells

    cov = np.stack([_coverage(kind, (128, 128), seed=7) for kind in KINDS])
    got = encode_sdf_cells(cov, "cpu")
    want = ref_encode(cov)
    assert got.shape == (len(KINDS), 64, 64) and got.dtype == np.uint8
    assert np.array_equal(got, want)
