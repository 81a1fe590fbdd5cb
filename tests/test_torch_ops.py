"""The port's host ops against the reference's: the numpy Lanczos resize
(`ops/image.py`) against the JAX op, and the copied bezier math
(`ops/bezier.py`), which keeps the numpy namespace only."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from whisper_git_tpu.ops import bezier as ref_bezier
from whisper_git_tpu.ops import image as ref_image
from whisper_git_tpu_torch.ops import bezier as port_bezier
from whisper_git_tpu_torch.ops import image as port_image


@pytest.mark.parametrize("shape", [(96, 96, 4), (40, 50, 3),
                                   (2, 128, 100, 4), (200, 64, 4)])
def test_resize_lanczos_matches_reference(shape):
    """Same sampling matrices, f32 products in numpy instead of XLA: a
    value that lands on .5 before rounding may round the other way, so
    the bound is 1 u8, on under 0.1 % of values."""
    rng = np.random.default_rng(len(shape) * 1000 + shape[0])
    imgs = rng.integers(0, 256, shape).astype(np.uint8)
    want = ref_image.resize_lanczos(imgs, 64, 64)
    got = port_image.resize_lanczos(imgs, 64, 64)
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"resize {shape}: max {d.max()} u8, differing {(d > 0).mean():.6f}")
    assert d.max() <= 1
    assert (d > 0).mean() < 0.001


def test_resize_lanczos_matrices_are_the_references():
    for n_in, n_out in ((96, 64), (40, 64), (200, 64), (64, 64)):
        assert np.array_equal(port_image._lanczos_matrix(n_in, n_out),
                              ref_image._lanczos_matrix(n_in, n_out))


def _cubics(rng, n):
    x0, x1 = rng.uniform(0, 200, n), rng.uniform(0, 200, n)
    y0 = rng.uniform(0, 100, n)
    y1 = y0 + rng.uniform(10, 60, n)
    return [a.astype(np.float32) for a in (x0, y0, x1, y1)]


def test_bezier_copy_equals_reference_on_numpy():
    rng = np.random.default_rng(7)
    x0, y0, x1, y1 = _cubics(rng, 32)
    ref = ref_bezier.s_curve(x0, y0, x1, y1)
    port = port_bezier.s_curve(x0, y0, x1, y1)
    assert np.array_equal(ref, port)
    t = rng.uniform(0, 1, 32).astype(np.float32)
    y = (y0 + (y1 - y0) * t).astype(np.float32)
    for name, args in (("point_at", (ref, t)), ("y_at", (ref, t)),
                       ("t_at_y", (ref, y)), ("flatten", (ref,))):
        a = getattr(ref_bezier, name)(*args)
        b = getattr(port_bezier, name)(*args)
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_bezier_copy_refuses_other_namespaces():
    with pytest.raises(TypeError, match="numpy"):
        port_bezier.s_curve(jnp.zeros(2), jnp.zeros(2), jnp.ones(2),
                            jnp.ones(2))
