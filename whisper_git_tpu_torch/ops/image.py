"""Image resize as two separable Lanczos3 matrix products, on the host.

Counterpart of `whisper_git_tpu/ops/image.py`. The scene compiler resizes
an image that is not already one atlas tile (64×64) before writing it into
its host-side image atlas, so the products run in numpy f32 where the tile
is needed; the sampling matrices are the reference's.
"""

from __future__ import annotations

import functools

import numpy as np


def _lanczos_matrix(n_in: int, n_out: int, a: int = 3) -> np.ndarray:
    """(n_out, n_in) row-stochastic Lanczos-a sampling matrix."""
    scale = n_in / n_out
    support = a * max(scale, 1.0)
    x_out = (np.arange(n_out) + 0.5) * scale - 0.5
    idx = np.arange(n_in)
    dist = x_out[:, None] - idx[None, :]
    arg = dist / max(scale, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        lanc = np.sinc(arg) * np.sinc(arg / a)
    lanc = np.where(np.abs(arg) < a, lanc, 0.0)
    lanc = np.where(np.abs(dist) <= support, lanc, 0.0)
    s = lanc.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return (lanc / s).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrices(h_in: int, w_in: int, h_out: int, w_out: int
              ) -> tuple[np.ndarray, np.ndarray]:
    return _lanczos_matrix(h_in, h_out), _lanczos_matrix(w_in, w_out)


def resize_lanczos(imgs, h_out: int, w_out: int) -> np.ndarray:
    """Resize a batch (B, H, W, C) of u8/float images to (B, h_out, w_out, C)
    with Lanczos3. Returns u8."""
    imgs = np.asarray(imgs)
    squeeze = imgs.ndim == 3
    if squeeze:
        imgs = imgs[None]
    B, H, W, C = imgs.shape
    rows, cols = _matrices(H, W, h_out, w_out)
    x = np.einsum("oh,bhwc->bowc", rows, imgs.astype(np.float32))
    x = np.einsum("ow,bhwc->bhoc", cols, x)
    # round, don't truncate: a plain u8 cast floors, biasing every
    # non-exact value ~0.5 levels dark.
    out = np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return out[0] if squeeze else out
