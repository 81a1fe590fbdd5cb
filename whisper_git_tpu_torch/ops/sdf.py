"""Signed-distance-field generation: the exact Euclidean distance transform,
as plain torch ops on the input's device.

Counterpart of `whisper_git_tpu/ops/sdf.py`, the same two phases in the
same f32 arithmetic (each root correctly rounded, as XLA's), so the
distances come out equal to the reference's and the u8 cells byte-equal:

  phase 1 — per-row distance to the nearest seed from two scans, a
            `cummax` left to right and a `cummin` over the flipped row;
  phase 2 — exact column mixing as a min-plus reduction,
            D²[i,j] = min_i' ( (i-i')² + dx[i',j]² ),
            over blocks of `_ROW_BLOCK` output rows.

Both phases broadcast over any leading batch dimensions, so a batch of
cells, and a cell's two transforms (to the glyph and to the background),
run in one pass. `signed_distance_field_batch` cuts the batch into chunks
that keep the min-plus intermediate under `_MAX_BLOCK_ELEMS` of the
input's device.
"""

from __future__ import annotations

import torch

_BIG = 1e6  # larger than any atlas dimension; squares stay finite in f32

_ROW_BLOCK = 16

# The min-plus intermediate of one row block is (2, cells, block, H, W)
# f32, with as many cells as keep it under this many elements. On the card
# 2^24 (64 MiB, 32 cells of 128×128): there the EDT is bound by its
# launches, and a bank batch in one pass took half the time of a pass per
# transform. On the CPU 2^20 (4 MiB, 2 cells): there it is bound by
# memory, and the one-pass batch ran 4-5× slower than a pass per transform
# on the card machine's CPU.
_MAX_BLOCK_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 20}


def _row_dist(is_seed: torch.Tensor) -> torch.Tensor:
    """Per-row distance (in columns) to the nearest seed in the same row.
    (..., H, W) bool → (..., H, W) float32; rows without seeds get _BIG."""
    W = is_seed.shape[-1]
    j = torch.arange(W, dtype=torch.float32,
                     device=is_seed.device).expand(is_seed.shape)
    left = torch.where(is_seed, j, torch.full_like(j, -_BIG)).cummax(-1)[0]
    right = torch.where(is_seed, j, torch.full_like(j, _BIG)).flip(-1) \
        .cummin(-1)[0].flip(-1)
    return torch.minimum(j - left, right - j)


def _edt(is_seed: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance to the nearest seed. (..., H, W) bool →
    float32. The (..., H, H, W) min-plus intermediate is taken over
    _ROW_BLOCK output rows at a time, so peak memory stays at
    (...)·BLOCK·H·W instead of (...)·H²·W."""
    H = is_seed.shape[-2]
    dx = torch.clamp(_row_dist(is_seed), max=_BIG)
    dx2 = dx * dx                                            # (..., H, W)
    ip = torch.arange(H, dtype=torch.float32, device=is_seed.device)
    block = min(_ROW_BLOCK, H)
    rows = []
    for b0 in range(0, H, block):
        i = torch.arange(b0, b0 + block, dtype=torch.float32,
                         device=is_seed.device)[:, None]      # (block, 1)
        di = i - ip
        di2 = di * di                                         # (block, H)
        d2 = (di2[:, :, None] + dx2.unsqueeze(-3)).amin(-2)  # (.., block, W)
        rows.append(d2)
    d2 = torch.cat(rows, dim=-2)[..., :H, :]
    # The f32 root correctly rounded, as XLA's: torch's vectorized f32
    # sqrt on the CPU is 1 ulp off for some inputs; the f64 root of an f32
    # value rounds to the exact f32 root.
    return torch.sqrt(d2.double()).float()


def _sdf_impl(coverage: torch.Tensor, max_dist: float) -> torch.Tensor:
    inside = coverage > 0.5
    d_to_glyph, d_to_bg = _edt(torch.stack([inside, ~inside]))
    sdf = torch.where(inside, -(d_to_bg - 0.5), d_to_glyph - 0.5)
    return torch.clamp(sdf, -max_dist, max_dist)


def signed_distance_field(coverage: torch.Tensor, max_dist: float = 16.0
                          ) -> torch.Tensor:
    """coverage: (H, W) float32 in [0,1] → signed distance (H, W) float32,
    positive outside the glyph, negative inside, clamped to ±max_dist."""
    return _sdf_impl(coverage.float(), max_dist)


def signed_distance_field_batch(coverage: torch.Tensor,
                                max_dist: float = 16.0) -> torch.Tensor:
    """(B, H, W) → (B, H, W): every cell of the batch, as many at a time
    as keep one row block's intermediate under _MAX_BLOCK_ELEMS."""
    B, H, W = coverage.shape
    limit = _MAX_BLOCK_ELEMS["cuda" if coverage.is_cuda else "cpu"]
    chunk = max(1, limit // (2 * min(_ROW_BLOCK, H) * H * W))
    coverage = coverage.float()
    return torch.cat([_sdf_impl(coverage[s:s + chunk], max_dist)
                      for s in range(0, B, chunk)]) if B else \
        torch.empty_like(coverage)


def sdf_to_u8(sdf: torch.Tensor, spread: float = 8.0) -> torch.Tensor:
    """Encode an SDF into the u8 atlas format (128 = edge, like the
    reference's R8_UNORM atlas): value = 128 - sdf * (128/spread)."""
    enc = 128.0 - sdf * (128.0 / spread)
    return torch.clamp(enc, 0.0, 255.0).to(torch.uint8)


def u8_to_sdf(u8: torch.Tensor, spread: float = 8.0) -> torch.Tensor:
    return (128.0 - u8.float()) * (spread / 128.0)
