"""The frame's i16 wire format: how a layer's command tables are quantized
on the host and read back on the device.

Counterpart of the fixed-point spec of `whisper_git_tpu/render/
rasterizer.py` (`_PART_SPECS`, `_part_scale`). A layer's commands are seven
f32 tables, the parts, of three classes: shapes (0), glyphs (1) and images
(2). In a blob the parts lie one after another in `PARTS` order, each
`caps[class]` rows of its columns, every value rounded to the nearest
multiple of 1/scale of its column and clipped to ±32767: geometry at 1/8
px, clip rects at 1/4 px, colours at 1/8192, a quad's atlas cell whole. A
window's uniform row (its scroll offset and viewport clip) rides beside
them at the same scales. Every scale is a power of two, so a value times
the reciprocal of its scale is exact, and the CUDA kernels hold the same
reciprocals (`csrc/raster_steps.cuh`: `SHAPE_INV`, `QUAD_XY_INV`,
`COLOUR_INV`, `CLIP_INV`).

This module is the format's one owner: the packed path, the frame cache and
the compose path quantize (`quantize`, `quantize_uniform`), size (`words`,
`table_offsets`), de-quantize (`dequantize`, `uniform`) and move (`shift`)
tables through it.
"""

from __future__ import annotations

import numpy as np
import torch

from .transfer import upload

# (name, columns) of the seven parts, in blob order, and each part's class.
PARTS = (("shapes", 16), ("shape_clips", 4), ("glyphs", 8),
         ("glyph_colors", 4), ("glyph_clips", 4), ("images", 8),
         ("image_clips", 4))
PART_CLS = (0, 0, 1, 1, 1, 2, 2)
# Each class's parts, by index into the seven, and their columns.
CLS_TABLES = ((0, 1), (2, 3, 4), (5, 6))
TABLE_COLS = tuple(tuple(PARTS[j][1] for j in t) for t in CLS_TABLES)

# Shapes mix geometry and colour columns: per-column scales.
SHAPE_COL_SCALE = np.array(
    [8.0] * 7 + [8192.0] * 4 + [8192.0] * 4 + [8.0], np.float32)
# Glyph and image quads: screen x, y, w, h at 1/8 px; the atlas cell's u,
# v, uw, uh are exact integers (scale 1).
QUAD_COL_SCALE = np.array([8.0] * 4 + [1.0] * 4, np.float32)
_CLIP = np.full((4,), 4.0, np.float32)
# Every part's per-column scale, in `PARTS` order.
SCALES = (SHAPE_COL_SCALE, _CLIP, QUAD_COL_SCALE,
          np.full((4,), 8192.0, np.float32), _CLIP, QUAD_COL_SCALE, _CLIP)
INV_SCALES = tuple(np.float32(1.0) / s for s in SCALES)

# A window's uniform row: dx, dy at 1/8 px, the clip x0, y0, x1, y1 at 1/4
# px, two pad values.
UNIFORM_SCALE = np.array([8.0] * 2 + [4.0] * 4 + [1.0] * 2, np.float32)


def parts(src) -> tuple:
    """The seven tables of a layer's buffers or a window's chunks, in
    `PARTS` order."""
    return tuple(getattr(src, name) for name, _ in PARTS)


def words(caps: tuple) -> int:
    """The i16 values of seven parts of `caps` (shapes, glyphs, images)
    rows."""
    return sum(caps[c] * cols for (_, cols), c in zip(PARTS, PART_CLS))


def table_offsets(at: int, caps: tuple, ci: int) -> tuple:
    """The offsets in a blob of class `ci`'s tables, of seven parts of
    `caps` rows that start at `at`."""
    fo = at + sum(caps[c] * cols
                  for (_, cols), c in zip(PARTS, PART_CLS) if c < ci)
    out = []
    for cols in TABLE_COLS[ci]:
        out.append(fo)
        fo += caps[ci] * cols
    return tuple(out)


def quantize(tables: tuple, used: tuple, caps: tuple) -> np.ndarray:
    """Seven f32 tables → one i16 blob of `caps` rows a class: the first
    `used[class]` rows of each quantized, the rest zero."""
    out = []
    for t, (_, cols), s, c in zip(tables, PARTS, SCALES, PART_CLS):
        q = np.zeros((caps[c], cols), np.int16)
        nu = used[c]
        if nu:
            q[:nu] = np.clip(np.rint(t[:nu] * s), -32767.0, 32767.0)
        out.append(q.ravel())
    return np.concatenate(out)


def quantize_uniform(w) -> np.ndarray:
    """A scroll window's (8,) i16 uniform row (`UNIFORM_SCALE`)."""
    row = np.zeros(8, np.int16)
    row[0] = np.clip(np.rint(w.dx * 8.0), -32767, 32767)
    row[1] = np.clip(np.rint(w.dy * 8.0), -32767, 32767)
    row[2:6] = np.clip(np.rint(np.asarray(w.clip, np.float64) * 4.0),
                       -32767, 32767)
    return row


_INV_DEV: dict = {}   # (caps, device) -> per-element 1/scale of a blob, f32
_UNIFORM_INV: dict = {}   # device -> (8,) f32


def _inverse(caps: tuple, device) -> torch.Tensor:
    key = (caps, str(device))
    inv = _INV_DEV.get(key)
    if inv is None:
        inv = upload(np.concatenate([np.tile(s, caps[c]) for s, c
                                     in zip(INV_SCALES, PART_CLS)]), device)
        if len(_INV_DEV) > 64:
            _INV_DEV.clear()
        _INV_DEV[key] = inv
    return inv


def dequantize(blob: torch.Tensor, caps: tuple) -> tuple:
    """An i16 blob of seven parts of `caps` rows → the seven f32 tables on
    its device: every value times the reciprocal of its column's scale, in
    one multiply over the blob; the tables are views of the product."""
    flat = blob.float() * _inverse(caps, blob.device)
    out = []
    fo = 0
    for (_, cols), c in zip(PARTS, PART_CLS):
        out.append(flat[fo:fo + caps[c] * cols].reshape(caps[c], cols))
        fo += caps[c] * cols
    return tuple(out)


def uniform(row: torch.Tensor) -> torch.Tensor:
    """A window's i16 uniform row(s) (..., 8) → f32 (dx, dy, clip x0, y0,
    x1, y1, pad, pad) on its device, the row `shift` takes."""
    key = str(row.device)
    inv = _UNIFORM_INV.get(key)
    if inv is None:
        inv = _UNIFORM_INV[key] = upload(np.float32(1.0) / UNIFORM_SCALE,
                                         row.device)
    return row.float() * inv


def shift(tables: tuple, u: torch.Tensor) -> tuple:
    """Seven window-relative f32 tables → screen space: moved by the
    uniform row `u` (dx, dy, clip x0, y0, x1, y1, ...; f32 on the tables'
    device) and every clip cut to the window's."""
    shapes, shape_clips, glyphs, glyph_colors, glyph_clips, images, \
        image_clips = tables
    d = u[0:2]
    d4 = d.repeat(2)
    clip_lo, clip_hi = u[2:4], u[4:6]

    def shift_clips(c):
        t = c + d4
        return torch.cat([torch.maximum(t[:, :2], clip_lo),
                          torch.minimum(t[:, 2:], clip_hi)], dim=1)

    def shift_origin(q):
        q = q.clone()
        q[:, 0:2] += d
        return q

    if shapes.shape[0]:
        # A capsule (type 1) moves both end points; a rect only its origin.
        seg = (shapes[:, 0:1] == 1.0).float()
        shapes = shapes.clone()
        shapes[:, 1:3] += d
        shapes[:, 3:5] += seg * d
        shape_clips = shift_clips(shape_clips)
    if glyphs.shape[0]:
        glyphs = shift_origin(glyphs)
        glyph_clips = shift_clips(glyph_clips)
    if images.shape[0]:
        images = shift_origin(images)
        image_clips = shift_clips(image_clips)
    return (shapes, shape_clips, glyphs, glyph_colors, glyph_clips,
            images, image_clips)


def class_parts(ci: int, tables: tuple) -> tuple:
    """Seven tables with class `ci`'s `tables` in their places and no row
    of the others."""
    out = [tables[0].new_empty((0, cols)) for _, cols in PARTS]
    for j, tb in zip(CLS_TABLES[ci], tables):
        out[j] = tb
    return tuple(out)
