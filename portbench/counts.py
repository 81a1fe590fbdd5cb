"""The work a frame's scene asks of the kernels, counted from the scene's
commands (not from any kernel's bins), and the peaks it is held to.

- K1 and K2 rasterize the whole frame: their operations are each
  command's extent pixels inside the frame, counted once, times the
  operations a pixel (50 a shape, 50 a glyph, 65 an image quad); their
  bytes the frame written once as u8 RGBA and every command read once.
- K3 composites the frame from layers: its bytes are each scene layer's
  pixels (the box of its commands' extents inside the frame) read once as
  u8 RGBA, and the frame written once.

The least time of a frame is the larger of operations over the card's
f32 peak outside the tensor cores and bytes over its memory bandwidth
(NVIDIA's H100 SXM data sheet, at its 700 W limit).
"""

from __future__ import annotations

import numpy as np

from .reference import CLASSES, extent_pixels, extents, pixel_spans

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
OPS_PER_PIXEL = {"shapes": 50, "glyphs": 50, "images": 65}
ROW_BYTES = {"shapes": (16 + 4) * 4, "glyphs": (8 + 4 + 4) * 4,
             "images": (8 + 4) * 4}


def frame_counts(layers: list, height: int, width: int) -> dict:
    """{"raster_ops", "raster_bytes", "compose_bytes"} of one frame."""
    frame_bytes = height * width * 4
    ops = 0
    table_bytes = 0
    compose_bytes = frame_bytes
    for layer in layers:
        box_all = None
        for cls in CLASSES:
            n = len(layer[cls])
            if not n:
                continue
            ext = extents(cls, layer)
            ops += int(extent_pixels(ext, height, width).sum()) \
                * OPS_PER_PIXEL[cls]
            table_bytes += n * ROW_BYTES[cls]
            c0, c1, r0, r1 = pixel_spans(ext, height, width)
            ok = (c1 >= c0) & (r1 >= r0)
            if ok.any():
                box = (c0[ok].min(), r0[ok].min(), c1[ok].max(),
                       r1[ok].max())
                b = box_all or box
                box_all = (min(b[0], box[0]), min(b[1], box[1]),
                           max(b[2], box[2]), max(b[3], box[3]))
        if box_all is not None:
            compose_bytes += int((box_all[2] - box_all[0] + 1)
                                 * (box_all[3] - box_all[1] + 1)) * 4
    return {"raster_ops": ops, "raster_bytes": frame_bytes + table_bytes,
            "compose_bytes": compose_bytes}


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S)


def least_by_kernel(c: dict) -> dict:
    """A frame's least time for K1 / K2 (the raster) and K3 (the
    composite)."""
    raster = least_seconds(c["raster_ops"], c["raster_bytes"])
    return {"K1": raster, "K2": raster,
            "K3": least_seconds(0, c["compose_bytes"])}


def sum_least(per_position: list, positions: np.ndarray) -> dict:
    """Σ over the window's frames of each kernel's least time, a frame's
    counts taken at its position in the cycle."""
    table = {k: np.array([least_by_kernel(c)[k] for c in per_position])
             for k in ("K1", "K2", "K3")}
    return {k: float(v[positions].sum()) for k, v in table.items()}
