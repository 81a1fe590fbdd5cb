"""The plain reference that decides `correct`.

It imports nothing of the port and nothing of JAX: plain PyTorch and
NumPy, and the font atlas as the committed `atlas.npz` holds it (a raw
file the port reads too). It judges a sampled frame of the window in two
stages.

1. The scene (app build, layout, scene compile, HiDPI scaling). The
   program's compiled scene is decoded back into text rows through the
   atlas: every subject starts with the tag `WG-<mark>:`, so a row names
   its commit. The reference knows the history (`repo.py`), works out the
   row heights itself (time-spaced rows: 28 px, plus up to 28 px growing
   with the log of the gap to the newer commit, from 2 h to 30 days) and
   the scroll offset after each input event (`events.replay_offsets`).
   Each row is held, in logical px, to the configuration's `pane`: its
   text at `text_y_px` below where the model puts the row's top (the
   pane's top and the text's place in its row), its tag at `subject_x_px`
   (right of it by `pill_min_px` or more where a branch or tag pill comes
   first). `row_err_px` is the widest departure. `text_err_rows` counts
   the rows whose text is not the start of their commit's subject, whose
   colour is not `subject_rgba`, or that lack their avatar quad of
   `avatar_px` square. A sample whose rows are not consecutive commits,
   or too few, reads `MISSING_ROWS_PX` and `min_rows`.
2. The raster. The reference rasterizes the program's scene again, with
   the windows spliced in at their place, binned by its own command
   extents onto 64x128 tiles and composited command by command (per layer:
   shapes, image quads, glyph quads), with its own font texture and an
   image atlas it fills with the seed's avatars at the cells the scene's
   image quads name, each for the author of the row it lies in. The
   arithmetic follows the kernels' stated precision: float32, with the
   glyph resampling's taps and texels rounded to bfloat16 and summed in
   float32. `frame_gap_u8` is the largest difference of any channel of any
   pixel between the program's frame and the reference's.

`raster(..., dtype=torch.bfloat16)` is the control: the same reference
computed one precision lower (`tests/test_portbench_control.py`).
"""

from __future__ import annotations

import math
import os
import re
from typing import NamedTuple

import numpy as np
import torch

TILE_H, TILE_W = 64, 128
CELL = 64
SDF_SPREAD = 8.0
EXTENT_PAD = 1.0
ROW_HEIGHT = 28.0
GAP_BASE_S = 2 * 3600
GAP_SATURATION_S = 30 * 86400
MISSING_ROWS_PX = 1000.0
ATLAS_NPZ = os.path.join("whisper_git_tpu_torch", "data", "atlas.npz")


# -- the scene, spliced ----------------------------------------------------

CLASSES = ("shapes", "images", "glyphs")
# The port's wire format for frames up to 4095 px: command geometry in
# 1/8 px, clip rects in 1/4 px, colours in 1/8192, as i16; atlas
# coordinates whole. A window's commands are quantized relative to the
# window, its offset in 1/8 px and its clip in 1/4 px.
MAX_PACKED_PX = 4095
_SHAPE_SCALE = np.array([8.0] * 7 + [8192.0] * 8 + [8.0], np.float32)
_QUAD_SCALE = np.array([8.0] * 4 + [1.0] * 4, np.float32)
_SCALES = {"shapes": _SHAPE_SCALE, "glyphs": _QUAD_SCALE,
           "images": _QUAD_SCALE, "glyph_colors": np.float32(8192.0),
           "shape_clips": np.float32(4.0), "glyph_clips": np.float32(4.0),
           "image_clips": np.float32(4.0)}


def _q(a: np.ndarray, scale) -> np.ndarray:
    q = np.clip(np.rint(a * scale), -32767.0, 32767.0).astype(np.int16)
    return q.astype(np.float32) * (np.float32(1.0) / scale)


def quantize(part: dict) -> dict:
    """A command table as the wire format carries it."""
    out = dict(part)
    for k, sc in _SCALES.items():
        out[k] = _q(np.asarray(part[k], np.float32), sc)
    if part.get("dyn") is not None:
        out["dyn"] = quantize(part["dyn"])
    return out


def _shift(part: dict, dx: float, dy: float, clip) -> dict:
    """A window's commands moved by (dx, dy), their clips moved and cut by
    the window's clip."""
    out = {}
    c4 = np.asarray([dx, dy, dx, dy], np.float32)

    def clips(rel):
        r = rel + c4
        np.maximum(r[:, :2], clip[:2], out=r[:, :2])
        np.minimum(r[:, 2:], clip[2:], out=r[:, 2:])
        return r

    s = part["shapes"].copy()
    s[:, 1] += dx
    s[:, 2] += dy
    seg = s[:, 0] == 1.0
    s[seg, 3] += dx
    s[seg, 4] += dy
    out["shapes"], out["shape_clips"] = s, clips(part["shape_clips"])
    g = part["glyphs"].copy()
    g[:, 0] += dx
    g[:, 1] += dy
    out["glyphs"], out["glyph_clips"] = g, clips(part["glyph_clips"])
    out["glyph_colors"] = part["glyph_colors"]
    im = part["images"].copy()
    im[:, 0] += dx
    im[:, 1] += dy
    out["images"], out["image_clips"] = im, clips(part["image_clips"])
    return out


_KEYS = {"shapes": ("shapes", "shape_clips"),
         "glyphs": ("glyphs", "glyph_colors", "glyph_clips"),
         "images": ("images", "image_clips")}
_POS = {"shapes": 0, "glyphs": 1, "images": 2}


def splice(flat: dict) -> list:
    """The scene's layers with every window spliced in at its stream
    position: static commands in order, each window's volatile commands
    after the layer's own; in the wire format's precision where the frame
    fits it. → a list of {array name: array}."""
    packed = max(flat["width"], flat["height"]) <= MAX_PACKED_PX
    layers = []
    for li, lb in enumerate(flat["layers"]):
        if packed:
            lb = quantize(lb)
        wins = [w for w in flat["windows"] if w["layer"] == li]
        pieces, tail = [], []
        cursor = (0, 0, 0)
        for w in wins:
            comp, dx, dy, clip = w["comp"], w["dx"], w["dy"], w["clip"]
            if packed:
                comp = quantize(comp)
                dx, dy = (float(_q(np.float32(v), np.float32(8.0)))
                          for v in (dx, dy))
                clip = tuple(_q(np.asarray(clip, np.float32),
                                np.float32(4.0)))
            pieces.append(_slice(lb, cursor, w["pos"]))
            pieces.append(_shift(comp, dx, dy, clip))
            if comp.get("dyn") is not None:
                tail.append(_shift(comp["dyn"], dx, dy, clip))
            cursor = w["pos"]
        pieces.append(_slice(lb, cursor, (lb["n_shapes"], lb["n_glyphs"],
                                          lb["n_images"])))
        pieces += tail
        layers.append({k: np.concatenate([p[k] for p in pieces], axis=0)
                       for names in _KEYS.values() for k in names})
    return layers


def _slice(lb: dict, a: tuple, b: tuple) -> dict:
    out = {}
    for cls, names in _KEYS.items():
        i = _POS[cls]
        for k in names:
            out[k] = lb[k][a[i]:b[i]]
    return out


# -- extents and bins --------------------------------------------------------


def extents(cls: str, layer: dict) -> np.ndarray:
    """(N, 4) f32 pixel-centre rectangle (x0, y0, x1, y1), bounds
    inclusive, outside which a command's coverage is exactly 0: a shape's
    box grown by 0.5 px (a capsule's by its half width too); a quad's by
    one texel (w / uw px), a glyph's only where its SDF reaches 0 coverage
    there; each grown by one pixel more against rounding and cut by the
    command's clip."""
    if cls == "shapes":
        t, clip = layer["shapes"], layer["shape_clips"]
        seg = t[:, 0] == 1.0
        g = np.where(seg, np.maximum(t[:, 5], 0.0), 0.0) + (0.5 + EXTENT_PAD)
        far_x = np.where(seg, t[:, 3], t[:, 1] + t[:, 3])
        far_y = np.where(seg, t[:, 4], t[:, 2] + t[:, 4])
        x0 = np.minimum(t[:, 1], far_x) - g
        x1 = np.maximum(t[:, 1], far_x) + g
        y0 = np.minimum(t[:, 2], far_y) - g
        y1 = np.maximum(t[:, 2], far_y) + g
    else:
        t = layer[cls]
        clip = layer["glyph_clips" if cls == "glyphs" else "image_clips"]
        w = np.maximum(t[:, 2], 1e-6)
        h = np.maximum(t[:, 3], 1e-6)
        with np.errstate(divide="ignore", invalid="ignore"):
            gx = np.where(t[:, 6] > 0, w / t[:, 6] + EXTENT_PAD, np.inf)
            gy = np.where(t[:, 7] > 0, h / t[:, 7] + EXTENT_PAD, np.inf)
        if cls == "glyphs":
            d = SDF_SPREAD * (t[:, 2] / np.maximum(t[:, 6], 1e-6))
            bounded = d / 0.7 >= 0.5
            gx = np.where(bounded, gx, np.inf)
            gy = np.where(bounded, gy, np.inf)
        x0, x1 = t[:, 0] - gx, t[:, 0] + w + gx
        y0, y1 = t[:, 1] - gy, t[:, 1] + h + gy
    return np.stack([np.maximum(x0, clip[:, 0]), np.maximum(y0, clip[:, 1]),
                     np.minimum(x1, clip[:, 2]), np.minimum(y1, clip[:, 3])],
                    axis=1).astype(np.float64)


def pixel_spans(ext: np.ndarray, height: int, width: int) -> tuple:
    """The first and last pixel column and row whose centre lies inside
    each extent, cut to the frame → (c0, c1, r0, r1) i64; empty where
    c1 < c0 or r1 < r0."""
    with np.errstate(invalid="ignore"):
        c0 = np.maximum(np.ceil(ext[:, 0] - 0.5), 0)
        c1 = np.minimum(np.floor(ext[:, 2] - 0.5), width - 1)
        r0 = np.maximum(np.ceil(ext[:, 1] - 0.5), 0)
        r1 = np.minimum(np.floor(ext[:, 3] - 0.5), height - 1)
    bad = ~(np.isfinite(c0) & np.isfinite(c1) & np.isfinite(r0)
            & np.isfinite(r1))
    c0, c1, r0, r1 = (np.where(bad, 0, v).astype(np.int64)
                      for v in (c0, c1, r0, r1))
    c1 = np.where(bad, -1, c1)
    return c0, c1, r0, r1


def extent_pixels(ext: np.ndarray, height: int, width: int) -> np.ndarray:
    c0, c1, r0, r1 = pixel_spans(ext, height, width)
    return np.maximum(c1 - c0 + 1, 0) * np.maximum(r1 - r0 + 1, 0)


def bins(ext: np.ndarray, height: int, width: int) -> np.ndarray:
    """(tiles, K) i64: each tile's commands in order, -1 past the last."""
    ty_n, tx_n = -(-height // TILE_H), -(-width // TILE_W)
    c0, c1, r0, r1 = pixel_spans(ext, height, width)
    ok = (c1 >= c0) & (r1 >= r0)
    tx0, tx1 = c0 // TILE_W, c1 // TILE_W
    ty0, ty1 = r0 // TILE_H, r1 // TILE_H
    nx = np.where(ok, tx1 - tx0 + 1, 0)
    ny = np.where(ok, ty1 - ty0 + 1, 0)
    cnt = nx * ny
    total = int(cnt.sum())
    out_rows = ty_n * tx_n
    if total == 0:
        return np.full((out_rows, 0), -1, np.int64)
    cmd = np.repeat(np.arange(len(ext)), cnt)
    k = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    tx = tx0[cmd] + k % nx[cmd]
    ty = ty0[cmd] + k // nx[cmd]
    tile = ty * tx_n + tx
    order = np.lexsort((cmd, tile))
    tile, cmd = tile[order], cmd[order]
    first = np.searchsorted(tile, tile, side="left")
    rank = np.arange(total) - first
    out = np.full((out_rows, int(rank.max()) + 1), -1, np.int64)
    out[tile, rank] = cmd
    return out


# -- the raster ----------------------------------------------------------------


def _over(fb, rgb, a):
    a = a[:, None]
    return torch.cat([rgb * a + fb[:, :3] * (1.0 - a),
                      a + fb[:, 3:] * (1.0 - a)], dim=1)


def _clip_mask(px, py, clip):
    c = clip[:, :, None, None]
    return ((px >= c[:, 0]) & (py >= c[:, 1]) & (px <= c[:, 2])
            & (py <= c[:, 3])).to(px.dtype)


def _shape(fb, px, py, c, clips):
    clip = _clip_mask(px, py, clips)
    c = c[:, :, None, None]
    is_seg = c[:, 0] == 1.0
    hx, hy = c[:, 3] * 0.5, c[:, 4] * 0.5
    cx, cy = c[:, 1] + hx, c[:, 2] + hy
    r = torch.minimum(c[:, 5], torch.minimum(hx, hy))
    qx = torch.abs(px - cx) - (hx - r)
    qy = torch.abs(py - cy) - (hy - r)
    mx, my = torch.clamp(qx, min=0.0), torch.clamp(qy, min=0.0)
    d_rect = (torch.sqrt(mx * mx + my * my)
              + torch.clamp(torch.maximum(qx, qy), max=0.0) - r)
    ax, ay, bx, by = c[:, 1], c[:, 2], c[:, 3], c[:, 4]
    abx, aby = bx - ax, by - ay
    denom = torch.clamp(abx * abx + aby * aby, min=1e-6)
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
    ex, ey = px - (ax + t * abx), py - (ay + t * aby)
    d_seg = torch.sqrt(ex * ex + ey * ey) - c[:, 5]
    d = torch.where(is_seg, d_seg, d_rect)
    fb = _over(fb, c[:, 7:10], torch.clamp(0.5 - d, 0.0, 1.0) * clip
               * c[:, 10])
    has_border = ((~is_seg) & (c[:, 6] > 0.0)).to(px.dtype)
    cov_b = (torch.clamp(0.5 - d, 0.0, 1.0)
             * torch.clamp(d + c[:, 6] + 0.5, 0.0, 1.0) * clip * has_border)
    return _over(fb, c[:, 11:14], cov_b * c[:, 14])


def _weights(pix, origin, extent, atlas_extent):
    origin, extent, atlas_extent = (v[:, None] for v in
                                    (origin, extent, atlas_extent))
    s = (pix - origin) / torch.clamp(extent, min=1e-6) * atlas_extent - 0.5
    j = torch.arange(CELL, dtype=pix.dtype, device=pix.device)
    w = torch.clamp(1.0 - torch.abs(s[..., None] - j), 0.0, 1.0)
    inside = ((s > -1.0) & (s < atlas_extent)).to(pix.dtype)
    return w * inside[..., None]


def _cells(tex, u, v):
    v0 = torch.clamp(v.int(), 0, tex.shape[0] - CELL).long()
    u0 = torch.clamp(u.int(), 0, tex.shape[1] - CELL).long()
    j = torch.arange(CELL, device=tex.device)
    return tex[(v0[:, None] + j)[:, :, None], (u0[:, None] + j)[:, None, :]]


def _glyph(fb, px1, py1, g, colors, clips, ftex, px, py, taps):
    clip = _clip_mask(px, py, clips)
    x, y, w, h, u, v, uw, uh = g.unbind(1)
    patch = _cells(ftex, u, v)
    wy = _weights(py1, y, h, uh)
    wx = _weights(px1, x, w, uw)
    enc = torch.bmm(torch.bmm(taps(wy), taps(patch)),
                    taps(wx).transpose(1, 2))
    d = (128.0 - enc) * (SDF_SPREAD / 128.0) \
        * (w / torch.clamp(uw, min=1e-6))[:, None, None]
    cov = torch.clamp(0.5 - d / 0.7, 0.0, 1.0) * clip
    return _over(fb, colors[:, :3, None, None],
                 cov * colors[:, 3, None, None])


def _image(fb, px1, py1, q, clips, atlas, px, py):
    clip = _clip_mask(px, py, clips)
    x, y, w, h, u, v, uw, uh = q.unbind(1)
    patch = _cells(atlas, u, v)
    wy = _weights(py1, y, h, uh)
    wx = _weights(px1, x, w, uw)
    rgba = torch.einsum("apj,ajkc,aqk->acpq", wy, patch, wx) / 255.0
    return _over(fb, rgba[:, :3], rgba[:, 3] * clip)


def raster(layers: list, height: int, width: int, background,
           font_tex: np.ndarray, image_atlas: np.ndarray, device,
           dtype=torch.float32) -> torch.Tensor:
    """The spliced layers → (H, W, 4) u8 on `device`, every command
    composited in order over the tiles its extent touches."""
    ty_n, tx_n = -(-height // TILE_H), -(-width // TILE_W)
    T = ty_n * tx_n
    tile = torch.arange(T, device=device)
    org_x = (tile % tx_n).to(torch.float64) * TILE_W
    org_y = (tile // tx_n).to(torch.float64) * TILE_H
    px1 = (torch.arange(TILE_W, device=device, dtype=torch.float64)
           + org_x[:, None] + 0.5).to(dtype)
    py1 = (torch.arange(TILE_H, device=device, dtype=torch.float64)
           + org_y[:, None] + 0.5).to(dtype)
    fb = torch.empty((T, 4, TILE_H, TILE_W), dtype=dtype, device=device)
    for ch in range(3):
        fb[:, ch] = float(background[ch])
    fb[:, 3] = 1.0
    ftex = torch.from_numpy(np.ascontiguousarray(font_tex)).to(device) \
        .to(dtype)
    atlas = torch.from_numpy(np.ascontiguousarray(image_atlas)).to(device) \
        .to(dtype)
    if dtype == torch.float32:
        def taps(x):
            return x.to(torch.bfloat16).to(torch.float32)
    else:
        def taps(x):
            return x

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
            .to(device).to(dtype)

    for layer in layers:
        for cls in CLASSES:
            if not len(layer[cls]):
                continue
            b = torch.from_numpy(bins(extents(cls, layer), height,
                                      width)).to(device)
            tabs = [dev(layer[k]) for k in _KEYS[cls]]
            for k in range(b.shape[1]):
                idx = b[:, k]
                act = torch.nonzero(idx >= 0).squeeze(1)
                if act.numel() == 0:
                    continue
                i = idx[act]
                a1, b1 = px1[act], py1[act]
                px, py = a1[:, None, :], b1[:, :, None]
                if cls == "shapes":
                    out = _shape(fb[act], px, py, tabs[0][i], tabs[1][i])
                elif cls == "glyphs":
                    out = _glyph(fb[act], a1, b1, tabs[0][i], tabs[1][i],
                                 tabs[2][i], ftex, px, py, taps)
                else:
                    out = _image(fb[act], a1, b1, tabs[0][i], tabs[1][i],
                                 atlas, px, py)
                fb[act] = out
    img = fb.reshape(ty_n, tx_n, 4, TILE_H, TILE_W).permute(0, 3, 1, 4, 2)
    img = img.reshape(ty_n * TILE_H, tx_n * TILE_W, 4)[:height, :width]
    return torch.clamp(img.float() * 255.0 + 0.5, 0.0, 255.0) \
        .to(torch.uint8)


# -- the font, the text and the rows ------------------------------------------


def font_atlas(root: str = ".") -> tuple:
    """(font texture: regular rows then bold rows, {(u, v): char}) from
    the committed atlas file."""
    with np.load(os.path.join(root, ATLAS_NPZ), allow_pickle=False) as z:
        chars = [str(c) for c in z["chars"]]
        reg, bold = z["regular_texture"], z["bold_texture"]
        w = max(reg.shape[1], bold.shape[1])
        pad = [np.pad(t, ((0, 0), (0, w - t.shape[1]))) for t in (reg, bold)]
        tex = np.concatenate(pad, axis=0).astype(np.uint8)
        lut = {}
        for face, v_off in (("regular", 0), ("bold", reg.shape[0])):
            for c, m in zip(chars, z[f"{face}_meta"]):
                lut[(int(m[0]), int(m[1]) + v_off)] = c
    return tex, lut


def text_lines(layer: dict, lut: dict) -> list:
    """The glyph quads read back as text lines: [(y, height, text, x,
    rgba)], one per quad top and clip rect (a run's quads share both; two
    panes' runs at one height do not), characters by x; `x` is the first
    quad's left and `rgba` its colour."""
    g = layer["glyphs"]
    if not len(g):
        return []
    keys = np.concatenate([np.round(g[:, 1:2].astype(np.float64), 3),
                           layer["glyph_clips"].astype(np.float64)], axis=1)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    lines = []
    for k in range(len(uniq)):
        sel = np.nonzero(inverse.ravel() == k)[0]
        sel = sel[np.argsort(g[sel, 0], kind="stable")]
        text = "".join(lut.get((int(g[j, 4]), int(g[j, 5])), "?")
                       for j in sel)
        lines.append((float(uniq[k, 0]), float(g[sel[0], 3]), text,
                      float(g[sel[0], 0]),
                      tuple(float(c) for c in layer["glyph_colors"][sel[0]])))
    lines.sort(key=lambda t: t[0])
    return lines


def row_heights(timestamps: list) -> list:
    """Time-spaced row heights: 28 px, plus up to 28 px growing with the
    log of the gap to the newer row from 2 h to 30 days, rounded."""
    out = [ROW_HEIGHT]
    span = math.log(GAP_SATURATION_S) - math.log(GAP_BASE_S)
    for i in range(1, len(timestamps)):
        delta = max(0, timestamps[i - 1] - timestamps[i])
        extra = 0.0
        if delta > GAP_BASE_S:
            frac = (math.log(min(delta, GAP_SATURATION_S))
                    - math.log(GAP_BASE_S)) / span
            extra = frac * ROW_HEIGHT
        out.append(float(round(ROW_HEIGHT + extra)))
    return out


class History:
    """What the reference knows of the history view: the rows in display
    order (an "Uncommitted changes" row first, for the untracked file, as
    new as the run), their tops and heights, each commit's author and
    subject, and which rows carry a pill (the main branch's head, each
    feature branch's head, each tagged commit)."""

    def __init__(self, order: list, now: int, tagged=()):
        self.marks = [None] + [c["mark"] for c in order]
        self.authors = [None] + [c["author"] for c in order]
        self.subjects = [None] + [c["subject"] for c in order]
        pills = {c["mark"] for c in order if c["ref"] != "main"} \
            | set(tagged) | ({order[0]["mark"]} if order else set())
        self.pill = [False] + [c["mark"] in pills for c in order]
        self.heights = row_heights([now] + [c["time"] for c in order])
        self.tops = np.concatenate(([0.0], np.cumsum(self.heights[:-1])))
        self.index = {m: i for i, m in enumerate(self.marks) if m}
        self.total = float(self.tops[-1] + self.heights[-1])

    def model_y(self, i: int, offset: float) -> float:
        """Where row i's text sits below the pane's text line: its top
        less the scroll offset, plus half of what it has over 28 px."""
        return float(self.tops[i]) - offset \
            + (self.heights[i] - ROW_HEIGHT) * 0.5


_TAG = re.compile(r"WG-(\d+):")


class Row(NamedTuple):
    """A history row as the scene draws it, in logical px."""
    index: int
    y: float
    h: float
    x: float
    text: str
    rgba: tuple


def find_rows(layers: list, lut: dict, hist: History, scale: float,
              min_x: float) -> list:
    """[Row] for every line right of `min_x` (logical px: the history
    pane's subject column, not a panel's copy of a subject) that starts
    with a commit's tag, top to bottom."""
    rows = []
    for layer in layers:
        for y, h, text, x, rgba in text_lines(layer, lut):
            m = _TAG.match(text)
            if m and int(m.group(1)) in hist.index and x / scale >= min_x:
                rows.append(Row(hist.index[int(m.group(1))], y / scale,
                                h / scale, x / scale, text, rgba))
    rows.sort(key=lambda r: r.y)
    return rows


def _avatar_quads(layers: list, scale: float) -> np.ndarray:
    """(N, 3) logical px: each image quad's centre y, width and height."""
    qs = [q for layer in layers for q in layer["images"]]
    if not qs:
        return np.zeros((0, 3))
    q = np.asarray(qs, np.float64)
    return np.stack([(q[:, 1] + q[:, 3] * 0.5) / scale, q[:, 2] / scale,
                     q[:, 3] / scale], axis=1)


def scene_errors(rows: list, layers: list, hist: History, offset: float,
                 pane: dict, min_rows: int, scale: float):
    """→ (row_err_px, text_err_rows) of one sample, or None where the rows
    are too few or not consecutive commits."""
    if len(rows) < min_rows:
        return None
    idx = [r.index for r in rows]
    if idx != list(range(idx[0], idx[0] + len(idx))):
        return None
    quads = _avatar_quads(layers, scale)
    want = np.asarray(pane["subject_rgba"], np.float64)
    x0, size = float(pane["subject_x_px"]), float(pane["avatar_px"])
    err, bad = 0.0, 0
    for r in rows:
        dy = abs(r.y - hist.model_y(r.index, offset) - pane["text_y_px"])
        if hist.pill[r.index]:
            dx = max(0.0, x0 + float(pane["pill_min_px"]) - r.x)
        else:
            dx = abs(r.x - x0)
        err = max(err, dy, dx)
        shown = r.text[:-1] if r.text.endswith("\u2026") else r.text
        subject = hist.subjects[r.index].replace(" ", "")
        tag = len(_TAG.match(subject).group(0))
        text_ok = len(shown) > tag and subject.startswith(shown)
        colour_ok = float(np.abs(np.asarray(r.rgba) - want).max()) \
            <= 1.0 / 4096.0
        centre = r.y + r.h * 0.5
        near = quads[np.abs(quads[:, 0] - centre) <= ROW_HEIGHT * 0.5] \
            if len(quads) else quads
        avatar_ok = len(near) == 1 and bool(
            np.all(np.abs(near[0, 1:] - size) <= 0.05))
        bad += not (text_ok and colour_ok and avatar_ok)
    return err, bad


def expected_atlas(layers: list, rows: list, hist: History, avatars: list,
                   scale: float, shape=(512, 512, 4)) -> np.ndarray:
    """The image atlas the scene's quads should sample: at each quad's
    cell, the avatar of the author of the row whose text line its centre
    lies nearest to (within half a row)."""
    atlas = np.zeros(shape, np.uint8)
    centres = [(r.y + r.h * 0.5, r.index) for r in rows]
    for layer in layers:
        for q in layer["images"]:
            cy = (float(q[1]) + float(q[3]) * 0.5) / scale
            best = min(centres, key=lambda c: abs(c[0] - cy), default=None)
            if best is None or abs(best[0] - cy) > ROW_HEIGHT * 0.5:
                continue
            author = hist.authors[best[1]]
            if author is None:
                continue
            u, v = int(q[4]), int(q[5])
            atlas[v:v + CELL, u:u + CELL] = avatars[author]
    return atlas
