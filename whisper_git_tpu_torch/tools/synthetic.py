"""Seeded synthetic scenes for holding the tile kernel against its plain
version (and the port against the reference) command class by class.

Every scene is made from `numpy.random.default_rng(seed)` with values that
survive the packed path's i16 quantization. Glyph quads sample real cells
of the given font atlas; image quads sample a random RGBA image atlas.

Kinds:
  shapes  rounded rects (some with borders) and capsules on two layers
  glyphs  shapes under glyph quads of the regular and bold faces
  images  shapes under image quads, some upsampled, some clipped
  empty   no layers at all: background only
  ragged  shapes and glyphs on a frame whose edges cut tiles
  window  chrome around a scroll window placed at a fractional dy
  volatile  the window scene with a volatile tail on its layer (shapes and
          glyphs) and a second layer that is nothing but a volatile shape
  windows2  two scroll windows on one layer, spliced a third and two
          thirds into its chrome stream, so that the frame cache cuts each
          chrome table into three z-segments; a volatile tail on top

`synthetic_compose` makes seeded op lists for the compose kernel instead:
random premultiplied layers, slabs, an inline shape tail and a pre-rendered
tail, in the layouts `render/compose_kernel.py` documents; the slab starts
and the inline tails lie in an i16 frame blob, packed as the compose path
packs them.
"""

from __future__ import annotations

import numpy as np

from ..render.scene import (_NOCLIP, LayerBuffers, Scene, SubtreeChunks,
                            WindowPart, _bucket)

KINDS = ("shapes", "glyphs", "images", "empty", "ragged", "window",
         "volatile", "windows2")
BACKGROUND = (0.086, 0.098, 0.122, 1.0)
IMG_GRID = 8
CELL = 64


def _clips(rng, n: int, w: int, h: int) -> np.ndarray:
    """Half the commands unclipped, half clipped to a random rect."""
    c = np.tile(np.asarray(_NOCLIP, np.float32), (n, 1))
    some = rng.random(n) < 0.5
    x0 = rng.uniform(-10, w * 0.6, n)
    y0 = rng.uniform(-10, h * 0.6, n)
    c[some] = np.stack([x0, y0, x0 + rng.uniform(20, w, n),
                        y0 + rng.uniform(20, h, n)], 1)[some]
    return np.round(c * 4.0) / 4.0


def _shapes(rng, n: int, w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    s = np.zeros((n, 16), np.float32)
    seg = rng.random(n) < 0.3
    s[:, 0] = seg
    s[:, 1] = rng.uniform(-20, w, n)
    s[:, 2] = rng.uniform(-20, h, n)
    s[:, 3] = np.where(seg, rng.uniform(-20, w, n), rng.uniform(1, 260, n))
    s[:, 4] = np.where(seg, rng.uniform(-20, h, n), rng.uniform(1, 160, n))
    s[:, 5] = np.where(seg, rng.uniform(0.5, 3.0, n), rng.uniform(0, 20, n))
    s[:, 6] = np.where(~seg & (rng.random(n) < 0.4),
                       rng.choice([1.0, 1.5, 2.0], n), 0.0)
    s[:, 7:11] = rng.uniform(0, 1, (n, 4))
    s[:, 11:15] = rng.uniform(0, 1, (n, 4))
    s[:, 1:7] = np.round(s[:, 1:7] * 8.0) / 8.0
    return s, _clips(rng, n, w, h)


def _glyph_quads(rng, n: int, w: int, h: int, regular, bold_v_offset: int
                 ) -> np.ndarray:
    chars = [c for c in regular.glyphs if not c.isspace()]
    q = np.zeros((n, 8), np.float32)
    bold = rng.random(n) < 0.3
    for i in range(n):
        g = regular.glyphs[chars[rng.integers(len(chars))]]
        s = rng.uniform(0.2, 0.8)
        q[i] = (rng.uniform(-10, w), rng.uniform(-10, h),
                g.w * s, regular.band_h * s, g.u,
                g.v + (bold_v_offset if bold[i] else 0), g.w,
                regular.band_h)
    q[:, :4] = np.round(q[:, :4] * 8.0) / 8.0
    return q


def _image_quads(rng, n: int, w: int, h: int) -> np.ndarray:
    q = np.zeros((n, 8), np.float32)
    q[:, 0] = rng.uniform(-10, w, n)
    q[:, 1] = rng.uniform(-10, h, n)
    q[:, 2] = rng.uniform(10, 150, n)
    q[:, 3] = rng.uniform(10, 150, n)
    q[:, 4] = rng.integers(0, IMG_GRID, n) * CELL
    q[:, 5] = rng.integers(0, IMG_GRID, n) * CELL
    q[:, 6:8] = CELL
    q[:, :4] = np.round(q[:, :4] * 8.0) / 8.0
    return q


def _layer(rng, w: int, h: int, n_s: int, n_g: int = 0, n_i: int = 0,
           regular=None, bold_v_offset: int = 0) -> LayerBuffers:
    def padded(rows: np.ndarray, cols: int, fill=0.0) -> np.ndarray:
        out = np.full((_bucket(rows.shape[0]), cols), fill, np.float32)
        out[:rows.shape[0]] = rows
        return out

    shapes, sclips = _shapes(rng, n_s, w, h)
    glyphs = (_glyph_quads(rng, n_g, w, h, regular, bold_v_offset) if n_g
              else np.zeros((0, 8), np.float32))
    gcol = rng.uniform(0.3, 1.0, (n_g, 4)).astype(np.float32)
    images = _image_quads(rng, n_i, w, h)
    return LayerBuffers(
        padded(shapes, 16), padded(sclips, 4, 0.0), n_s,
        padded(glyphs, 8), padded(gcol, 4), padded(_clips(rng, n_g, w, h), 4),
        n_g, padded(images, 8), padded(_clips(rng, n_i, w, h), 4), n_i)


def _window(rng, regular, bold_v_offset: int, w: int, h: int,
            x0: float = 40.0, dy: float = 30.0 - 37.375, rows: int = 24
            ) -> tuple[SubtreeChunks, tuple, float, float]:
    """Rows of a scroll window in window-relative coordinates, its clip,
    and its (dx, dy) with a fractional dy."""
    sh = np.zeros((rows, 16), np.float32)
    sh[:, 1] = 0.0
    sh[:, 2] = np.arange(rows) * 28.0
    sh[:, 3] = w * 0.6
    sh[:, 4] = 28.0
    sh[:, 7:11] = rng.uniform(0, 1, (rows, 4))
    n_g = 6 * rows
    glyphs = _glyph_quads(rng, n_g, int(w * 0.55), 28, regular,
                          bold_v_offset)
    glyphs[:, 1] += np.repeat(np.arange(rows) * 28.0, 6)
    n_i = rows // 2
    images = _image_quads(rng, n_i, int(w * 0.5), 28)
    images[:, 1] = np.arange(n_i) * 56.0 + 2.0
    images[:, 2:4] = 24.0
    noclip = np.asarray(_NOCLIP, np.float32)
    comp = SubtreeChunks(
        shapes=sh, shape_clips=np.tile(noclip, (rows, 1)),
        glyphs=glyphs,
        glyph_colors=rng.uniform(0.3, 1, (n_g, 4)).astype(np.float32),
        glyph_clips=np.tile(noclip, (n_g, 1)),
        images=images, image_clips=np.tile(noclip, (n_i, 1)))
    clip = (x0, 30.0, x0 + w * 0.6, h - 20.0)
    return comp, clip, x0, dy


def synthetic_scene(kind: str, seed: int, regular, bold_v_offset: int,
                    width: int = 640, height: int = 384) -> Scene:
    """A seeded scene of the given kind (see the module docstring).
    `regular` is the font atlas whose cells glyph quads sample;
    `bold_v_offset` is the bold face's row offset in the font texture."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    rng = np.random.default_rng(seed)
    image_atlas = rng.integers(0, 256, (IMG_GRID * CELL, IMG_GRID * CELL, 4),
                               dtype=np.uint8)
    w, h = width, height
    windows = []
    if kind == "empty":
        layers = []
    elif kind == "shapes":
        layers = [_layer(rng, w, h, 120), _layer(rng, w, h, 40)]
    elif kind == "glyphs":
        layers = [_layer(rng, w, h, 40, 300, 0, regular, bold_v_offset),
                  _layer(rng, w, h, 10, 80, 0, regular, bold_v_offset)]
    elif kind == "images":
        layers = [_layer(rng, w, h, 30, 0, 24)]
    elif kind == "ragged":
        w, h = width - 307, height - 187
        layers = [_layer(rng, w, h, 60, 120, 0, regular, bold_v_offset)]
    else:
        layers = [_layer(rng, w, h, 20, 40, 0, regular, bold_v_offset)]
        lb = layers[0]
        if kind != "window":
            # The last rows of the used prefix are the volatile tail.
            lb.n_dyn_shapes, lb.n_dyn_glyphs = 3, 5
        # Window k of n is spliced k/(n+1) into the static chrome stream.
        placed = ([(40.0, 30.0 - 37.375, 24)] if kind != "windows2" else
                  [(40.0, 30.0 - 37.375, 24), (150.0, 30.0 - 100.25, 16)])
        for wi, (x0, dy0, rows) in enumerate(placed):
            comp, clip, dx, dy = _window(rng, regular, bold_v_offset, w, h,
                                         x0, dy0, rows)
            frac = (wi + 1) / (len(placed) + 1)
            windows.append(WindowPart(
                comp=comp, layer=0, dx=dx, dy=dy, clip=clip,
                pos=(int((lb.n_shapes - lb.n_dyn_shapes) * frac),
                     int((lb.n_glyphs - lb.n_dyn_glyphs) * frac), 0)))
        if kind == "volatile":
            thumb = _layer(rng, w, h, 2)
            thumb.n_dyn_shapes = 2
            layers.append(thumb)
    return Scene(layers=layers, width=w, height=h, background=BACKGROUND,
                 image_atlas=image_atlas, windows=windows)


# ---------------------------------------------------------------------------
# Op lists for the compose kernel.
# ---------------------------------------------------------------------------

COMPOSE_CASES = ("layers", "tails", "empty", "windowless")


def _premultiplied(rng, h: int, w: int, cover: float) -> np.ndarray:
    """A random premultiplied RGBA layer (h, w, 4) f32 in [0, 1], rgb ≤ a,
    transparent outside a share `cover` of 8×8 px cells."""
    cells = rng.random((-(-h // 8), -(-w // 8))) < cover
    mask = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)[:h, :w]
    a = rng.uniform(0.0, 1.0, (h, w)).astype(np.float32) * mask
    rgb = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32) * a[..., None]
    return np.concatenate([rgb, a[..., None]], axis=2)


def _i16_layer(rng, h: int, w: int, cover: float = 0.6) -> np.ndarray:
    q = np.clip(np.rint(_premultiplied(rng, h, w, cover) * 32767.0),
                -32767.0, 32767.0)
    return q.astype(np.int16)


def synthetic_compose(case: str, seed: int, width: int = 384,
                      height: int = 300) -> dict:
    """Seeded arguments of `compose_kernel.compose_tiles`, as numpy arrays:
    {"blob", "starts", "images", "slabs", "dyns", "ops", "tiles_y",
    "tiles_x", "background", "height", "width"}. The i16 blob holds the
    slab starts (`starts` is their slice) and then each inline tail's
    tables, quantized in frame coordinates at the scales of
    `wire.SCALES`, and its bins, as `compose._pack_frame_blob`
    lays out a layer whose tail is shapes alone. Between them the cases
    hold every op kind: "layers" a full-frame layer, a rect that starts at
    tile (1, 1) and ends on the frame's ragged last tile row, and three
    slabs (a start on a tile boundary, one off it, one at slab_h − height)
    under y clips that cut tiles; "tails" an inline shape tail and a
    pre-rendered tail at tile columns ≥ 1 between layers; "empty" no op at
    all; "windowless" layers and a tail with no slab."""
    from ..render import rasterizer as R
    from ..render import wire as W

    TILE_H, TILE_W = R.TILE_H, R.TILE_W
    if case not in COMPOSE_CASES:
        raise ValueError(f"unknown case {case!r}; one of {COMPOSE_CASES}")
    rng = np.random.default_rng(seed)
    tiles_y, tiles_x = -(-height // TILE_H), -(-width // TILE_W)
    if tiles_y < 3 or tiles_x < 3:
        raise ValueError("synthetic_compose needs at least 3x3 tiles")
    slab_h = -(-(height + 2 * 192) // TILE_H) * TILE_H
    images, slabs, starts, dyns, ops, tails = [], [], [], {}, [], []

    def img(ty0: int, tx0: int, ty1: int, tx1: int, cover: float = 0.6):
        h = min(ty1 * TILE_H, height) - ty0 * TILE_H
        w = min(tx1 * TILE_W, width) - tx0 * TILE_W
        ops.append(("img", len(images), ty0, tx0))
        images.append(_i16_layer(rng, h, w, cover))

    def slab(start: int, cy0: float, cy1: float):
        ops.append(("slab", len(slabs), (0.0, cy0, float(width), cy1)))
        slabs.append(_i16_layer(rng, slab_h, width, 0.5))
        starts.append(start)

    def dyni(li: int, c0: int, ts: int, n: int):
        x0 = c0 * TILE_W
        sub_w = min(ts * TILE_W, width - x0)
        shapes, clips = _shapes(rng, n, sub_w, height)
        boxes = R._intersect_boxes(R._shape_boxes(shapes, n), clips)
        bins, _ = R._bin_indexed(boxes, np.arange(n, dtype=np.int64),
                                 tiles_y, ts, 32)
        # In frame coordinates: a capsule's two end points, a rect's origin
        # and the clip's x bounds moved by the sub-grid's x.
        shapes[:, 1] += x0
        shapes[:, 3] += np.where(shapes[:, 0] == 1.0, x0, 0.0)
        clips[:, 0::2] += x0
        tails.append((li, n, W.quantize((shapes, clips) + (None,) * 5,
                                        (n, 0, 0), (n, 0, 0)),
                      bins.astype(np.int16)))
        ops.append(("dyni", li, 0, c0, ts))

    def dyn(li: int, ci: int, c0: int, ts: int):
        sub_w = min(ts * TILE_W, width - c0 * TILE_W)
        dyns[(li, ci)] = _premultiplied(rng, height, sub_w, 0.3)
        ops.append(("dyn", li, ci, c0))

    if case == "layers":
        img(0, 0, tiles_y, tiles_x)
        slab(64, 40.25, height - 30.0)
        img(1, 1, tiles_y, tiles_x, 0.8)
        slab(37, 70.0, 200.75)
        slab(slab_h - height, 10.5, float(height))
    elif case == "tails":
        img(0, 0, tiles_y, tiles_x, 0.4)
        dyni(0, 1, 2, 12)
        slab(101, 33.0, height - 47.25)
        dyn(0, 1, 2, 1)
        img(0, 1, 2, 2, 0.9)
        dyni(1, tiles_x - 1, 1, 5)
    elif case == "windowless":
        img(0, 0, 1, tiles_x)
        img(1, 0, tiles_y, 2, 0.7)
        dyni(0, 1, 1, 6)
        dyn(1, 2, 0, tiles_x)
    parts = [np.asarray(starts, np.int16)]
    at = len(starts)
    for li, cap, q_tables, bins in tails:
        dyns[(li, 0)] = (*W.table_offsets(at, (cap, 0, 0), 0),
                         at + q_tables.size, cap, bins.shape[1])
        parts += [q_tables, bins.ravel()]
        at += q_tables.size + bins.size
    return {"blob": np.concatenate(parts), "starts": slice(0, len(starts)),
            "images": images, "slabs": slabs, "dyns": dyns, "ops": tuple(ops),
            "tiles_y": tiles_y, "tiles_x": tiles_x,
            "background": BACKGROUND[:3], "height": height, "width": width}


def compose_args_to(args: dict, device) -> dict:
    """`synthetic_compose`'s arrays as tensors on `device`: the keyword
    arguments of `compose_tiles` but for `blob`, `images`, `slabs` and
    `dyns`, which it takes by position (an inline tail's offsets stay
    ints)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = dict(args)
    out["blob"] = t(args["blob"])
    out["images"] = tuple(t(a) for a in args["images"])
    out["slabs"] = tuple(t(a) for a in args["slabs"])
    out["dyns"] = {k: v if isinstance(v, tuple) else t(v)
                   for k, v in args["dyns"].items()}
    return out
