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
