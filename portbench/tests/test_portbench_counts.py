"""The roofline counts of a hand-built scene against hand arithmetic."""

import numpy as np

from portbench import counts


def table(rows, cols):
    return np.asarray(rows, np.float32).reshape(-1, cols)


def layer(shapes=(), shape_clips=(), glyphs=(), glyph_clips=(),
          images=(), image_clips=()):
    n_g = len(glyphs)
    return {"shapes": table(shapes, 16), "shape_clips": table(shape_clips, 4),
            "glyphs": table(glyphs, 8),
            "glyph_colors": np.ones((n_g, 4), np.float32),
            "glyph_clips": table(glyph_clips, 4),
            "images": table(images, 8), "image_clips": table(image_clips, 4)}


NOCLIP = [-1e6, -1e6, 1e6, 1e6]


def rect(x, y, w, h):
    return [0, x, y, w, h, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0]


def test_raster_and_compose_counts():
    H, W = 64, 256
    # A 10x4 rect at (20, 30): its box grown by 0.5 + 1 px is
    # [18.5, 28.5]..[31.5, 35.5], pixel centres 18..31 x 28..35 = 14 x 8.
    # A 100x100 rect at (200, 10) runs off the frame: columns 198..255
    # (58) x rows 8..63 (56).
    # An image quad 16x16 at (0, 0) sampling a 64x64 cell: grown by one
    # texel (0.25 px) and one pixel: [-1.25, 17.25] -> columns 0..16 and
    # rows 0..16, cut by its clip (x <= 8): columns 0..7 -> 8 x 17.
    # A glyph 8x12 at (100, 20), atlas cell 32x48: a texel is 0.25 px; the
    # SDF reaches 0 coverage inside it (8 * 0.25 / 0.7 >= 0.5), so it is
    # grown by 1.25 px: [98.75, 109.25] x [18.75, 33.25] -> 99..108 (10) x
    # 19..32 (14).
    base = layer(shapes=[rect(20, 30, 10, 4) + [], rect(200, 10, 100, 100)],
                 shape_clips=[NOCLIP, NOCLIP],
                 images=[[0, 0, 16, 16, 0, 0, 64, 64]],
                 image_clips=[[-1e6, -1e6, 8, 1e6]])
    top = layer(glyphs=[[100, 20, 8, 12, 0, 0, 32, 48]],
                glyph_clips=[NOCLIP])
    c = counts.frame_counts([base, top], H, W)
    shapes_px = 14 * 8 + 58 * 56
    image_px = 8 * 17
    glyph_px = 10 * 14
    assert c["raster_ops"] == (shapes_px * 50 + image_px * 65
                               + glyph_px * 50)
    frame = H * W * 4
    assert c["raster_bytes"] == frame + 2 * 80 + 1 * 48 + 1 * 64
    # K3: the base layer's box is columns 0..255 and rows 0..63 (the whole
    # frame); the top layer's 99..108 x 19..32.
    assert c["compose_bytes"] == frame + 256 * 64 * 4 + 10 * 14 * 4


def test_least_time_is_the_larger_bound():
    c = {"raster_ops": 67e12 * 2e-6, "raster_bytes": 3.35e12 * 1e-6,
         "compose_bytes": 3.35e12 * 3e-6}
    least = counts.least_by_kernel(c)
    assert np.isclose(least["K1"], 2e-6) and least["K1"] == least["K2"]
    assert np.isclose(least["K3"], 3e-6)
    total = counts.sum_least([c, c], np.array([0, 1, 1]))
    assert np.isclose(total["K3"], 9e-6)
