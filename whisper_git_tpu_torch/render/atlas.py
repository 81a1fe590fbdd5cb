"""Font atlases from the committed `data/atlas.npz`.

The reference builds its SDF atlases at start-up (`build_atlas`: Pillow
rasterizes DejaVu from matplotlib's font folder, then a JAX exact EDT).
None of those three exists on the GPU machine, so the port ships the
reference's output: `python -m whisper_git_tpu_torch.tools.export_atlas`
writes both textures and their glyph metrics, and this module rebuilds the
reference's `FontAtlas` objects from them with numpy alone.
"""

from __future__ import annotations

import os

import numpy as np

from whisper_git_tpu.render.atlas import FontAtlas, Glyph

ATLAS_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "atlas.npz")

# npz keys per face: {face}_texture (H, W) u8, {face}_meta (n, 7) f64
# (u, v, w, h, bearing_x, bearing_y, advance), {face}_ascent,
# {face}_descent; `chars` (n,) <U1 is shared by both faces.
FACES = ("regular", "bold")


def atlas_arrays(atlas: FontAtlas, chars) -> dict:
    """The npz arrays of one face (used by the export tool and its test)."""
    meta = np.array([(g.u, g.v, g.w, g.h, g.bearing_x, g.bearing_y,
                      g.advance) for g in (atlas.glyphs[c] for c in chars)],
                    np.float64)
    return {"texture": np.ascontiguousarray(atlas.texture, np.uint8),
            "meta": meta,
            "ascent": np.float64(atlas.ascent),
            "descent": np.float64(atlas.descent)}


def load_atlases(path: str = ATLAS_NPZ) -> tuple[FontAtlas, FontAtlas]:
    """→ (regular, bold) FontAtlas, as the reference's build_atlas makes
    them, with no fallback bank attached."""
    with np.load(path, allow_pickle=False) as z:
        chars = [str(c) for c in z["chars"]]
        out = []
        for face in FACES:
            meta = z[f"{face}_meta"]
            glyphs = {c: Glyph(int(m[0]), int(m[1]), int(m[2]), int(m[3]),
                               float(m[4]), float(m[5]), float(m[6]))
                      for c, m in zip(chars, meta)}
            out.append(FontAtlas(np.array(z[f"{face}_texture"], np.uint8),
                                 glyphs, float(z[f"{face}_ascent"]),
                                 float(z[f"{face}_descent"]),
                                 is_bold=face == "bold"))
    return out[0], out[1]


def font_texture(regular: FontAtlas, bold: FontAtlas) -> np.ndarray:
    """The combined (H, W) u8 font texture: regular rows, then bold rows,
    both padded to the wider width (`whisper_git_tpu/render/renderer.py`,
    `Renderer.__init__`). Bold glyph v coordinates are offset by the
    regular texture's height."""
    rt, bt = regular.texture, bold.texture
    w = max(rt.shape[1], bt.shape[1])

    def pad(t):
        if t.shape[1] < w:
            t = np.pad(t, ((0, 0), (0, w - t.shape[1])), constant_values=0)
        return t

    return np.concatenate([pad(rt), pad(bt)], axis=0)
