"""A font face backed by stored glyph masks, for the fallback bank on a
machine without Pillow, fontTools or matplotlib.

`data/bank_masks.npz` holds, for every codepoint of the `fallback` golden
scene outside the resident atlas, what Pillow gives for DejaVu Sans and
DejaVu Sans Bold at the bank's size (`ATLAS_FONT_PX * OVERSAMPLE`): the
glyph's u8 mask, its bounding box and its advance, and each face's ascent,
descent and OS/2 weight. `tests/tools/export_bank_masks.py` writes it.

`MaskFace` answers `getmask`, `getbbox`, `getlength` and `getmetrics` from
those arrays, as Pillow's FreeTypeFont does for the same glyphs, and
`MaskChainFont` stands where the bank keeps a `_ChainFont`. So
`pin_mask_bank(renderer)`, the counterpart of `tools/goldens.py::
_pin_dejavu_bank`, runs the bank's own code unchanged: rasterize → the EDT
on the renderer's device → texture rows → re-upload. Only `chip_smoke.py`
and the tests use it.
"""

from __future__ import annotations

import os

import numpy as np

BANK_MASKS_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "bank_masks.npz")

# npz keys per face: {face}_cps (n,) i64 the codepoints the face covers,
# {face}_bbox (n, 4) i64, {face}_advance (n,) f64, {face}_size (n, 2) i64
# mask (w, h), {face}_masks the masks' u8 rows back to back,
# {face}_ascent, {face}_descent, {face}_weight.
FACES = ("regular", "bold")


class _Mask:
    """What `getmask` gives: a `size` of (w, h), and the u8 rows."""

    def __init__(self, rows: np.ndarray):
        self._rows = rows
        self.size = (rows.shape[1], rows.shape[0])

    def __array__(self, dtype=None, copy=None):
        return self._rows if dtype is None else self._rows.astype(dtype)


class MaskFace:
    """Pillow's FreeTypeFont calls the bank makes, for the stored glyphs."""

    def __init__(self, arrays: dict, face: str):
        self._glyphs = {}
        pos = 0
        for cp, bbox, adv, (w, h) in zip(
                arrays[f"{face}_cps"].tolist(), arrays[f"{face}_bbox"],
                arrays[f"{face}_advance"].tolist(), arrays[f"{face}_size"]):
            rows = arrays[f"{face}_masks"][pos:pos + w * h].reshape(h, w)
            pos += w * h
            self._glyphs[cp] = (rows, tuple(int(v) for v in bbox), adv)
        self._metrics = (int(arrays[f"{face}_ascent"]),
                         int(arrays[f"{face}_descent"]))

    def codepoints(self) -> set:
        return set(self._glyphs)

    def getmask(self, ch: str, mode: str = "L") -> _Mask:
        if mode != "L":
            raise ValueError(f"mask mode {mode!r}: only 'L' is stored")
        return _Mask(self._glyphs[ord(ch)][0])

    def getbbox(self, ch: str) -> tuple:
        return self._glyphs[ord(ch)][1]

    def getlength(self, ch: str) -> float:
        return self._glyphs[ord(ch)][2]

    def getmetrics(self) -> tuple:
        return self._metrics


class MaskChainFont:
    """Stands where the bank keeps a `_ChainFont`: the face, its coverage
    (the stored codepoints), its ascent and its OS/2 weight."""

    def __init__(self, path: str, arrays: dict, face: str):
        self.path = path
        self.pil = MaskFace(arrays, face)
        self.cmap = self.pil.codepoints()
        self.weight = int(arrays[f"{face}_weight"])
        self.ascent = self.pil.getmetrics()[0]

    def covers(self, cp: int) -> bool:
        return cp in self.cmap


def load_mask_fonts(path: str = BANK_MASKS_NPZ) -> dict:
    """→ {face: MaskChainFont} for "regular" and "bold"."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return {face: MaskChainFont(f"{path}:{face}", arrays, face)
            for face in FACES}


def pin_mask_bank(renderer, path: str = BANK_MASKS_NPZ):
    """Swap in a fresh fallback bank whose chain is the stored DejaVu
    masks, ranked as `_pin_dejavu_bank` ranks DejaVu (regular runs: the
    regular face; bold runs: the bold face, then the regular one).
    Returns a restore callable."""
    from .goldens import pin_bank

    fonts = load_mask_fonts(path)
    reg, bold = fonts["regular"], fonts["bold"]
    return pin_bank(renderer, {False: [reg.path], True: [bold.path, reg.path]},
                    {reg.path: reg, bold.path: bold})
