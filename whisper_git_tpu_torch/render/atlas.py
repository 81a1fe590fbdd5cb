"""SDF font atlas: the atlas types, text measurement, the atlas build
pipeline, and the atlases themselves loaded from the committed
`data/atlas.npz`.

`Glyph`, `FontAtlas`, `AtlasMeasurer` and `_CHARS` are the port's own copy
of the device-free part of `whisper_git_tpu/render/atlas.py`. The build
half is the reference's too: Pillow rasterizes a glyph at 2× oversample
(`rasterize_glyph_cell`), the exact EDT of `ops/sdf.py` encodes a batch of
cells on a torch device (`encode_sdf_cells`), and `glyph_cell_metrics`
turns the glyph's box into atlas metrics. The fallback glyph bank
(`render/fallback.py`) runs every glyph it adds through that pipeline.

`build_atlas` builds the resident atlas from DejaVu (matplotlib's font
folder) through the same pipeline, byte for byte the reference's. A
renderer does not call it: it loads the atlases from the npz with numpy
alone (`load_atlases`), since the machine with the card has neither Pillow
nor matplotlib. `tests/tools/export_atlas.py` writes the npz.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

ATLAS_FONT_PX = 44          # base glyph size rendered into the atlas
OVERSAMPLE = 2              # rasterize at 2×, EDT at high res, store at 1×
CELL = 64                   # atlas cell size in px (must fit glyph + spread)
SPREAD = 8.0                # SDF spread in atlas pixels
GRID_COLS = 12

_CHARS = list(dict.fromkeys(
    [chr(c) for c in range(32, 127)]              # ASCII
    + [chr(c) for c in range(0xA1, 0x100)]        # Latin-1 supplement
    + [chr(c) for c in range(0x100, 0x180)]       # Latin Extended-A
    # Greek + Cyrillic: DejaVu covers them and commit messages use them.
    + [chr(c) for c in range(0x386, 0x3CF) if chr(c).isprintable()]
    + [chr(c) for c in range(0x400, 0x460)]
    + list("…·→✓—–•✕⚙⚠▸▾▴◂↑↓↗⟳›‹▏●○■□†‡€™")       # UI symbols
    + list("‘’“”„−±≈≠≤≥")                          # punctuation/math
))


def _font_path(bold: bool) -> str:
    import matplotlib
    fdir = os.path.join(os.path.dirname(matplotlib.__file__),
                        "mpl-data", "fonts", "ttf")
    return os.path.join(fdir, "DejaVuSans-Bold.ttf" if bold else "DejaVuSans.ttf")


@dataclass
class Glyph:
    u: int          # atlas cell origin (px)
    v: int
    w: int          # glyph bitmap extent inside the cell (px, atlas scale)
    h: int          # (kept for measurement; sampling uses the shared band)
    bearing_x: float  # quad x offset from the pen position, atlas px
    bearing_y: float  # quad y offset from the line top, atlas px
    advance: float    # atlas px


@dataclass
class FontAtlas:
    texture: np.ndarray          # (H, W) uint8 SDF (128 = edge)
    glyphs: dict                  # char -> Glyph
    ascent: float                 # atlas px
    descent: float
    font_px: float = float(ATLAS_FONT_PX)
    spread: float = SPREAD
    is_bold: bool = False  # routes fallback-bank lookups to the bold bank
    # Cells are BASELINE-ALIGNED: every glyph's ink sits at its line-top
    # offset within its cell (shifted down by the spread margin), so all
    # glyphs of a run share one vertical sampling band — the run-batched
    # kernel builds the row-weight matrix once per run, not per glyph.
    band_top: float = -SPREAD    # band origin relative to line top, atlas px
    band_h: float = float(CELL)  # band extent = the full cell

    def __post_init__(self):
        # Vectorized lookup tables: codepoint → metrics row. Text emission
        # and measurement run as numpy ops over whole strings.
        max_cp = max(ord(c) for c in self.glyphs) + 1
        fallback = self.glyphs.get("?")
        # columns: u, v, w, h, bearing_x, bearing_y, advance, known
        self.lut = np.zeros((max_cp, 8), np.float32)
        if fallback is not None:
            self.lut[:, :7] = (fallback.u, fallback.v, fallback.w,
                               fallback.h, fallback.bearing_x,
                               fallback.bearing_y, fallback.advance)
        for c, g in self.glyphs.items():
            cp = ord(c)
            self.lut[cp] = (g.u, g.v, g.w, g.h, g.bearing_x, g.bearing_y,
                            g.advance, 1.0)
        self.max_cp = max_cp
        self._measure_cache: dict = {}
        # Lazy fallback bank (render/fallback.py) — attached by the
        # Renderer; None keeps the resident-only behavior ('?' fallback).
        self.fallback = None

    def attach_fallback(self, bank) -> None:
        self.fallback = bank
        self._measure_cache.clear()
        getattr(self, "_elide_cache", {}).clear()

    def codepoints(self, s: str) -> np.ndarray:
        cps = np.frombuffer(s.encode("utf-32-le"), np.uint32).astype(np.int64)
        return np.where(cps < self.max_cp, cps, ord("?"))

    def raw_codepoints(self, s: str) -> np.ndarray:
        return np.frombuffer(s.encode("utf-32-le"),
                             np.uint32).astype(np.int64)

    def metric_rows(self, line: str
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool,
                               bool]:
        """Per-codepoint metric rows for one run, consulting the fallback
        bank for out-of-coverage codepoints (lazily rasterizing them).

        Returns (rows (n,8), abs_v (n,) bool, cps (n,) int64, used_bank,
        deferred). Rows with abs_v=True came from the bank: their v is
        ABSOLUTE in the combined font texture (the emitter must not add
        the bold v-offset). `deferred`=True means some codepoint had
        chain coverage but no recyclable bank slot THIS frame — it
        renders '?' now and the caller must not cache the result (the
        glyph lands next frame).

        RTL/Arabic input passes through render/shaping.py first (bidi
        visual reorder + presentation forms), HERE — the single choke
        point — so measured widths, elision bounds, and emitted quads
        can never disagree about what a string shapes to."""
        from .shaping import shape_visual

        line = shape_visual(line)
        cps = self.raw_codepoints(line)
        clipped = np.where(cps < self.max_cp, cps, ord("?"))
        rows = self.lut[clipped]          # fancy index → fresh copy
        abs_v = np.zeros(len(cps), bool)
        used = False
        deferred = False
        bank = self.fallback
        if bank is not None:
            unknown = (cps >= self.max_cp) | (rows[:, 7] == 0.0)
            if unknown.any():
                uniq = np.unique(cps[unknown])
                bank.ensure(uniq, bold=self.is_bold)
                bank.touch([bank.key_for(cp, self.is_bold)
                            for cp in uniq])
                for i in np.nonzero(unknown)[0]:
                    key = bank.key_for(int(cps[i]), self.is_bold)
                    r = bank.metrics.get(key)
                    if r is not None:
                        rows[i] = r
                        abs_v[i] = True
                        used = True
                    elif key not in bank.missing:
                        deferred = True
        return rows, abs_v, cps, used, deferred

    def caret_index_from_click(self, s: str, size: float,
                               rel_x: float) -> int:
        """Click x (px, relative to the text origin) → LOGICAL caret
        index, exact through bidi/Arabic shaping: each logical caret
        slot's visual x comes from the shaped string's advances and the
        caret map (render/shaping.caret_slots); the nearest slot wins.
        For plain LTR this is the ordinary nearest-boundary pick."""
        from .shaping import PRESHAPED, caret_slots, shape_visual

        n = len(s)
        if n == 0:
            return 0
        vis = shape_visual(s)
        rows, _, _, _, _ = self.metric_rows(PRESHAPED + vis)
        adv = rows[:, 6] * (size / self.font_px)
        xs = np.concatenate([[0.0], np.cumsum(adv)])
        slots = caret_slots(s)
        best, best_d = 0, float("inf")
        for k in range(n + 1):
            d = abs(float(xs[slots[k]]) - rel_x)
            if d < best_d:
                best, best_d = k, d
        return best

    def advance(self, ch: str) -> float:
        g = self.glyphs.get(ch) or self.glyphs.get("?")
        return g.advance if g else self.font_px * 0.6

    def measure(self, s: str, size: float) -> float:
        """Memoized: view strings (timestamps, names, labels) recur across
        frames, so steady-state layout mostly hits this cache. Fallback-
        bank advances participate (a CJK subject must measure at its real
        width, not len × '?'-width); the bank's ensure runs here, so by
        emit time the glyphs are already resident."""
        if not s:
            return 0.0
        cache = self._measure_cache
        total = cache.get(s)
        if total is None:
            if self.fallback is None:
                from .shaping import shape_visual

                cps = self.codepoints(shape_visual(s))
                total = float(self.lut[cps, 6].sum())
                deferred = False
            else:
                # One shared resolution path with text emission
                # (metric_rows), so measured widths and emitted quads
                # can never disagree.
                rows, _, _, _, deferred = self.metric_rows(s)
                total = float(rows[:, 6].sum())
            if len(cache) > 100_000:
                cache.clear()
            if not deferred:   # deferred widths are '?'-approximate —
                cache[s] = total  # recompute next frame
        return total * (size / self.font_px)

    def line_height(self, size: float) -> float:
        return (self.ascent + self.descent) * (size / self.font_px) * 1.08

    def elide(self, s: str, size: float, max_w: float) -> str:
        """Cut `s` to fit `max_w` px with a trailing '…' (El.ellipsis —
        views elide instead of clipping mid-glyph). Memoized per
        (string, size, width-bucket): visible rows recur every frame."""
        if not s:
            return s
        key = (s, size, round(max_w * 4.0))
        cache = getattr(self, "_elide_cache", None)
        if cache is None:
            cache = self._elide_cache = {}
        hit = cache.get(key)
        if hit is not None:
            return hit
        deferred = False
        if self.measure(s, size) <= max_w + 0.5:
            out = s
        else:
            from .shaping import needs_shaping

            if needs_shaping(s):
                # Shaped text: metric_rows' advances are in VISUAL order,
                # so cumulative sums don't map to logical prefixes —
                # binary-search the longest logical prefix that fits
                # (each probe is a cached measure of the shaped prefix).
                if self.fallback is not None:
                    _, _, _, _, deferred = self.metric_rows(s)
                lo, hi = 1, len(s)
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if self.measure(s[:mid].rstrip() + "…",
                                    size) <= max_w + 0.5:
                        lo = mid
                    else:
                        hi = mid - 1
                out = s[:lo].rstrip() + "…"
            else:
                scale = size / self.font_px
                if self.fallback is None:
                    adv = self.lut[self.codepoints(s), 6] * scale
                else:
                    rows, _, _, _, deferred = self.metric_rows(s)
                    adv = rows[:, 6] * scale
                ell_w = self.measure("…", size)
                cum = np.cumsum(adv)
                fit = int(np.searchsorted(cum, max(max_w - ell_w, 0.0),
                                          side="right"))
                out = s[:max(fit, 1)].rstrip() + "…"
        if not deferred:  # '?'-approximate widths: recompute next frame
            if len(cache) > 20_000:
                cache.clear()
            cache[key] = out
        return out


def rasterize_glyph_cell(font, ch: str, row0_of_ink_top
                         ) -> tuple[np.ndarray, int, int, int, float]:
    """Rasterize ONE glyph into an oversampled coverage cell — the shared
    front half of the SDF pipeline (used by build_atlas for the resident
    set and by render/fallback.py for the lazy bank, so placement
    conventions cannot drift between them).

    row0_of_ink_top(bbox_y0) -> oversampled cell row where the ink's top
    lands (the resident atlas derives it from line-top + spread margin;
    the bank aligns baselines against the resident ascent).
    Returns (cell (os, os) f32, mask_w, mask_h, bbox_x0, advance) at the
    oversampled scale."""
    mask = font.getmask(ch, mode="L")
    mw, mh = mask.size
    bbox = font.getbbox(ch)
    adv = font.getlength(ch)
    os_cell = CELL * OVERSAMPLE
    pad = int(SPREAD * OVERSAMPLE)
    cell = np.zeros((os_cell, os_cell), np.float32)
    if mw > 0 and mh > 0:
        arr = np.asarray(mask, np.float32).reshape(mh, mw) / 255.0
        row0 = int(np.clip(row0_of_ink_top(bbox[1]), 0, os_cell - 1))
        cw = min(mw, os_cell - 2 * pad)
        chh = min(mh, os_cell - row0)
        if chh > 0:
            cell[row0:row0 + chh, pad:pad + cw] = arr[:chh, :cw]
    return cell, mw, mh, bbox[0], adv


def encode_sdf_cells(coverages: np.ndarray, device="cuda") -> np.ndarray:
    """(B, os, os) coverage → (B, CELL, CELL) encoded u8 SDF cells: the
    batched exact EDT on `device` + stride downsample (the shared back
    half of the pipeline)."""
    import torch

    from ..ops.sdf import sdf_to_u8, signed_distance_field_batch

    cov = torch.from_numpy(np.ascontiguousarray(coverages, np.float32))
    sdf = signed_distance_field_batch(cov.to(torch.device(device)),
                                      max_dist=SPREAD * OVERSAMPLE)
    enc = sdf_to_u8(sdf / OVERSAMPLE, spread=SPREAD).cpu().numpy()
    return enc[:, ::OVERSAMPLE, ::OVERSAMPLE]


def glyph_cell_metrics(mw: int, mh: int, bx0: int, adv: float
                       ) -> tuple[int, int, float, float, float]:
    """(mask_w, mask_h, bbox_x0, advance) at oversampled scale →
    (w, h, bearing_x, bearing_y, advance) at atlas scale — the ONE
    metric encoding both the resident atlas and the bank use."""
    pad_small = int(SPREAD)
    return (min(mw // OVERSAMPLE + 2 * pad_small, CELL),
            min(mh // OVERSAMPLE + 2 * pad_small, CELL),
            bx0 / OVERSAMPLE - pad_small,
            -float(pad_small),
            adv / OVERSAMPLE)


def _cache_dir() -> str:
    d = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    path = os.path.join(d, "whisper-git-tpu-torch")
    os.makedirs(path, exist_ok=True)
    return path


def build_atlas(bold: bool = False, use_cache: bool = True,
                device="cuda") -> FontAtlas:
    """The resident atlas of one face, built as the reference builds it
    (Pillow, DejaVu from matplotlib, the EDT on `device`). The cache file
    holds no pickled object: `chars` is a `<U1` array."""
    from PIL import ImageFont

    font_file = _font_path(bold)
    key = hashlib.md5(
        f"{font_file}:{ATLAS_FONT_PX}:{OVERSAMPLE}:{CELL}:{SPREAD}:"
        f"{''.join(_CHARS)}:v4-baseline".encode()).hexdigest()[:16]
    cache = os.path.join(_cache_dir(), f"atlas-{key}.npz")
    if use_cache and os.path.exists(cache):
        try:
            with np.load(cache, allow_pickle=False) as z:
                glyphs = {str(c): Glyph(*row)
                          for c, row in zip(z["chars"], z["meta"])}
                return FontAtlas(z["texture"], glyphs,
                                 float(z["ascent"]), float(z["descent"]),
                                 is_bold=bold)
        except (OSError, ValueError, KeyError):
            pass

    font = ImageFont.truetype(font_file, ATLAS_FONT_PX * OVERSAMPLE)
    ascent_o, descent_o = font.getmetrics()
    pad = int(SPREAD * OVERSAMPLE)

    coverages = []
    records = []  # (char, mask_w, mask_h, bbox_x0, adv) oversampled
    for ch in _CHARS:
        # Baseline-aligned placement: the ink lands at its line-top
        # offset (bbox y0) within the cell, below the spread margin,
        # so every glyph shares the cell-wide vertical band.
        cell, mw, mh, bx0, adv = rasterize_glyph_cell(
            font, ch, lambda y0: pad + y0)
        coverages.append(cell)
        records.append((ch, mw, mh, bx0, adv))

    enc_small = encode_sdf_cells(np.stack(coverages), device)

    n = len(_CHARS)
    rows = (n + GRID_COLS - 1) // GRID_COLS
    # 0 = far outside (no ink) in the 128-is-edge encoding.
    texture = np.zeros((rows * CELL, GRID_COLS * CELL), np.uint8)
    glyphs: dict[str, Glyph] = {}
    for i, (ch, mw, mh, bx0, adv) in enumerate(records):
        r, c = divmod(i, GRID_COLS)
        u, v = c * CELL, r * CELL
        texture[v:v + CELL, u:u + CELL] = enc_small[i]
        w, h, bearing_x, bearing_y, advance = glyph_cell_metrics(
            mw, mh, bx0, adv)
        # Baseline-aligned cells: row 0 of every cell is line-top minus
        # the spread margin (the ink itself sits at bbox y0).
        glyphs[ch] = Glyph(u=u, v=v, w=w, h=h, bearing_x=bearing_x,
                           bearing_y=bearing_y, advance=advance)
    atlas = FontAtlas(texture, glyphs,
                      ascent=ascent_o / OVERSAMPLE,
                      descent=descent_o / OVERSAMPLE,
                      is_bold=bold)
    if use_cache:
        try:
            np.savez_compressed(
                cache, texture=texture,
                chars=np.array(_CHARS, dtype="<U1"),
                meta=np.array([(g.u, g.v, g.w, g.h, g.bearing_x, g.bearing_y,
                                g.advance) for g in
                               (glyphs[c] for c in _CHARS)], np.float32),
                ascent=atlas.ascent, descent=atlas.descent)
        except OSError:
            pass
    return atlas


class AtlasMeasurer:
    """TextMeasurer backed by real atlas metrics (drop-in for ui.layout)."""

    def __init__(self, regular: FontAtlas, bold_atlas: FontAtlas):
        self.regular = regular
        self.bold = bold_atlas

    def width(self, s: str, size: float, bold: bool = False) -> float:
        return (self.bold if bold else self.regular).measure(s, size)

    def height(self, size: float) -> float:
        return self.regular.line_height(size)

    def caret_index_from_click(self, s: str, size: float, rel_x: float,
                               bold: bool = False) -> int:
        return (self.bold if bold else self.regular
                ).caret_index_from_click(s, size, rel_x)


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
