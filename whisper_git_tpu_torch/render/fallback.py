"""Lazy fallback glyph bank — the system-font fallback chain.

The port's copy of `whisper_git_tpu/render/fallback.py`, with two
departures: the EDT of a new batch of glyphs runs on the bank's torch
device (`FallbackBank(device=...)`, the renderer's), and the chain skips
its DejaVu tier where matplotlib is absent (the reference's
`discover_chain_paths` would raise there, out of `metric_rows` into the
frame). Where fontTools or Pillow is absent no chain font loads, every
out-of-coverage codepoint is remembered as missing and renders '?'.

Capability parity with the reference's text stack, which gets full-script
coverage (CJK included) from cosmic-text's system-font fallback chain
(reference: aetna-vulkano text stack, docs/render_engine.md pre-port
"cosmic-text shaping"; Cargo.lock pins cosmic-text). The resident SDF
atlas (render/atlas.py) covers ASCII/Latin/Greek/Cyrillic + UI symbols —
the VMEM-resident working set. Everything else lands here:

  * The FIRST time an out-of-coverage codepoint is measured or emitted,
    the bank walks a discovered font chain (WGIT_FALLBACK_FONTS, then
    fontconfig, then well-known CJK font paths, then DejaVu itself —
    which covers Hebrew/Arabic/Armenian/box-drawing/math far beyond the
    resident set), rasterizes the glyph through the SAME pipeline as the
    resident atlas (PIL at 2× oversample → batched exact-EDT SDF on the
    renderer's device → u8 cells), and installs it into a fixed-capacity
    auxiliary texture.
  * The bank texture concatenates BELOW the regular+bold atlas rows in
    the combined font texture, so the kernels' glyph step (K1 and K2,
    which also pre-renders K3's glyph tails) samples it with zero new
    code — a bank glyph is just a quad whose v points past the resident
    rows. Capacity is FIXED at
    construction: the combined texture's shape changes exactly once
    (when the first fallback glyph appears); new glyphs are an in-place
    write + one device re-upload.
  * Codepoints with no coverage anywhere in the chain are remembered as
    missing and render '?' (the resident fallback), never retried.

Bidi reordering + Arabic contextual shaping run upstream of the bank
(render/shaping.py at the atlas.metric_rows choke point), and the bank
is weight-aware: bold runs rasterize from a real bold chain face when
one covers the codepoint (e.g. DejaVuSans-Bold), else from the regular
face with a synthetic embolden (coverage dilation before SDF encode).
CJK — the load-bearing case (each codepoint is one glyph, no shaping) —
renders correctly whenever any CJK-capable font exists on the system.
Explicit directional controls are honored too (UAX#9 X1-X8 + N0, over
full BD13 isolating run sequences — render/shaping.py). Remaining
honest delta vs cosmic-text (docs/parity-matrix.md): no IME preedit
(the terminal protocol has no preedit events).

Eviction is EPOCH-BASED (see FallbackBank.__init__): slots untouched
since the last epoch clear are provably unreferenced by any cache and
recycle freely; protected slots defer overflow glyphs to '?' and a
rate-limited voluntary clear (`evictions` bump → SceneCompiler.compile
drops quad + device caches) frees stale slots. `version` bumps on every
texture write so the renderer re-uploads the device copy.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from .atlas import ATLAS_FONT_PX, CELL, OVERSAMPLE, SPREAD, _font_path

# Well-known CJK-capable fonts, best first. Checked for existence; the
# chain only keeps loadable fonts.
_KNOWN_FALLBACK_GLOBS = (
    "/usr/share/fonts/**/NotoSansCJK*",
    "/usr/share/fonts/**/NotoSerifCJK*",
    "/usr/share/fonts/**/SourceHanSans*",
    "/usr/share/fonts/**/WenQuanYi*",
    "/usr/share/fonts/**/wqy*",
    "/usr/share/fonts/**/DroidSansFallback*",
    "/usr/share/fonts/**/unifont*",
    "/System/Library/Fonts/PingFang.ttc",
)

# One EDT batch shape: new glyphs process in padded batches of this many
# cells (the reference's, whose jitted EDT compiles once per shape).
_ENSURE_BATCH = 16

_UNLOADED = object()  # sentinel: font path discovered but not yet loaded


def _fontconfig_candidates() -> list[str]:
    """Ask fontconfig for CJK-capable fonts (best-effort; absent or
    broken fc-list just skips this tier of the chain). All three CJK
    lang tags are queried — a machine with only NotoSansJP installed
    would be invisible to :lang=zh alone."""
    fc = shutil.which("fc-list")
    if fc is None:
        return []
    out: list[str] = []
    for lang in ("zh", "ja", "ko"):
        try:
            r = subprocess.run(
                [fc, "--format", "%{file}\n", f":lang={lang}"],
                capture_output=True, text=True, timeout=2.0)
            out += [p for p in r.stdout.splitlines() if p.strip()]
        except (OSError, subprocess.SubprocessError):
            break  # fc-list broken: don't pay the timeout 3×
    return out


def _bold_sibling(path: str) -> Optional[str]:
    """Heuristic bold variant of a font file path, if one exists on
    disk (DejaVuSans.ttf → DejaVuSans-Bold.ttf, *-Regular.* →
    *-Bold.*)."""
    root, ext = os.path.splitext(path)
    for cand in (root + "-Bold" + ext,
                 root.replace("-Regular", "-Bold") + ext,
                 root.replace("Regular", "Bold") + ext):
        if cand != path and os.path.isfile(cand):
            return cand
    return None


def discover_chain_paths(bold: bool = False) -> list[str]:
    """Ordered candidate font paths for the fallback chain. For the bold
    chain: each candidate's real bold variant (when one exists on disk)
    ranks ahead of the regular file — a covering regular face is still a
    valid tail (the bank synthetically emboldens it; see
    _rasterize_batch)."""
    import glob as _glob

    paths: list[str] = []
    env = os.environ.get("WGIT_FALLBACK_FONTS", "")
    paths += [p for p in env.split(":") if p]
    paths += _fontconfig_candidates()
    for pattern in _KNOWN_FALLBACK_GLOBS:
        paths += sorted(_glob.glob(pattern, recursive=True))
    # DejaVu last: not CJK, but covers Hebrew/Arabic/Armenian/Georgian/
    # box-drawing/math — the long non-CJK tail the resident atlas skips.
    # It ships with matplotlib; without matplotlib the tier is skipped.
    try:
        paths.append(_font_path(bold=False))
    except ImportError:
        pass
    if bold:
        with_bold: list[str] = []
        for p in paths:
            sib = _bold_sibling(p)
            if sib is not None:
                with_bold.append(sib)
            with_bold.append(p)
        paths = with_bold
    seen: set[str] = set()
    out = []
    for p in paths:
        if p not in seen and os.path.isfile(p):
            seen.add(p)
            out.append(p)
    return out


class _ChainFont:
    """One loaded chain entry: PIL face + fontTools cmap coverage set."""

    def __init__(self, path: str):
        from fontTools.ttLib import TTFont
        from PIL import ImageFont

        self.path = path
        # fontNumber=0 handles .ttc collections.
        kwargs = {"fontNumber": 0} if path.endswith((".ttc", ".TTC")) else {}
        tt = TTFont(path, lazy=True, **kwargs)
        self.cmap = set(tt.getBestCmap().keys())
        try:
            # OS/2 weight class: ≥600 is a real bold face — the bold
            # chain uses this to decide whether a covering font still
            # needs synthetic emboldening.
            self.weight = int(tt["OS/2"].usWeightClass)
        except Exception:
            self.weight = 400
        tt.close()
        self.pil = ImageFont.truetype(path, ATLAS_FONT_PX * OVERSAMPLE)
        self.ascent = self.pil.getmetrics()[0]

    def covers(self, cp: int) -> bool:
        return cp in self.cmap


class FallbackBank:
    """Fixed-capacity lazy glyph bank (see module docstring)."""

    COLS = 12  # same cell grid as the resident atlas → same texture width

    # Bank keys are `cp | BOLD_KEY` for bold-run glyphs (codepoints fit
    # in 21 bits): the bank is weight-aware — bold runs rasterize from a
    # real bold face when the chain has one, else from the regular face
    # with a synthetic embolden (coverage dilation before SDF encode).
    BOLD_KEY = 1 << 21

    @classmethod
    def key_for(cls, cp: int, bold: bool) -> int:
        return (int(cp) | cls.BOLD_KEY) if bold else int(cp)

    def __init__(self, capacity: int = 0, device="cuda"):
        import threading

        self.device = device  # where the EDT of new glyphs runs

        # The interactive host measures text on the UI thread while the
        # render thread compiles scenes (host/loop.py render worker);
        # both paths call ensure/touch. The RLock serializes slot
        # mutation; readers of `metrics` outside the lock can at worst
        # see a just-recycled row (one frame of measurement jitter — an
        # epoch clear drops the dependent caches before pixels can lie).
        self._lock = threading.RLock()
        if capacity <= 0:
            capacity = int(os.environ.get("WGIT_FALLBACK_CAP", "192"))
        self.rows = max(1, -(-capacity // self.COLS))
        self.capacity = self.rows * self.COLS
        self.texture = np.zeros((self.rows * CELL, self.COLS * CELL),
                                np.uint8)
        # key_for(cp, bold) ->
        #   (u, v_ABSOLUTE, w, h, bearing_x, bearing_y, advance, 1.0)
        self.metrics: dict[int, np.ndarray] = {}
        self.missing: set[int] = set()
        self.version = 0      # texture content → device re-upload
        self.evictions = 0    # slot recycling → compiler cache drop
        self.used = False     # any glyph resident → concat the bank rows
        self._slot_cp: list[Optional[int]] = [None] * self.capacity
        self._cp_slot: dict[int, int] = {}
        # Epoch-based slot protection. Invariant: a cached quad (text
        # template, subtree chunk, device layer image) can only reference
        # slots TOUCHED SINCE THE LAST EPOCH CLEAR, because every clear
        # drops all those caches and the rebuild re-touches what is
        # actually referenced. Therefore:
        #   * a slot untouched since the last clear is recyclable at any
        #     time with NO cache clearing;
        #   * when nothing is recyclable (pressure), a rate-limited
        #     VOLUNTARY epoch clear (evictions += 1 → compile drops the
        #     caches) resets protection so stale-but-protected slots age
        #     out after the rebuild — at most one clear per
        #     _CLEAR_BACKOFF frames, so a frame that genuinely needs
        #     more unique glyphs than capacity degrades to bounded '?'
        #     overflow instead of a per-frame cache stampede.
        self.frame_gen = 1
        self._clear_gen = 0        # generation at the last epoch clear
        self._last_clear_frame = -10**9
        self._pressure = False     # some ensure() had to defer
        self._slot_gen: list[int] = [0] * self.capacity
        self._next_slot = 0
        self._v_base: Optional[int] = None
        self._primary_ascent: Optional[float] = None  # atlas px (1×)
        # Per-weight chains (bold ranks real bold variants first);
        # loaded fonts are shared by path across both.
        self._chain_paths: dict = {False: None, True: None}
        self._loaded_fonts: dict = {}  # path -> _ChainFont | None

    # -- wiring -----------------------------------------------------------

    def set_layout(self, v_base: int, primary_ascent: float) -> None:
        """v_base: first texture row of the bank within the COMBINED font
        texture (= regular rows + bold rows). primary_ascent: the
        resident atlas's ascent in atlas px — fallback glyphs align
        their BASELINE to it, so mixed-font runs sit on one line."""
        assert not self.metrics, "set_layout must precede the first ensure"
        self._v_base = v_base
        self._primary_ascent = primary_ascent

    def _font_for(self, cp: int, bold: bool = False
                  ) -> Optional[_ChainFont]:
        """First chain font covering `cp`, loading fonts LAZILY in chain
        order: discovery lists paths cheaply, but a _ChainFont load is a
        multi-MB cmap parse — eagerly loading every candidate (dozens of
        Noto weights on a CJK system) would hitch the frame loop for
        hundreds of ms at the first out-of-coverage glyph. Typically only
        the first covering font ever loads."""
        if self._chain_paths[bold] is None:
            self._chain_paths[bold] = discover_chain_paths(bold)
        for p in self._chain_paths[bold]:
            f = self._loaded_fonts.get(p, _UNLOADED)
            if f is _UNLOADED:
                try:
                    f = _ChainFont(p)
                except Exception:
                    f = None  # unreadable/corrupt font: skip the tier
                self._loaded_fonts[p] = f
            if f is not None and f.covers(cp):
                return f
        return None

    # -- frame protocol ---------------------------------------------------

    _CLEAR_BACKOFF = 10  # frames between voluntary epoch clears

    def begin_frame(self) -> None:
        """Advance the generation; under deferral pressure, fire a
        rate-limited voluntary epoch clear (SceneCompiler.compile calls
        this once per frame and reacts to the eviction counter)."""
        with self._lock:
            self._begin_frame_locked()

    def _begin_frame_locked(self) -> None:
        if (self._pressure
                and self.frame_gen - self._last_clear_frame
                >= self._CLEAR_BACKOFF):
            self.evictions += 1          # compile() drops all caches
            self._clear_gen = self.frame_gen
            self._last_clear_frame = self.frame_gen
        self._pressure = False
        self.frame_gen += 1

    def touch(self, cps) -> None:
        """Mark codepoints as referenced (called whenever metric rows
        resolve — i.e. whenever any cacheable artifact is built)."""
        with self._lock:
            for cp in cps:
                slot = self._cp_slot.get(int(cp))
                if slot is not None:
                    self._slot_gen[slot] = self.frame_gen

    # -- the lazy fill ----------------------------------------------------

    def ensure(self, cps, bold: bool = False) -> bool:
        """Make every codepoint in `cps` resident (at the requested
        weight), known-missing, or DEFERRED (no recyclable slot this
        frame — renders '?' now, retried next frame). Returns True when
        any glyph was added. Metrics/missing are keyed by
        `key_for(cp, bold)` — regular callers see plain-cp keys."""
        with self._lock:
            return self._ensure_locked(cps, bold)

    def _ensure_locked(self, cps, bold: bool = False) -> bool:
        todo = [k for k in dict.fromkeys(self.key_for(c, bold)
                                         for c in cps)
                if k not in self.metrics and k not in self.missing]
        if not todo:
            return False
        assert self._v_base is not None, "set_layout not called"
        jobs = []  # (key, font, slot, synth_bold)
        for key in todo:
            cp = key & ~self.BOLD_KEY
            f = self._font_for(cp, bold)
            if f is None:
                self.missing.add(key)
                continue
            slot = self._take_slot()
            if slot is None:
                self._pressure = True  # deferred: all slots protected
                continue
            # Reserve NOW (not at rasterize time): with more new
            # codepoints than free slots in one ensure(), an unreserved
            # slot would be handed out twice after the scan wraps —
            # permanently drawing the first glyph as the second.
            self._slot_cp[slot] = key
            self._cp_slot[key] = slot
            self._slot_gen[slot] = self.frame_gen
            jobs.append((key, f, slot, bold and f.weight < 600))
        if not jobs:
            return False
        added = False
        for start in range(0, len(jobs), _ENSURE_BATCH):
            batch = jobs[start:start + _ENSURE_BATCH]
            try:
                added |= self._rasterize_batch(batch) > 0
            except Exception:
                # One broken glyph/batch (corrupt outline, failed EDT
                # dispatch) must not crash the frame loop — and must not
                # leave slot-reserved-but-metric-less codepoints that
                # would retry-and-crash every subsequent frame.
                for key, _f, slot, _synth in batch:
                    self._release_slot(key, slot)
                    self.missing.add(key)
        if added:
            self.version += 1
            self.used = True
        return added

    def _release_slot(self, cp: int, slot: int) -> None:
        if self._slot_cp[slot] == cp:
            self._slot_cp[slot] = None
            self._slot_gen[slot] = 0
        self._cp_slot.pop(cp, None)
        self.metrics.pop(cp, None)

    # Synthetic embolden: dilate the oversampled coverage by this many
    # pixels in x and y before SDF encoding (≈ a 1-atlas-px stroke at
    # OVERSAMPLE 2) when a bold run's glyph only exists in a regular
    # face. A real bold face from the chain always wins over this.
    _EMBOLDEN_OS_PX = max(1, OVERSAMPLE // 2)

    @classmethod
    def _embolden(cls, cell: np.ndarray) -> np.ndarray:
        """Morphological dilation with ZERO fill (np.roll would wrap ink
        touching one cell edge onto the opposite edge)."""
        r = cls._EMBOLDEN_OS_PX
        h, w = cell.shape
        out = cell.copy()
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx == 0 and dy == 0:
                    continue
                ys = slice(max(dy, 0), h + min(dy, 0))
                yd = slice(max(-dy, 0), h + min(-dy, 0))
                xs = slice(max(dx, 0), w + min(dx, 0))
                xd = slice(max(-dx, 0), w + min(-dx, 0))
                np.maximum(out[ys, xs], cell[yd, xd], out=out[ys, xs])
        return out

    def _rasterize_batch(self, jobs: list) -> None:
        """Rasterize ≤_ENSURE_BATCH glyphs through the SAME pipeline as
        the resident atlas (shared helpers in render/atlas.py: PIL mask
        → one padded batched EDT on the bank's device → u8 cells → one
        metric encoding).
        jobs: (key, chain_font, slot, synth_bold) with slots already
        taken."""
        from .atlas import (
            encode_sdf_cells,
            glyph_cell_metrics,
            rasterize_glyph_cell,
        )

        os_cell = CELL * OVERSAMPLE
        pad = int(SPREAD * OVERSAMPLE)
        # Resident baseline row within a cell (oversampled): line top at
        # the spread margin + the resident ascent. A chain glyph's ink
        # top is bbox.y0 below ITS OWN font's line top, i.e. y0 − ascent
        # relative to the baseline — placing it at base_row + (y0 −
        # ascent) makes baselines of mixed-font runs coincide.
        base_row = pad + int(round(self._primary_ascent * OVERSAMPLE))

        coverages = np.zeros((_ENSURE_BATCH, os_cell, os_cell), np.float32)
        recs = []
        for key, f, slot, synth in jobs:
            try:
                cell, mw, mh, bx0, adv = rasterize_glyph_cell(
                    f.pil, chr(key & ~self.BOLD_KEY),
                    lambda y0, f=f: base_row + (y0 - f.ascent))
            except Exception:
                # One corrupt glyph outline: release its slot and mark
                # missing (renders '?'), keep the rest of the batch.
                self._release_slot(key, slot)
                self.missing.add(key)
                continue
            if synth:
                cell = self._embolden(cell)
                # The dilation widens the ink by r os-px per side IN
                # PLACE in the cell (the spread margin covers it for
                # sampling, and on-screen growth is already symmetric
                # around the unchanged quad) — only the pen must advance
                # past the wider ink.
                adv += 2 * self._EMBOLDEN_OS_PX
            coverages[len(recs)] = cell
            recs.append((key, slot, mw, mh, bx0, adv))
        if not recs:
            return 0

        enc_small = encode_sdf_cells(coverages, self.device)

        for bi, (key, slot, mw, mh, bx0, adv) in enumerate(recs):
            r, c = divmod(slot, self.COLS)
            u, v_rel = c * CELL, r * CELL
            self.texture[v_rel:v_rel + CELL, u:u + CELL] = enc_small[bi]
            # Slot bookkeeping was reserved in ensure(); only the
            # texture bytes and metrics land here.
            w, h, bearing_x, bearing_y, advance = glyph_cell_metrics(
                mw, mh, bx0, adv)
            self.metrics[key] = np.array(
                [u, self._v_base + v_rel, w, h, bearing_x, bearing_y,
                 advance, 1.0], np.float32)
        return len(recs)

    def _take_slot(self) -> Optional[int]:
        """Next free or RECYCLABLE slot (untouched since the last epoch
        clear — provably unreferenced by any live cache, so recycling it
        needs no cache clearing), or None when every slot is
        protected."""
        for _ in range(self.capacity):
            slot = self._next_slot % self.capacity
            self._next_slot += 1
            old = self._slot_cp[slot]
            if old is None:
                return slot
            if self._slot_gen[slot] <= self._clear_gen:
                # pop, not del: a slot reserved by an ensure() whose
                # rasterize failed has bookkeeping but no metrics row.
                self.metrics.pop(old, None)
                self._cp_slot.pop(old, None)
                self._slot_cp[slot] = None
                return slot
        return None

    # -- queries ----------------------------------------------------------

    def advance(self, cp: int) -> Optional[float]:
        row = self.metrics.get(cp)
        return None if row is None else float(row[6])
