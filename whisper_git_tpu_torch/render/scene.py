"""Scene compiler: laid-out El tree → static-shape draw-command buffers.

The port's own copy of `whisper_git_tpu/render/scene.py` (the two packages
share no module); only `_bucket` differs. Direct children of the root
`stack` become layers; within a layer the rasterizer composites shapes
(rects+segments), then images, then glyphs, so chrome backgrounds cover
lower-layer text while text always tops its own layer.

All buffers are padded to bucketed capacities (padding is inert), and
every command carries its inherited clip rect.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ui.el import El
from ..ui.layout import LayoutNode, TextMeasurer, _wrap_lines
from .atlas import FontAtlas

MAX_LAYERS = 4
_NOCLIP = (-1e6, -1e6, 2e6, 2e6)

# Shape command columns.
S_TYPE, S_A, S_B, S_C, S_D, S_R, S_BW = range(7)
S_FILL = 7   # 7-10 fill rgba
S_BORD = 11  # 11-14 border rgba


_FINE_LADDER = (64, 256, 1024, 4096, 16384, 65536)


def _bucket(n: int, hw_key=None) -> int:
    """Buffer capacity for n commands: 0 for none, else the next rung of
    the fine ladder, past it a multiple of 4096. The reference picks a
    coarser ladder with per-key high-water marks on accelerators to keep
    jit signatures stable; eager PyTorch has no jit, so `hw_key` is
    accepted and unused."""
    if n == 0:
        return 0
    return next((b for b in _FINE_LADDER if n <= b),
                ((n + 4095) // 4096) * 4096)


@dataclass
class LayerBuffers:
    shapes: np.ndarray      # (NS, 16) f32
    shape_clips: np.ndarray  # (NS, 4)
    n_shapes: int
    glyphs: np.ndarray      # (NG, 8) x,y,w,h,u,v,uw,uh
    glyph_colors: np.ndarray  # (NG, 4)
    glyph_clips: np.ndarray  # (NG, 4)
    n_glyphs: int
    images: np.ndarray      # (NI, 8) x,y,w,h,u,v,uw,uh
    image_clips: np.ndarray  # (NI, 4)
    n_images: int
    # Volatile (El.volatile) commands occupy the LAST n_dyn_* rows of the
    # used prefix; the leading static rows are byte-stable across pure
    # scroll frames (the frame cache hashes only them).
    n_dyn_shapes: int = 0
    n_dyn_glyphs: int = 0
    n_dyn_images: int = 0


@dataclass
class Scene:
    layers: list[LayerBuffers]
    width: int
    height: int
    background: tuple
    image_atlas: np.ndarray  # (AH, AW, 4) u8
    stats: dict = field(default_factory=dict)
    windows: list = field(default_factory=list)  # list[WindowPart]

    def inline_windows(self) -> "Scene":
        """Return an equivalent Scene with every recorded scroll window
        spliced back into its layer's buffers (for consumers of the raw
        buffers that don't implement device-resident windows, e.g. the
        mesh-sharded demo path)."""
        if not self.windows:
            return self
        layers = []
        for li, lb in enumerate(self.layers):
            lws = [w for w in self.windows if w.layer == li]
            if not lws:
                layers.append(lb)
                continue
            acc = _LayerAccum(li)
            cursor = (0, 0, 0)
            chrome = SubtreeChunks(
                shapes=lb.shapes[:lb.n_shapes],
                shape_clips=lb.shape_clips[:lb.n_shapes],
                glyphs=lb.glyphs[:lb.n_glyphs],
                glyph_colors=lb.glyph_colors[:lb.n_glyphs],
                glyph_clips=lb.glyph_clips[:lb.n_glyphs],
                images=lb.images[:lb.n_images],
                image_clips=lb.image_clips[:lb.n_images])

            def chrome_slice(a, b):
                return SubtreeChunks(
                    shapes=chrome.shapes[a[0]:b[0]],
                    shape_clips=chrome.shape_clips[a[0]:b[0]],
                    glyphs=chrome.glyphs[a[1]:b[1]],
                    glyph_colors=chrome.glyph_colors[a[1]:b[1]],
                    glyph_clips=chrome.glyph_clips[a[1]:b[1]],
                    images=chrome.images[a[2]:b[2]],
                    image_clips=chrome.image_clips[a[2]:b[2]])

            end = (lb.n_shapes, lb.n_glyphs, lb.n_images)
            for w in lws:
                acc.splice(chrome_slice(cursor, w.pos), 0.0, 0.0, _NOCLIP)
                acc.splice(w.comp, w.dx, w.dy, w.clip)
                cursor = w.pos
            acc.splice(chrome_slice(cursor, end), 0.0, 0.0, _NOCLIP)
            layers.append(SceneCompiler._pack(acc, li))
        return Scene(layers=layers, width=self.width, height=self.height,
                     background=self.background,
                     image_atlas=self.image_atlas, stats=self.stats,
                     windows=[])

    def scaled(self, s: float, out_w: int | None = None,
               out_h: int | None = None) -> "Scene":
        """True-HiDPI scene: every command's GEOMETRY (positions, sizes,
        radii, stroke widths, clips) multiplied into physical pixels while
        atlas coordinates stay untouched — the rasterizer then samples
        the 44 px-glyph SDF atlas and analytic shape SDFs at physical
        resolution, so edges are crisp at any scale (reference:
        README.md:13 "HiDPI/4K aware", src/screenshot_mode.rs:38 scale).
        Layout and hit-testing stay in logical units, exactly like the
        reference's winit logical-coordinate model.

        Commands are affine in their geometry columns, so scaling the
        compiled buffers is identical to compiling a scaled layout."""
        if s == 1.0 and out_w is None and out_h is None:
            return self
        base = self.inline_windows()
        layers = []
        for lb in base.layers:
            shapes = lb.shapes.copy()
            shapes[:, 1:7] *= s      # rect x,y,w,h,r,bw / seg x0,y0,x1,y1,hw
            glyphs = lb.glyphs.copy()
            glyphs[:, 0:4] *= s      # x,y,w,h (u,v,uw,uh are atlas px)
            images = lb.images.copy()
            images[:, 0:4] *= s
            layers.append(LayerBuffers(
                shapes, lb.shape_clips * s, lb.n_shapes,
                glyphs, lb.glyph_colors, lb.glyph_clips * s, lb.n_glyphs,
                images, lb.image_clips * s, lb.n_images,
                n_dyn_shapes=lb.n_dyn_shapes, n_dyn_glyphs=lb.n_dyn_glyphs,
                n_dyn_images=lb.n_dyn_images))
        return Scene(layers=layers,
                     width=out_w if out_w is not None
                     else int(round(base.width * s)),
                     height=out_h if out_h is not None
                     else int(round(base.height * s)),
                     background=base.background,
                     image_atlas=base.image_atlas, stats=base.stats,
                     windows=[])


class _LayerAccum:
    """Ordered command accumulator. Everything is chunk streams so cached
    subtrees splice in as bulk numpy arrays without breaking paint order;
    singleton appends buffer in Python lists and flush to a chunk
    on demand."""

    def __init__(self, layer_index: int = 0, track_dyn: bool = True):
        self.layer_index = layer_index
        # Volatile commands accumulate separately and pack at the layer's
        # tail (they are topmost at their pixels by contract, see El).
        self.dyn: "_LayerAccum | None" = (
            _LayerAccum(layer_index, track_dyn=False) if track_dyn else None)
        self._shape_rows: list[list[float]] = []
        self._shape_clip_rows: list[tuple] = []
        self.shape_chunks: list[np.ndarray] = []        # (n, 16)
        self.shape_clip_chunks: list[np.ndarray] = []   # (n, 4)
        self.glyph_chunks: list[np.ndarray] = []        # (n, 8)
        self.glyph_color_chunks: list[np.ndarray] = []  # (n, 4)
        self.glyph_clip_chunks: list[np.ndarray] = []   # (n, 4)
        self._image_rows: list[list[float]] = []
        self._image_clip_rows: list[tuple] = []
        self.image_chunks: list[np.ndarray] = []        # (n, 8)
        self.image_clip_chunks: list[np.ndarray] = []   # (n, 4)

    # -- flushing ------------------------------------------------------------

    def _flush_shapes(self):
        if self._shape_rows:
            self.shape_chunks.append(
                np.asarray(self._shape_rows, np.float32))
            self.shape_clip_chunks.append(
                np.asarray(self._shape_clip_rows, np.float32))
            self._shape_rows = []
            self._shape_clip_rows = []

    def _flush_images(self):
        if self._image_rows:
            self.image_chunks.append(np.asarray(self._image_rows, np.float32))
            self.image_clip_chunks.append(
                np.asarray(self._image_clip_rows, np.float32))
            self._image_rows = []
            self._image_clip_rows = []

    def flush(self):
        self._flush_shapes()
        self._flush_images()

    @property
    def n_shapes(self) -> int:
        return (len(self._shape_rows)
                + sum(c.shape[0] for c in self.shape_chunks))

    @property
    def n_glyphs(self) -> int:
        return sum(c.shape[0] for c in self.glyph_chunks)

    @property
    def n_images(self) -> int:
        return (len(self._image_rows)
                + sum(c.shape[0] for c in self.image_chunks))

    # -- appends -------------------------------------------------------------

    def rect(self, x, y, w, h, radius, fill, border, border_w, clip):
        f = fill or (0, 0, 0, 0)
        b = border or (0, 0, 0, 0)
        self._shape_rows.append(
            [0.0, x, y, w, h, radius, border_w if border else 0.0,
             f[0], f[1], f[2], f[3] if len(f) > 3 else 1.0,
             b[0], b[1], b[2], b[3] if len(b) > 3 else 1.0, 0.0])
        self._shape_clip_rows.append(clip)

    def segment(self, x0, y0, x1, y1, width, color, clip):
        c = color
        self._shape_rows.append(
            [1.0, x0, y0, x1, y1, width * 0.5, 0.0,
             c[0], c[1], c[2], c[3] if len(c) > 3 else 1.0,
             0, 0, 0, 0, 0.0])
        self._shape_clip_rows.append(clip)

    def glyph_run(self, quads: np.ndarray, color, clip):
        """quads: (n, 8) x,y,w,h,u,v,uw,uh for one text run."""
        n = quads.shape[0]
        if n == 0:
            return
        self.glyph_chunks.append(quads.astype(np.float32, copy=False))
        self.glyph_color_chunks.append(
            np.broadcast_to(np.asarray(color, np.float32), (n, 4)))
        self.glyph_clip_chunks.append(
            np.broadcast_to(np.asarray(clip, np.float32), (n, 4)))

    def image(self, x, y, w, h, u, v, uw, uh, clip):
        self._image_rows.append([x, y, w, h, u, v, uw, uh])
        self._image_clip_rows.append(clip)

    # -- bulk splice (cached subtrees) ---------------------------------------

    def splice(self, chunks: "SubtreeChunks", dx: float, dy: float, clip):
        # Shifted-array memo: a chrome panel splices at the SAME
        # (dx, dy, clip) frame after frame, so the translated command
        # arrays recur exactly — reuse them instead of re-copying and
        # re-shifting every frame (keyed by the chunk's content uid; the
        # arrays are append-only inputs to _pack's concatenate, never
        # mutated). Measured: the splice pass was the single largest
        # steady-state compile cost before this memo.
        key = (chunks.uid, dx, dy, clip)
        hit = _SPLICE_SHIFT_CACHE.get(key)
        # Scroll-window comps are huge AND splice at a new dy every
        # frame — caching them would fill the memo with megabyte
        # entries that never recur. Chrome panels (the win) are small.
        cacheable = (chunks.shapes.shape[0] + chunks.glyphs.shape[0]
                     + chunks.images.shape[0]) <= 4000
        if hit is None:
            cx0, cy0, cx1, cy1 = clip
            shift4 = np.asarray([dx, dy, dx, dy], np.float32)

            def shifted_clips(rel: np.ndarray) -> np.ndarray:
                out = rel + shift4
                np.maximum(out[:, :2], (cx0, cy0), out=out[:, :2])
                np.minimum(out[:, 2:], (cx1, cy1), out=out[:, 2:])
                return out

            s = sc = g = gc = im = imc = None
            if chunks.shapes.shape[0]:
                s = chunks.shapes.copy()
                s[:, 1] += dx
                s[:, 2] += dy
                seg = s[:, 0] == 1.0
                s[seg, 3] += dx
                s[seg, 4] += dy
                sc = shifted_clips(chunks.shape_clips)
            if chunks.glyphs.shape[0]:
                g = chunks.glyphs.copy()
                g[:, 0] += dx
                g[:, 1] += dy
                gc = shifted_clips(chunks.glyph_clips)
            if chunks.images.shape[0]:
                im = chunks.images.copy()
                im[:, 0] += dx
                im[:, 1] += dy
                imc = shifted_clips(chunks.image_clips)
            hit = (s, sc, g, gc, im, imc)
            if cacheable:
                if len(_SPLICE_SHIFT_CACHE) > 2048:
                    _SPLICE_SHIFT_CACHE.clear()
                _SPLICE_SHIFT_CACHE[key] = hit
        s, sc, g, gc, im, imc = hit
        if s is not None:
            self._flush_shapes()
            self.shape_chunks.append(s)
            self.shape_clip_chunks.append(sc)
        if g is not None:
            self.glyph_chunks.append(g)
            self.glyph_color_chunks.append(chunks.glyph_colors)
            self.glyph_clip_chunks.append(gc)
        if im is not None:
            self._flush_images()
            self.image_chunks.append(im)
            self.image_clip_chunks.append(imc)
        if chunks.dyn is not None:
            # Volatile side: route to this layer's dynamic tail when one
            # is tracked, else inline AFTER the static content so it still
            # paints on top of its own panel.
            (self.dyn if self.dyn is not None else self).splice(
                chunks.dyn, dx, dy, clip)


_CHUNK_UID = [0]
_SPLICE_SHIFT_CACHE: dict = {}


@dataclass
class SubtreeChunks:
    """Origin-relative compiled commands of one cached subtree.

    `dyn` carries the subtree's VOLATILE side (El.volatile descendants)
    as a nested SubtreeChunks: splicing routes it to the target layer's
    dynamic tail, so an animating element inside a memoized panel (e.g.
    the header's pulsing dirty dot) changes only the per-frame dyn blob
    while the static bytes — and every chrome/compose cache keyed on
    them — stay identical across animation phases."""

    shapes: np.ndarray
    shape_clips: np.ndarray
    glyphs: np.ndarray
    glyph_colors: np.ndarray
    glyph_clips: np.ndarray
    images: np.ndarray
    image_clips: np.ndarray
    uid: int = -1  # content identity for device-side blob caching
    dyn: "SubtreeChunks | None" = None

    def __post_init__(self):
        _CHUNK_UID[0] += 1
        self.uid = _CHUNK_UID[0]


@dataclass
class WindowPart:
    """A scroll window recorded for device-resident compositing: the
    window's merged chunks stay cached on the device (window-relative
    coordinates); per frame only (dx, dy, clip) uniforms cross the link
    and the shift happens on-device (see rasterizer.pack_scene)."""

    comp: SubtreeChunks
    layer: int
    dx: float
    dy: float
    clip: tuple
    pos: tuple  # (n_shapes, n_glyphs, n_images) stream position at splice


def _freeze_accum(acc: "_LayerAccum", dx: float, dy: float
                  ) -> SubtreeChunks:
    """Concatenate an accumulator's chunk streams into one origin-relative
    SubtreeChunks, shifting geometry and clips by (dx, dy)."""
    acc.flush()

    def cat(chunks, cols):
        if chunks:
            return np.concatenate(chunks, axis=0)
        return np.zeros((0, cols), np.float32)

    shapes = cat(acc.shape_chunks, 16)
    if shapes.shape[0] and (dx or dy):
        shapes[:, 1] += dx
        shapes[:, 2] += dy
        seg = shapes[:, 0] == 1.0
        shapes[seg, 3] += dx
        shapes[seg, 4] += dy
    glyphs = cat(acc.glyph_chunks, 8)
    if glyphs.shape[0] and (dx or dy):
        glyphs[:, 0] += dx
        glyphs[:, 1] += dy
    images = cat(acc.image_chunks, 8)
    if images.shape[0] and (dx or dy):
        images[:, 0] += dx
        images[:, 1] += dy

    def shift_clips(chunks):
        rel = cat(chunks, 4)
        if rel.shape[0] and (dx or dy):
            rel[:, 0] += dx
            rel[:, 1] += dy
            rel[:, 2] += dx
            rel[:, 3] += dy
        return rel

    return SubtreeChunks(
        shapes=shapes, shape_clips=shift_clips(acc.shape_clip_chunks),
        glyphs=glyphs,
        glyph_colors=cat(acc.glyph_color_chunks, 4),
        glyph_clips=shift_clips(acc.glyph_clip_chunks),
        images=images,
        image_clips=shift_clips(acc.image_clip_chunks))


def _cubic_points(p0, p1, p2, p3, n=10):
    t = np.linspace(0.0, 1.0, n + 1)[:, None]
    p0, p1, p2, p3 = map(np.asarray, (p0, p1, p2, p3))
    mt = 1 - t
    return (mt ** 3 * p0 + 3 * mt ** 2 * t * p1
            + 3 * mt * t ** 2 * p2 + t ** 3 * p3)


class SceneCompiler:
    """Compiles layout trees into Scenes. Holds the font atlases and an
    avatar/image atlas (512×512, 8×8 grid of 64² tiles — reference:
    render_engine.md AvatarRenderer) that persists across frames."""

    IMG_TILE = 64
    IMG_GRID = 8

    def __init__(self, regular: FontAtlas, bold: FontAtlas,
                 bold_v_offset: int = 0):
        self.regular = regular
        self.bold = bold
        # Bold glyph rows sit below the regular rows in the combined texture.
        self.bold_v_offset = bold_v_offset
        n = self.IMG_GRID * self.IMG_TILE
        self.image_atlas = np.zeros((n, n, 4), np.uint8)
        self._image_slots: dict[int, int] = {}  # id(array) -> slot
        # slot -> (key, strong ref). The ref (a) lets recycling evict the
        # DISPLACED image's mapping (else two arrays map to one tile and
        # the older renders as the newer), and (b) pins the array so a
        # GC'd array's id() can't be reused by a different image that
        # would then silently inherit a stale slot.
        self._slot_owner: dict[int, tuple[int, object]] = {}
        self._next_slot = 0
        self.atlas_version = 0  # bumped on writes so device copies refresh
        self._text_cache: dict = {}  # (line, scale, v_off) -> quad template
        self._subtree_cache: dict = {}  # (cache_key, w, h) -> SubtreeChunks
        self._frame_windows: list | None = None  # set during compile()
        # (scroll key, row keys + relative offsets) -> merged SubtreeChunks:
        # a whole visible scroll window splices as ONE bulk add per class
        # while the same row set scrolls (offsets are measured from the
        # first row, so a pure scroll doesn't change the key).
        self._window_cache: dict = {}

    # -- image atlas --------------------------------------------------------

    def _slot_for_image(self, data: np.ndarray) -> tuple[int, int]:
        key = id(data)
        slot = self._image_slots.get(key)
        if slot is None:
            slot = self._next_slot % (self.IMG_GRID * self.IMG_GRID)
            self._next_slot += 1
            displaced = self._slot_owner.get(slot)
            if displaced is not None:
                self._image_slots.pop(displaced[0], None)
            self._image_slots[key] = slot
            self._slot_owner[slot] = (key, data)
            tile = np.asarray(data)
            if tile.shape[:2] != (self.IMG_TILE, self.IMG_TILE):
                from ..ops.image import resize_lanczos
                tile = resize_lanczos(tile, self.IMG_TILE, self.IMG_TILE)
            if tile.shape[2] == 3:
                tile = np.concatenate(
                    [tile, np.full_like(tile[..., :1], 255)], axis=-1)
            r, c = divmod(slot, self.IMG_GRID)
            self.image_atlas[r * self.IMG_TILE:(r + 1) * self.IMG_TILE,
                             c * self.IMG_TILE:(c + 1) * self.IMG_TILE] = tile
            self.atlas_version += 1
        r, c = divmod(slot, self.IMG_GRID)
        return c * self.IMG_TILE, r * self.IMG_TILE

    # -- text ---------------------------------------------------------------

    def _emit_text(self, acc: _LayerAccum, node: LayoutNode, clip):
        el = node.el
        atlas = self.bold if el.bold else self.regular
        color = el.color or (0.973, 0.98, 0.988, 1.0)
        if el.opacity < 1.0:
            color = (*color[:3], color[3] * el.opacity)
        v_off = self.bold_v_offset if el.bold else 0
        scale = el.font_size / atlas.font_px
        lh = atlas.line_height(el.font_size)
        cx0, cy0, cx1, cy1 = clip
        finite_clip = (cx1 - cx0) < 1e5  # cached subtrees use _NOCLIP
        if el.wrap:
            lines = _wrap_lines(el.text, node.w, el.font_size, el.bold,
                                _AtlasShim(atlas))
        else:
            lines = el.text.split("\n")
            if el.ellipsis and finite_clip:
                # Elide to the CLIP edge, not node.w — a flex child's
                # node.w is its intrinsic (possibly overflowing) width;
                # the clip is what actually cuts pixels.
                avail = cx1 - node.x
                lines = [atlas.elide(line, el.font_size, avail)
                         for line in lines]
        y = node.y
        for line in lines:
            if line:
                quads = self._run_template(atlas, line, scale, v_off)
                if quads.shape[0]:
                    quads = quads.copy()
                    quads[:, 0] += node.x
                    quads[:, 1] += y
                    if finite_clip and quads.shape[0] > 8:
                        # Cull glyphs wholly outside the clip: one
                        # 24k-char minified line otherwise emits tens of
                        # thousands of invisible quads into the frame's
                        # command tables (clip-rect coverage already
                        # guarantees they contribute no pixels).
                        keep = ((quads[:, 0] < cx1)
                                & (quads[:, 0] + quads[:, 2] > cx0)
                                & (quads[:, 1] < cy1)
                                & (quads[:, 1] + quads[:, 3] > cy0))
                        if not keep.all():
                            quads = quads[keep]
                    if quads.shape[0]:
                        acc.glyph_run(quads, color, clip)
            y += lh

    def _run_template(self, atlas: FontAtlas, line: str, scale: float,
                      v_off: int) -> np.ndarray:
        """Origin-relative glyph quads for a text run, memoized — the view
        rebuilds the same strings every frame, so steady state is a dict
        hit + one (n,8) copy. Runs that used the fallback bank revalidate
        against its eviction counter (a recycled cell may hold a
        different glyph now)."""
        key = (line, scale, v_off)
        hit = self._text_cache.get(key)
        if hit is not None:
            tpl, uses_bank, evictions_seen = hit
            if not uses_bank or (atlas.fallback is not None
                                 and atlas.fallback.evictions
                                 == evictions_seen):
                return tpl
        m, abs_v, cps, uses_bank, deferred = atlas.metric_rows(line)
        adv = m[:, 6] * scale
        pens = np.concatenate(([0.0], np.cumsum(adv[:-1])))
        quads = np.empty((len(cps), 8), np.float32)
        quads[:, 0] = pens + m[:, 4] * scale
        # Atlas cells are baseline-aligned (atlas.FontAtlas.band_*): every
        # glyph samples the same cell-wide vertical band, so y/h/uh are
        # run constants — the precondition for run-batched compositing.
        quads[:, 1] = atlas.band_top * scale
        quads[:, 2] = m[:, 2] * scale
        quads[:, 3] = atlas.band_h * scale
        quads[:, 4] = m[:, 0]
        # Bank rows carry an ABSOLUTE v (the bank sits below both resident
        # atlases in the combined texture) — no bold v-offset for them.
        quads[:, 5] = m[:, 1] + np.where(abs_v, 0.0, float(v_off))
        quads[:, 6] = m[:, 2]
        quads[:, 7] = atlas.band_h
        # Skip spaces/control chars; out-of-coverage codepoints carry
        # either bank metrics or the resident '?' fallback.
        tpl = np.ascontiguousarray(quads[cps > 32])
        if deferred:
            # Some glyph had no bank slot this frame and rendered '?' —
            # don't cache; the retry next frame picks up the real cell.
            return tpl
        if len(self._text_cache) > 50_000:
            self._text_cache.clear()
        bank = atlas.fallback
        self._text_cache[key] = (
            tpl, uses_bank, bank.evictions if bank is not None else 0)
        return tpl

    # -- walk ---------------------------------------------------------------

    def _emit_node(self, node: LayoutNode, acc: _LayerAccum, clip) -> None:
        el = node.el
        if el.shadow:
            acc.rect(node.x + 3, node.y + 4, node.w, node.h,
                     el.radius + 2, (0, 0, 0, 0.35), None, 0.0, clip)
        if el.fill is not None or el.border is not None:
            fill = el.fill
            if fill is not None and el.opacity < 1.0:
                fill = (*fill[:3],
                        (fill[3] if len(fill) > 3 else 1.0) * el.opacity)
            acc.rect(node.x, node.y, node.w, node.h, el.radius,
                     fill, el.border, el.border_width, clip)
        if el.kind == "text" and el.text:
            self._emit_text(acc, node, clip)
        elif el.kind == "image" and el.image_data is not None:
            u, v = self._slot_for_image(el.image_data)
            acc.image(node.x, node.y, node.w, node.h,
                      u, v, self.IMG_TILE, self.IMG_TILE, clip)
        for prim in el.prims:
            self._emit_prim(acc, prim, node.x, node.y, clip)

    def _walk_into(self, node: LayoutNode, acc: _LayerAccum, clip,
                   bounds, dyn: bool = False) -> None:
        """Recursive emit of one subtree into one accumulator. Volatile
        subtrees route to the layer's dynamic tail accumulator."""
        el = node.el
        cx0, cy0, cx1, cy1 = clip
        if (node.x > cx1 or node.y > cy1
                or node.x + node.w < cx0 or node.y + node.h < cy0):
            return
        if bounds is not None:
            W, H = bounds
            if (node.x > W or node.y > H
                    or node.x + node.w < 0 or node.y + node.h < 0):
                return
        if el.volatile and acc.dyn is not None:
            dyn = True
        target = acc.dyn if (dyn and acc.dyn is not None) else acc
        if el.cache_key is not None and bounds is not None:
            chunks = self._subtree_chunks(node)
            target.splice(chunks, node.x, node.y, clip)
            return
        self._emit_node(node, target, clip)
        child_clip = clip
        if el.clip:
            child_clip = (max(cx0, node.x), max(cy0, node.y),
                          min(cx1, node.x + node.w),
                          min(cy1, node.y + node.h))
        if (el.kind == "scroll" and bounds is not None and node.children
                and all(c.el.cache_key is not None for c in node.children)
                and not dyn):
            self._splice_scroll_window(node, acc, child_clip)
            return
        for c in node.children:
            self._walk_into(c, acc, child_clip, bounds, dyn)

    def _subtree_chunks(self, node: LayoutNode) -> "SubtreeChunks":
        """Compile a cached subtree to origin-relative chunks, memoized by
        (cache_key, size). Steady-state scrolling replays rows as four
        numpy adds instead of a full walk."""
        key = (node.el.cache_key, round(node.w, 1), round(node.h, 1))
        hit = self._subtree_cache.pop(key, None)
        if hit is not None:
            self._subtree_cache[key] = hit   # LRU re-insert
            return hit
        # track_dyn=True: volatile descendants freeze into the chunks'
        # `dyn` side, which splice() routes to the target layer's dynamic
        # tail — so an animating element inside a memoized panel leaves
        # the static bytes (and every cache keyed on them) unchanged.
        acc = _LayerAccum()
        # bounds=None disables viewport culling and nested cache lookups
        # (a cached subtree is compiled in full, exactly once).
        self._walk_into(node, acc, _NOCLIP, None)
        chunks = _freeze_accum(acc, -node.x, -node.y)
        if acc.dyn is not None:
            d = _freeze_accum(acc.dyn, -node.x, -node.y)
            if d.shapes.shape[0] or d.glyphs.shape[0] \
                    or d.images.shape[0]:
                chunks.dyn = d
        # LRU cap (see ui/layout._SUBTREE_LAYOUT_CACHE): minute-
        # bucketed row keys mint fresh entries forever in a session.
        while len(self._subtree_cache) > 8192:
            self._subtree_cache.pop(next(iter(self._subtree_cache)))
        self._subtree_cache[key] = chunks
        return chunks

    def _splice_scroll_window(self, node: LayoutNode, acc: _LayerAccum,
                              clip) -> None:
        """Splice an entire visible scroll window of cache-keyed rows as
        one merged chunk set. Keyed off the first row, so steady-state
        scrolling hits until the visible row SET changes."""
        kids = node.children
        y0 = kids[0].y
        key = (node.el.key,
               tuple((c.el.cache_key, round(c.x - node.x, 1),
                      round(c.y - y0, 1), round(c.w, 1), round(c.h, 1))
                     for c in kids))
        comp = self._window_cache.get(key)
        if comp is None:
            # track_dyn=False: a volatile element inside a scroll ROW
            # inlines into the window comp (device-resident windows have
            # no dyn side; the row's cache_key must then carry its phase).
            acc2 = _LayerAccum(track_dyn=False)
            for c in kids:
                ch = self._subtree_chunks(c)
                # _NOCLIP: per-row internal clips stay row-relative; the
                # viewport clamp happens at the final splice below.
                acc2.splice(ch, c.x - node.x, c.y - y0, _NOCLIP)
            comp = _freeze_accum(acc2, 0.0, 0.0)
            if len(self._window_cache) > 512:
                self._window_cache.clear()
            self._window_cache[key] = comp
        if self._frame_windows is not None and len(self._frame_windows) < 4:
            # Device-resident path: record the window instead of splicing.
            # The rasterizer keeps the (window-relative) blob cached on the
            # device keyed by comp.uid; only (dx, dy, clip) cross per frame.
            self._frame_windows.append(WindowPart(
                comp=comp, layer=acc.layer_index, dx=node.x, dy=y0,
                clip=tuple(float(c) for c in clip),
                pos=(acc.n_shapes, acc.n_glyphs, acc.n_images)))
            return
        acc.splice(comp, node.x, y0, clip)

    def compile(self, root: LayoutNode, viewport: tuple[int, int],
                background: tuple) -> Scene:
        bank = self.regular.fallback
        if bank is not None:
            bank.begin_frame()  # advances the slot-protection window
        if bank is not None and bank.evictions != getattr(
                self, "_bank_evictions_seen", 0):
            # A bank slot was recycled: cached quads anywhere may point at
            # a cell that now holds a DIFFERENT glyph, and the device-side
            # content-addressed caches key on command bytes (which could
            # collide across eviction epochs). Drop everything; capacity
            # (192 cells) makes this rare.
            self._bank_evictions_seen = bank.evictions
            self._text_cache.clear()
            self._subtree_cache.clear()
            self._window_cache.clear()
            from . import compose as _compose, frame as _frame
            _frame.clear_caches()
            _compose.clear_caches()
        W, H = int(viewport[0]), int(viewport[1])
        accums = [_LayerAccum(li) for li in range(MAX_LAYERS)]
        stats = {"clipped_out": 0}
        bounds = (W, H)
        self._frame_windows = []

        if root.el.kind == "stack":
            if root.el.fill is not None:
                accums[0].rect(root.x, root.y, root.w, root.h, 0.0,
                               root.el.fill, None, 0.0, _NOCLIP)
            for i, child in enumerate(root.children):
                self._walk_into(child, accums[min(i, MAX_LAYERS - 1)],
                                _NOCLIP, bounds)
        else:
            self._walk_into(root, accums[0], _NOCLIP, bounds)

        layers = []
        for li, acc in enumerate(accums):
            layers.append(self._pack(acc, li))
        scene = Scene(layers=layers, width=W, height=H,
                      background=background, image_atlas=self.image_atlas,
                      stats=stats, windows=self._frame_windows)
        self._frame_windows = None
        return scene

    def _emit_prim(self, acc: _LayerAccum, prim, ox, oy, clip):
        kind = prim[0]
        if kind == "vline":
            _, x, y0, y1, w, color = prim
            acc.segment(ox + x, oy + y0, ox + x, oy + y1, w, color, clip)
        elif kind == "cubic":
            _, p0, p1, p2, p3, w, color = prim
            pts = _cubic_points(p0, p1, p2, p3, n=10) + np.array([ox, oy])
            for i in range(len(pts) - 1):
                acc.segment(pts[i][0], pts[i][1], pts[i + 1][0], pts[i + 1][1],
                            w, color, clip)
        elif kind == "circle":
            _, cx, cy, r, color = prim
            acc.rect(ox + cx - r, oy + cy - r, 2 * r, 2 * r, r,
                     color, None, 0.0, clip)

    @staticmethod
    def _pack(acc: _LayerAccum, li: int = 0) -> LayerBuffers:
        acc.flush()
        dyn = acc.dyn
        if dyn is not None:
            dyn.flush()
        nds = dyn.n_shapes if dyn else 0
        ndg = dyn.n_glyphs if dyn else 0
        ndi = dyn.n_images if dyn else 0
        ns, ng, ni = (acc.n_shapes + nds, acc.n_glyphs + ndg,
                      acc.n_images + ndi)
        ns_cap = _bucket(ns, (li, "s"))
        ng_cap = _bucket(ng, (li, "g"))
        ni_cap = _bucket(ni, (li, "i"))
        shapes = np.zeros((ns_cap, 16), np.float32)
        shape_clips = np.full((ns_cap, 4), _NOCLIP, np.float32)
        if ns:
            shapes[:ns] = np.concatenate(
                acc.shape_chunks + (dyn.shape_chunks if dyn else []), axis=0)
            shape_clips[:ns] = np.concatenate(
                acc.shape_clip_chunks + (dyn.shape_clip_chunks if dyn else []),
                axis=0)
        glyphs = np.zeros((ng_cap, 8), np.float32)
        glyph_colors = np.zeros((ng_cap, 4), np.float32)
        glyph_clips = np.full((ng_cap, 4), _NOCLIP, np.float32)
        if ng:
            glyphs[:ng] = np.concatenate(
                acc.glyph_chunks + (dyn.glyph_chunks if dyn else []), axis=0)
            glyph_colors[:ng] = np.concatenate(
                acc.glyph_color_chunks
                + (dyn.glyph_color_chunks if dyn else []), axis=0)
            glyph_clips[:ng] = np.concatenate(
                acc.glyph_clip_chunks
                + (dyn.glyph_clip_chunks if dyn else []), axis=0)
        images = np.zeros((ni_cap, 8), np.float32)
        image_clips = np.full((ni_cap, 4), _NOCLIP, np.float32)
        if ni:
            images[:ni] = np.concatenate(
                acc.image_chunks + (dyn.image_chunks if dyn else []), axis=0)
            image_clips[:ni] = np.concatenate(
                acc.image_clip_chunks
                + (dyn.image_clip_chunks if dyn else []), axis=0)
        return LayerBuffers(shapes, shape_clips, ns, glyphs, glyph_colors,
                            glyph_clips, ng, images, image_clips, ni,
                            n_dyn_shapes=nds, n_dyn_glyphs=ndg,
                            n_dyn_images=ndi)


class _AtlasShim(TextMeasurer):
    def __init__(self, atlas: FontAtlas):
        self.atlas = atlas

    def width(self, s: str, size: float, bold: bool = False) -> float:
        return self.atlas.measure(s, size)

    def height(self, size: float) -> float:
        return self.atlas.line_height(size)
