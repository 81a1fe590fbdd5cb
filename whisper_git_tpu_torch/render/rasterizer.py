"""The frame entry points, and the packed frame path: host binning in
numpy, device unpack in torch, tiles rasterized by
`raster_kernel.render_tiles`.

Counterpart of `whisper_git_tpu/render/rasterizer.py`. The host half
(`pack_scene` and its helpers) is the reference's numpy code with the
fine bucket ladder, and its output is byte-equal to the reference's. The
wire format is the reference's too (`wire.py` owns it): one i32 blob per
frame whose i16 half carries every command table quantized to fixed point,
and one cached i16 blob per scroll window. The device half de-quantizes
the blobs, shifts scroll windows into screen space and concatenates each
layer's tables (plain torch ops), then runs the tile kernel. A scene
over MAX_PACKED_PX, which the i16 wire format cannot hold, skips it:
`_render_scene_f32_device` splices its windows inline, bins its plain f32
tables on the host and runs the same kernel.

Frame model: for each layer, shapes, then image quads, then glyph quads,
composited per 64×128 tile over the commands binned to that tile.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tracing import COUNTERS, span
from . import wire as W
from .raster_kernel import TILE_H, TILE_W, render_tiles
from .scene import Scene, _bucket
from .transfer import readback, upload

K_SHAPES = 256
K_GLYPHS = 512
K_IMAGES = 32

# i16 wire-format ceiling: screen geometry quantizes at 1/8 px, so any
# coordinate beyond ±4095.875 px would clamp. Larger scenes (5K and 8K
# screenshots) take the unquantized f32 path, `_render_scene_f32_device`.
MAX_PACKED_PX = 4095


# ---------------------------------------------------------------------------
# Host binning (numpy; byte-equal to the reference).
# ---------------------------------------------------------------------------

def _k_trim(occ: int, cap: int) -> int:
    """Bin width for a per-tile occupancy of `occ`: the next power of two
    from 8, at most `cap`."""
    k = 8
    while k < occ:
        k *= 2
    return min(k, cap)


def _shape_boxes(shapes: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros((0, 4), np.float32)
    s = shapes[:n]
    is_seg = s[:, 0] == 1.0
    pad = np.where(is_seg, s[:, 5] + 1.5, 1.5)
    x0 = np.where(is_seg, np.minimum(s[:, 1], s[:, 3]), s[:, 1]) - pad
    y0 = np.where(is_seg, np.minimum(s[:, 2], s[:, 4]), s[:, 2]) - pad
    x1 = np.where(is_seg, np.maximum(s[:, 1], s[:, 3]), s[:, 1] + s[:, 3]) + pad
    y1 = np.where(is_seg, np.maximum(s[:, 2], s[:, 4]), s[:, 2] + s[:, 4]) + pad
    return np.stack([x0, y0, x1, y1], axis=1)


def _quad_boxes(quads: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros((0, 4), np.float32)
    q = quads[:n]
    return np.stack([q[:, 0], q[:, 1], q[:, 0] + q[:, 2], q[:, 1] + q[:, 3]],
                    axis=1)


# Scroll windows: a window's merged command chunks (window-relative
# coordinates) are quantized once per content change and cached on the
# device; per frame only an 8-value row (dx, dy, clip) and the merged tile
# bins ride in the frame blob, and the shift runs on the device.
_WIN_HOST_CACHE: dict = {}  # comp.uid -> dict(caps, blob, boxes, ns)
_WIN_DEV_CACHE: dict = {}   # (comp.uid, caps, device) -> device tensor

_CLS_KCAP = {0: K_SHAPES, 1: K_GLYPHS, 2: K_IMAGES}


def _window_caps(w, slot: int) -> tuple:
    comp = w.comp
    return (_bucket(comp.shapes.shape[0], ("win", w.layer, slot, "s")),
            _bucket(comp.glyphs.shape[0], ("win", w.layer, slot, "g")),
            _bucket(comp.images.shape[0], ("win", w.layer, slot, "i")))


def _intersect_boxes(boxes: np.ndarray, clips: np.ndarray) -> np.ndarray:
    """Effective bounding boxes: geometry ∩ per-command clip."""
    if boxes.shape[0] == 0:
        return boxes
    return np.stack([np.maximum(boxes[:, 0], clips[:, 0]),
                     np.maximum(boxes[:, 1], clips[:, 1]),
                     np.minimum(boxes[:, 2], clips[:, 2]),
                     np.minimum(boxes[:, 3], clips[:, 3])], axis=1)


def _window_artifacts(w, caps: tuple) -> dict:
    """Quantized i16 blob + per-class effective boxes for one window,
    cached by content identity (comp.uid)."""
    comp = w.comp
    hit = _WIN_HOST_CACHE.get(comp.uid)
    if hit is not None and hit["caps"] == caps:
        return hit
    ns = (comp.shapes.shape[0], comp.glyphs.shape[0], comp.images.shape[0])
    entry = {
        "caps": caps, "blob": W.quantize(W.parts(comp), ns, caps),
        "boxes": (
            _intersect_boxes(_shape_boxes(comp.shapes, ns[0]),
                             comp.shape_clips),
            _intersect_boxes(_quad_boxes(comp.glyphs, ns[1]),
                             comp.glyph_clips),
            _intersect_boxes(_quad_boxes(comp.images, ns[2]),
                             comp.image_clips)),
        "ns": ns,
    }
    if len(_WIN_HOST_CACHE) > 32:
        _WIN_HOST_CACHE.clear()
    _WIN_HOST_CACHE[comp.uid] = entry
    return entry


def _window_space_bins(entry: dict, ci: int, dx: float, clip: tuple,
                       tiles_x: int):
    """A window's tile bins in WINDOW-relative tile rows, cached per
    content + dx + clip. Returns {"row0", "all": (WR, tx, kA),
    "starts": (WR, tx, kS)} of window-local command indices, or None if
    the class is empty. `all[r]` holds every command intersecting window
    tile row r (submission order); `starts[r]` only those whose topmost
    tile row is r, so a screen tile row covering window rows (a, a+1)
    bins as all[a] + starts[a+1]."""
    key = (ci, round(dx * 8.0), tuple(round(c * 4.0) for c in clip),
           tiles_x)
    cache = entry.setdefault("wbins", {})
    if key in cache:
        return cache[key]
    boxes = entry["boxes"][ci]
    n = boxes.shape[0]
    out = None
    if n:
        x0 = np.maximum(boxes[:, 0] + dx, clip[0])
        x1 = np.minimum(boxes[:, 2] + dx, clip[2])
        y0, y1 = boxes[:, 1], boxes[:, 3]
        keep = (x1 >= x0) & (y1 >= y0)
        if keep.any():
            idx = np.arange(n, dtype=np.int64)[keep]
            tx0 = np.clip((x0[keep] // TILE_W).astype(np.int64), 0,
                          tiles_x - 1)
            tx1 = np.clip((x1[keep] // TILE_W).astype(np.int64), 0,
                          tiles_x - 1)
            ty0 = np.floor(y0[keep] / TILE_H).astype(np.int64)
            ty1 = np.floor(y1[keep] / TILE_H).astype(np.int64)
            row0 = int(ty0.min())
            ty0 -= row0
            ty1 -= row0
            WR = int(ty1.max()) + 1
            sx = tx1 - tx0 + 1
            sy = ty1 - ty0 + 1
            reps = sx * sy
            total = int(reps.sum())
            cmds = np.repeat(idx, reps)
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(reps) - reps, reps)
            rsx = np.repeat(sx, reps)
            dyy, dxx = offs // rsx, offs % rsx
            rows = np.repeat(ty0, reps) + dyy
            cells = rows * tiles_x + np.repeat(tx0, reps) + dxx
            starts = dyy == 0

            def scatter(cells_s, cmds_s, ncells):
                order = np.argsort(cells_s, kind="stable")
                cells_s, cmds_s = cells_s[order], cmds_s[order]
                counts = np.bincount(cells_s, minlength=ncells)
                st = np.concatenate(([0], np.cumsum(counts[:-1])))
                rank = np.arange(len(cells_s)) - st[cells_s]
                kk = max(int(counts.max()), 1)
                binsx = np.full((ncells, kk), -1, np.int32)
                binsx[cells_s, rank] = cmds_s.astype(np.int32)
                return binsx

            ncells = WR * tiles_x
            out = {
                "row0": row0,
                "all": scatter(cells, cmds, ncells).reshape(WR, tiles_x, -1),
                "starts": scatter(cells[starts], cmds[starts], ncells
                                  ).reshape(WR, tiles_x, -1),
            }
    cache[key] = out
    return out


def _gather_window_rows(arr: np.ndarray, a: np.ndarray) -> np.ndarray:
    """arr (WR, tx, k); a (ty,) row indices (may be out of range → -1)."""
    WR = arr.shape[0]
    av = np.clip(a, 0, WR - 1)
    out = arr[av].copy()
    out[(a < 0) | (a >= WR)] = -1
    return out


def _merged_window_bins(wb: dict, dy: float, tiles_y: int, tiles_x: int,
                        base: int, boxes: np.ndarray) -> np.ndarray:
    """Per-frame window bins: gather the two window tile rows each screen
    tile row overlaps, drop entries whose screen row span misses the tile
    row, and restore submission order per tile. Returns (T, k) indices
    into the layer's concatenated tables (window rows start at `base`)."""
    r = np.arange(tiles_y, dtype=np.int64)
    a = np.floor((r * TILE_H - dy) / TILE_H).astype(np.int64) - wb["row0"]
    A = _gather_window_rows(wb["all"], a)
    B = _gather_window_rows(wb["starts"], a + 1)
    m = np.concatenate([A, B], axis=2).reshape(tiles_y * tiles_x, -1)
    ty0c = np.floor((boxes[:, 1] + dy) / TILE_H).astype(np.int64)
    ty1c = np.floor((boxes[:, 3] + dy) / TILE_H).astype(np.int64)
    rows = np.repeat(r, tiles_x)[:, None]
    mv = m >= 0
    mi = np.where(mv, m, 0)
    valid = mv & (ty0c[mi] <= rows) & (ty1c[mi] >= rows)
    m = np.where(valid, m, np.int32(2 ** 31 - 1))
    m.sort(axis=1)
    kmax = int(valid.sum(axis=1).max()) if m.size else 0
    m = m[:, :max(kmax, 1)]
    return np.where(m < 2 ** 31 - 1, m + base, -1)


def _interleave_bins(chrome_bins: np.ndarray, win_blocks: list,
                     kcap: int) -> np.ndarray:
    """Merge chrome bins with window bin blocks in stream order.
    win_blocks: [(bins (T, kw), pos)], pos being the chrome stream index
    the window was recorded at: chrome commands with index < pos composite
    before the window, the rest after; padding (-1) sinks to the end."""
    poss = np.asarray([p for _, p in win_blocks], np.int64)
    parts = [chrome_bins] + [b for b, _ in win_blocks]
    merged = np.concatenate(parts, axis=1)
    kc = chrome_bins.shape[1]
    keys = np.empty(merged.shape, np.int64)
    ck = np.searchsorted(poss, chrome_bins, side="right") * 2
    keys[:, :kc] = ck
    off = kc
    for wi, (b, _) in enumerate(win_blocks):
        keys[:, off:off + b.shape[1]] = 2 * wi + 1
        off += b.shape[1]
    keys[merged < 0] = 1 << 40
    order = np.argsort(keys, axis=1, kind="stable")
    merged = np.take_along_axis(merged, order, axis=1)
    occ = int((merged >= 0).sum(axis=1).max()) if merged.size else 0
    k_used = _k_trim(occ, kcap)
    return merged[:, :k_used]


def _bin_indexed(b: np.ndarray, cmd_ids: np.ndarray, tiles_y: int,
                 tiles_x: int, k: int) -> tuple[np.ndarray, int]:
    """Core binning: boxes (in submission order) + the command-table index
    each box refers to → (T, k_used) bins of indices, plus overflow."""
    T = tiles_y * tiles_x
    n = b.shape[0]
    if n == 0:
        return np.full((T, 8), -1, np.int32), 0
    tx0 = np.clip((b[:, 0] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    ty0 = np.clip((b[:, 1] // TILE_H).astype(np.int64), 0, tiles_y - 1)
    tx1 = np.clip((b[:, 2] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    ty1 = np.clip((b[:, 3] // TILE_H).astype(np.int64), 0, tiles_y - 1)
    keep = ~((b[:, 2] < 0) | (b[:, 3] < 0)
             | (b[:, 0] > tiles_x * TILE_W) | (b[:, 1] > tiles_y * TILE_H)
             | (b[:, 2] < b[:, 0]) | (b[:, 3] < b[:, 1]))
    if not keep.any():
        return np.full((T, 8), -1, np.int32), 0
    idx = cmd_ids[keep].astype(np.int64)
    sx = (tx1 - tx0 + 1)[keep]
    sy = (ty1 - ty0 + 1)[keep]
    # Ragged span expansion: one (tile, command) pair per covered tile.
    reps = sx * sy
    total = int(reps.sum())
    cmds_all = np.repeat(idx, reps)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps)
    rsx = np.repeat(sx, reps)
    dy, dx = offs // rsx, offs % rsx
    tiles_all = ((np.repeat(ty0[keep], reps) + dy) * tiles_x
                 + np.repeat(tx0[keep], reps) + dx)
    # A stable sort by tile keeps submission order within each tile.
    order = np.argsort(tiles_all, kind="stable")
    tiles_all = tiles_all[order]
    cmds_all = cmds_all[order]

    counts = np.bincount(tiles_all, minlength=T)
    starts = np.concatenate(([0], np.cumsum(counts[:-1])))
    rank = np.arange(len(tiles_all)) - starts[tiles_all]
    occ = int(counts.max())
    k_used = _k_trim(occ, k)
    fit = rank < k_used
    overflow = int((~fit).sum())
    bins = np.full((T, k_used), -1, np.int32)
    bins[tiles_all[fit], rank[fit]] = cmds_all[fit].astype(np.int32)
    return bins, overflow


def _bin_commands(boxes: np.ndarray, n: int, tiles_y: int, tiles_x: int,
                  k: int) -> tuple[np.ndarray, int]:
    """boxes: (N, 4) x0, y0, x1, y1. → (T, k) i32 index lists padded with
    −1 (in submission order), plus the overflow count."""
    if n == 0:
        return np.full((tiles_y * tiles_x, 8), -1, np.int32), 0
    return _bin_indexed(boxes[:n], np.arange(n, dtype=np.int64), tiles_y,
                        tiles_x, k)


def pack_scene(scene: Scene
               ) -> tuple[np.ndarray, tuple, int, int, list]:
    """→ (fused_blob_i32, meta, tiles_y, tiles_x, win_list). `meta` is the
    unpack signature: (i16_words, n_windows, then per layer (ns_cap,
    ng_cap, ni_cap, ks, kg, ki, has_s, has_g, has_i, bins16, wins)) where
    wins = ((global_idx, (ws, wg, wi)), ...). `win_list` is
    [(uid, caps, blob_i16)] in scene.windows order — device-cacheable."""
    tiles_x = -(-scene.width // TILE_W)
    tiles_y = -(-scene.height // TILE_H)
    T = tiles_y * tiles_x
    windows = list(getattr(scene, "windows", ()) or ())
    slot_count: dict[int, int] = {}
    win_entries = []
    for w in windows:
        slot = slot_count.get(w.layer, 0)
        slot_count[w.layer] = slot + 1
        caps = _window_caps(w, slot)
        win_entries.append((w, caps, _window_artifacts(w, caps)))

    i16_parts: list[np.ndarray] = []
    i32_parts: list[np.ndarray] = []
    meta = []
    empty_bins = np.zeros((T, 0), np.int32)

    # Uniform head: 8 i16 per window — dx, dy @1/8 px; clip @1/4 px; pad.
    uni = np.zeros((len(windows), 8), np.int16)
    for gi, w in enumerate(windows):
        uni[gi] = W.quantize_uniform(w)
    i16_parts.append(uni.ravel())

    for li, lb in enumerate(scene.layers):
        lws = [(gi, w, caps, entry) for gi, (w, caps, entry)
               in enumerate(win_entries) if w.layer == li]
        occ = (lb.n_shapes, lb.n_glyphs, lb.n_images)
        caps_c = (lb.shapes.shape[0], lb.glyphs.shape[0],
                  lb.images.shape[0])
        chrome_boxes = (_shape_boxes(lb.shapes, lb.n_shapes),
                        _quad_boxes(lb.glyphs, lb.n_glyphs),
                        _quad_boxes(lb.images, lb.n_images))
        chrome_clips = (lb.shape_clips, lb.glyph_clips, lb.image_clips)
        cls_bins = []
        max_idx = 0
        for ci in range(3):
            nc = occ[ci]
            base = caps_c[ci]
            win_blocks = []
            for gi, w, caps, entry in lws:
                if entry["ns"][ci]:
                    wb = _window_space_bins(entry, ci, w.dx, w.clip,
                                            tiles_x)
                    if wb is not None:
                        win_blocks.append((_merged_window_bins(
                            wb, w.dy, tiles_y, tiles_x, base,
                            entry["boxes"][ci]), w.pos[ci]))
                base += caps[ci]
            max_idx = max(max_idx, base)
            if nc:
                eb = _intersect_boxes(chrome_boxes[ci],
                                      chrome_clips[ci][:nc])
                chrome_bins = _bin_indexed(
                    eb, np.arange(nc, dtype=np.int64), tiles_y, tiles_x,
                    _CLS_KCAP[ci])[0]
            else:
                chrome_bins = (np.full((T, 0), -1, np.int32)
                               if win_blocks else None)
            if chrome_bins is None:
                cls_bins.append(empty_bins)
            elif win_blocks:
                cls_bins.append(_interleave_bins(chrome_bins, win_blocks,
                                                 _CLS_KCAP[ci]))
            else:
                cls_bins.append(chrome_bins)
        s_bins, g_bins, i_bins = cls_bins

        # Quantize only the used prefix; padding rows stay zero.
        i16_parts.append(W.quantize(W.parts(lb), occ, caps_c))
        # Bin indices ride in the i16 half unless a layer's concatenated
        # tables reach i16 range; then they go to the i32 section.
        bins16 = max_idx < 32767
        if bins16:
            i16_parts += [s_bins.astype(np.int16).ravel(),
                          g_bins.astype(np.int16).ravel(),
                          i_bins.astype(np.int16).ravel()]
        else:
            i32_parts += [s_bins.ravel(), g_bins.ravel(), i_bins.ravel()]
        wins_meta = tuple((gi, caps) for gi, w, caps, entry in lws)
        has = tuple(occ[ci] > 0
                    or any(e["ns"][ci] for _, w, _, e in lws)
                    for ci in range(3))
        meta.append((caps_c[0], caps_c[1], caps_c[2], s_bins.shape[1],
                     g_bins.shape[1], i_bins.shape[1], has[0], has[1],
                     has[2], bins16, wins_meta))
    blob_i16 = (np.concatenate(i16_parts) if i16_parts
                else np.zeros(0, np.int16))
    blob_i32 = (np.concatenate(i32_parts) if i32_parts
                else np.zeros(0, np.int32))
    # One array per frame: the i16 half rides bitcast inside i32 words.
    if blob_i16.size % 2:
        blob_i16 = np.concatenate([blob_i16, np.zeros(1, np.int16)])
    fused = np.concatenate([blob_i16.view(np.int32), blob_i32])
    meta = (blob_i16.size // 2, len(windows)) + tuple(meta)
    win_list = [(w.comp.uid, caps, entry["blob"])
                for w, caps, entry in win_entries]
    return fused, tuple(meta), tiles_y, tiles_x, win_list


# ---------------------------------------------------------------------------
# Device unpack (torch; bit-equal to the reference's unpack_layers).
# ---------------------------------------------------------------------------

def unpack_layers(fused: torch.Tensor, win_blobs: tuple, meta: tuple,
                  T: int):
    """Device unpack + de-quantization of one packed frame. `fused` is the
    i32 blob and `win_blobs` the i16 window blobs, all on one device.
    Window tables are appended to their layer's tables after the shift;
    bins index the concatenated tables. Returns (layer_data, layer_sig):
    per layer (shapes, shape_clips, glyphs, glyph_colors, glyph_clips,
    images, image_clips) f32 and (s_bins, g_bins, i_bins) (T, k) i32."""
    i16_words, n_win = meta[0], meta[1]
    blob_i16 = (fused[:i16_words].contiguous().view(torch.int16)
                if i16_words else fused.new_empty(0, dtype=torch.int16))
    blob_i32 = fused[i16_words:]
    fo = n_win * 8
    uni = W.uniform(blob_i16[:fo].reshape(n_win, 8)) if n_win else None
    layer_data = []
    layer_sig = []
    io = 0
    for (ns, ng, ni, ks, kg, ki, has_s, has_g, has_i, bins16,
         wins) in meta[2:]:
        nwords = W.words((ns, ng, ni))
        parts = W.dequantize(blob_i16[fo:fo + nwords], (ns, ng, ni))
        fo += nwords
        bins = []
        for k in (ks, kg, ki):
            if bins16:
                bins.append(blob_i16[fo:fo + T * k].reshape(T, k).int())
                fo += T * k
            else:
                bins.append(blob_i32[io:io + T * k].reshape(T, k))
                io += T * k
        if wins:
            # Each window de-quantized and moved to screen space, its
            # clips cut to its viewport.
            wparts = [W.shift(W.dequantize(win_blobs[gi], wcaps), uni[gi])
                      for gi, wcaps in wins]
            parts = [torch.cat([parts[pi]] + [wp[pi] for wp in wparts])
                     for pi in range(7)]
        layer_data.append(tuple(parts) + tuple(bins))
        layer_sig.append((has_s, has_g, has_i))
    return tuple(layer_data), tuple(layer_sig)


# ---------------------------------------------------------------------------
# Frame entry points.
# ---------------------------------------------------------------------------

def _device_window_blob(uid, caps, blob: np.ndarray,
                        device: torch.device) -> torch.Tensor:
    key = (uid, caps, str(device))
    d = _WIN_DEV_CACHE.get(key)
    if d is None:
        while len(_WIN_DEV_CACHE) > 16:
            _WIN_DEV_CACHE.pop(next(iter(_WIN_DEV_CACHE)))
        d = upload(blob, device)
        _WIN_DEV_CACHE[key] = d
    return d


def _render_scene_f32_device(scene: Scene, font_tex: torch.Tensor,
                             image_atlas: torch.Tensor) -> torch.Tensor:
    """Oversized-scene path: commands go to the device as plain f32 (no i16
    quantization), with scroll windows spliced inline on the host at their
    exact z-positions (`Scene.inline_windows`), binned per layer and class,
    and rasterized by one `render_tiles` call."""
    with span("oversized.inline"):
        flat = scene.inline_windows()
    device = font_tex.device
    tiles_x = -(-flat.width // TILE_W)
    tiles_y = -(-flat.height // TILE_H)
    with span("oversized.bin"):
        bins = [(
            _bin_commands(_shape_boxes(lb.shapes, lb.n_shapes), lb.n_shapes,
                          tiles_y, tiles_x, K_SHAPES)[0],
            _bin_commands(_quad_boxes(lb.glyphs, lb.n_glyphs), lb.n_glyphs,
                          tiles_y, tiles_x, K_GLYPHS)[0],
            _bin_commands(_quad_boxes(lb.images, lb.n_images), lb.n_images,
                          tiles_y, tiles_x, K_IMAGES)[0])
            for lb in flat.layers]
    with span("oversized.upload"):
        layer_data = tuple(
            tuple(upload(np.ascontiguousarray(a), device)
                  for a in W.parts(lb) + lbins)
            for lb, lbins in zip(flat.layers, bins))
    layer_sig = tuple((lb.n_shapes > 0, lb.n_glyphs > 0, lb.n_images > 0)
                      for lb in flat.layers)
    with span("oversized.launch"):
        return render_tiles(layer_data, font_tex, image_atlas,
                            tuple(float(c) for c in flat.background[:3]),
                            tiles_y, tiles_x, layer_sig, flat.height,
                            flat.width)


def render_scene_device(scene: Scene, font_tex: torch.Tensor,
                        image_atlas: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Rasterize → (H, W, 4) u8 frame on `font_tex`'s device (no
    readback). font_tex: (FH, FW) u8; image_atlas: (AH, AW, 4) u8, by
    default the scene's own.

    A scene wider or taller than MAX_PACKED_PX takes the oversized f32
    path (`_render_scene_f32_device`, the tile kernel). Otherwise, the
    default path: the layer-image compose pipeline (render/compose.py:
    cached chrome layers and scroll slabs, one blend by the compose
    kernel; within 1 u8 of the packed path). WGIT_FRAME_COMPOSE=0, or a
    scene compose declines (a fractional scroll offset), drops to the
    device-resident frame cache (render/frame.py: content-addressed
    chrome, window pair bins gathered on the device, the blocks kernel);
    WGIT_FRAME_CACHE=0 to the single-shot packed path below. The frame
    cache and the packed path are bit-identical."""
    from . import compose as C
    from . import frame as F

    with span("render"):
        device = font_tex.device
        if image_atlas is None:
            image_atlas = upload(scene.image_atlas, device)
        if max(scene.width, scene.height) > MAX_PACKED_PX:
            COUNTERS["frames.oversized"] += 1
            return _render_scene_f32_device(scene, font_tex, image_atlas)
        if F.frame_cache_enabled():
            if C.compose_enabled():
                COUNTERS["compose.attempted"] += 1
                img = C.render_frame_composed(scene, font_tex, image_atlas)
                if img is not None:
                    COUNTERS["frames.composed"] += 1
                    return img
            COUNTERS["frames.frame_cache"] += 1
            return F.render_frame_device(scene, font_tex, image_atlas)
        COUNTERS["frames.packed"] += 1
        fused, meta, tiles_y, tiles_x, win_list = pack_scene(scene)
        wins = tuple(_device_window_blob(uid, caps, blob, device)
                     for uid, caps, blob in win_list)
        fused_dev = upload(fused, device)
        layer_data, layer_sig = unpack_layers(fused_dev, wins, meta,
                                              tiles_y * tiles_x)
        return render_tiles(layer_data, font_tex, image_atlas,
                            tuple(float(c) for c in scene.background[:3]),
                            tiles_y, tiles_x, layer_sig,
                            scene.height, scene.width)


def render_scene(scene: Scene, font_tex: torch.Tensor,
                 image_atlas: torch.Tensor | None = None) -> np.ndarray:
    """Rasterize a compiled Scene → host (H, W, 4) uint8."""
    return readback(render_scene_device(scene, font_tex, image_atlas))
