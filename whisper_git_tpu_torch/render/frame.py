"""Device-resident frame pipeline: a steady scroll frame uploads only its
uniforms, its volatile tail and a block-descriptor array.

Counterpart of `whisper_git_tpu/render/frame.py`. The packed path in
`rasterizer.py` re-quantizes and re-bins the whole scene every frame on
the host and de-quantizes it again on the device with about a hundred
small launches. This pipeline exploits what is true of an interactive GUI
frame stream: between consecutive frames almost nothing changes.

  * **Chrome** (per-layer static command prefix — everything except
    scroll windows and `El.volatile` commands) is content-addressed: a
    byte-hash of the used prefix keys a cache of device-resident,
    dequantized command tables, tile bins, and z-segment bounds. A pure
    scroll frame hits this cache and uploads nothing for chrome.
  * **Scroll windows** stay device-resident in window-relative
    coordinates, and their tile bins are precomputed in window space as
    "pair bins": P[a] lists, in submission order, every command
    intersecting window rows [a, a+2) of TILE_H. A screen tile row
    covering window span [y, y+TILE_H) ⊂ [64a, 64(a+2)) gathers P[a] on
    the device from the scroll offset — no per-frame host binning,
    merging, or sorting. Conservative slots (commands in the pair span
    but not this tile) composite with coverage 0, which is an exact
    no-op, so paint order and pixels are bit-identical to the packed
    path's inline splicing.
  * **Z-order across chrome and windows** uses the prefix property of
    submission-ordered bins: chrome commands with index < a window's
    stream position form a per-tile prefix of the chrome bins, so each
    window split is just a per-tile (lo, hi) bound pair — computed once
    per chrome content, cached on the device.
  * **Volatile commands** (scroll thumbs — the layer's dynamic tail, see
    El.volatile) and per-window (dx, dy, clip) uniforms are the frame
    blob, one small i16 array a frame.

Everything renders through `blocks_kernel.render_tiles_blocks` (K2), whose
per-command functions are the packed path's, so the frame is bit-identical
to the packed path's. Between the frame blob's upload and K2 nothing runs:
`build_blocks` hands K2 each window as its cached tables and pair bins and
each volatile tail as offsets in the blob, and K2 moves the window's
commands, picks its pair-bin rows and de-quantizes the tail itself
(`resolve_blocks` is the same in torch, for the plain version). Under a
render mesh (render/meshstate.py) each shard
renders a slice of whole tile rows through K2 on its device, and the slices
are gathered (`_render_tiles_blocks_sharded`; parallel/mesh.py has the
device model). Times and upload sizes measured on the card are in
PERF.md (`chip_smoke.py` prints them); none is repeated here.

The host half (`pack_frame` and what it calls) is the reference's numpy
code and its frame blob is byte-equal to the reference's. The bucket
ladders (`_wr_bucket`, `_dyn_bucket`) kept jit signatures stable there;
here they only pad, and padding is inert. Cached device values are torch
tensors, and every cache is keyed by device as well.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import tracing
from ..tracing import span
from . import rasterizer as R
from . import wire as W
from .blocks_kernel import TailBlock, WindowBlock, render_tiles_blocks
from .scene import Scene
from .transfer import upload

TILE_H = R.TILE_H
TILE_W = R.TILE_W

_CLS_KCAP = (R.K_SHAPES, R.K_GLYPHS, R.K_IMAGES)

# ---------------------------------------------------------------------------
# Window pair bins (window-space, dy-independent).
# ---------------------------------------------------------------------------

_WIN_PARTS_DEV: dict = {}   # (uid, caps, device) -> 7 device f32 tables
_WIN_PAIR_DEV: dict = {}    # (uid, ci, caps, dxq, clipq, tiles_x, device)


def _pair_bins(boxes: np.ndarray, dx: float, clip: tuple, tiles_x: int,
               kcap: int) -> dict | None:
    """Precompute window-space pair bins: P[a] = window-local indices of
    every command whose effective box intersects window span
    [a·TILE_H, (a+2)·TILE_H), in submission order, scattered per screen
    tile column (dx is scroll-stable). Returns None when nothing lands
    on screen."""
    n = boxes.shape[0]
    if n == 0:
        return None
    x0 = np.maximum(boxes[:, 0] + dx, clip[0])
    x1 = np.minimum(boxes[:, 2] + dx, clip[2])
    y0, y1 = boxes[:, 1], boxes[:, 3]
    keep = (x1 >= x0) & (y1 >= y0)
    if not keep.any():
        return None
    idx = np.arange(n, dtype=np.int64)[keep]
    tx0 = np.clip((x0[keep] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    tx1 = np.clip((x1[keep] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    b0 = np.floor(y0[keep] / TILE_H).astype(np.int64)
    b1 = np.floor(y1[keep] / TILE_H).astype(np.int64)
    # Command occupies pair rows a ∈ [b0-1, b1].
    a0, a1 = b0 - 1, b1
    row0 = int(a0.min())
    a0 -= row0
    a1 -= row0
    WR = int(a1.max()) + 1
    sx = tx1 - tx0 + 1
    sy = a1 - a0 + 1
    reps = sx * sy
    total = int(reps.sum())
    cmds = np.repeat(idx, reps)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps)
    rsx = np.repeat(sx, reps)
    dyy, dxx = offs // rsx, offs % rsx
    cells = ((np.repeat(a0, reps) + dyy) * tiles_x
             + np.repeat(tx0, reps) + dxx)
    ncells = WR * tiles_x
    order = np.argsort(cells, kind="stable")  # keeps submission order
    cells, cmds = cells[order], cmds[order]
    counts = np.bincount(cells, minlength=ncells)
    starts = np.concatenate(([0], np.cumsum(counts[:-1])))
    rank = np.arange(len(cells)) - starts[cells]
    kP = R._k_trim(int(counts.max()), kcap)
    fit = rank < kP
    P = np.full((ncells, kP), -1, np.int32)
    P[cells[fit], rank[fit]] = cmds[fit].astype(np.int32)
    return {"P": P.reshape(WR, tiles_x, kP),
            "counts": np.minimum(counts, kP).astype(np.int32)
            .reshape(WR, tiles_x),
            "row0": row0, "WR": WR, "kP": kP}


_WR_HW: dict = {}


def _wr_bucket(wr: int, hw_key) -> int:
    """Pad the pair-bin row count to a bucket that never shrinks for its
    key, as the reference does (its blob carries WR beside it)."""
    cap = 8
    while cap < wr:
        cap *= 2
    cap = max(cap, _WR_HW.get(hw_key, 0))
    _WR_HW[hw_key] = cap
    return cap


def _win_pair_entry(uid: int, ci: int, caps: tuple, boxes: np.ndarray,
                    dx: float, clip: tuple, tiles_x: int, device):
    key = (uid, ci, caps, round(dx * 8.0),
           tuple(round(c * 4.0) for c in clip), tiles_x, str(device))
    if key in _WIN_PAIR_DEV:
        return _WIN_PAIR_DEV[key]
    pb = _pair_bins(boxes, dx, clip, tiles_x, _CLS_KCAP[ci])
    if pb is not None:
        # Pad rows to a bucketed capacity; WR and row0 ride the frame blob.
        wr_cap = _wr_bucket(pb["WR"], (ci, caps, tiles_x))
        P = np.zeros((wr_cap,) + pb["P"].shape[1:], np.int32)
        P[:pb["WR"]] = pb["P"]
        counts = np.zeros((wr_cap, tiles_x), np.int32)
        counts[:pb["WR"]] = pb["counts"]
        pb = {"P": upload(P, device),
              "counts": upload(counts, device),
              "row0": pb["row0"], "WR": pb["WR"], "kP": pb["kP"],
              "wr_cap": wr_cap}
    while len(_WIN_PAIR_DEV) > 48:
        _WIN_PAIR_DEV.pop(next(iter(_WIN_PAIR_DEV)))
    _WIN_PAIR_DEV[key] = pb
    return pb


def _win_parts(uid: int, caps: tuple, blob: np.ndarray, device):
    key = (uid, caps, str(device))
    hit = _WIN_PARTS_DEV.get(key)
    if hit is None:
        while len(_WIN_PARTS_DEV) > 32:
            _WIN_PARTS_DEV.pop(next(iter(_WIN_PARTS_DEV)))
        hit = W.dequantize(upload(blob, device), caps)
        _WIN_PARTS_DEV[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Chrome cache (content-addressed device residency).
# ---------------------------------------------------------------------------

_CHROME_CACHE: dict = {}


def _chrome_entry(lb, li: int, pos_lists: tuple, tiles_y: int,
                  tiles_x: int, device):
    """Device-resident chrome for one layer: dequantized tables, per-class
    tile bins, and per-window-split segment bounds. Keyed by the BYTES of
    the static command prefix — a pure scroll frame hits this outright."""
    counts_n = ns, ng, ni = (lb.n_shapes - lb.n_dyn_shapes,
                             lb.n_glyphs - lb.n_dyn_glyphs,
                             lb.n_images - lb.n_dyn_images)
    caps = (lb.shapes.shape[0], lb.glyphs.shape[0], lb.images.shape[0])
    if ns == 0 and ng == 0 and ni == 0:
        key = ("empty", li, caps, pos_lists, tiles_y, tiles_x, str(device))
    else:
        key = (li, caps, pos_lists, tiles_y, tiles_x, ns, ng, ni,
               *(hash(t[:counts_n[c]].tobytes())
                 for t, c in zip(W.parts(lb), W.PART_CLS)), str(device))
    hit = _CHROME_CACHE.get(key)
    if hit is not None:
        return hit
    parts = W.dequantize(upload(W.quantize(W.parts(lb), counts_n, caps),
                                device), caps)
    boxes = (R._intersect_boxes(R._shape_boxes(lb.shapes, ns),
                                lb.shape_clips[:ns]),
             R._intersect_boxes(R._quad_boxes(lb.glyphs, ng),
                                lb.glyph_clips[:ng]),
             R._intersect_boxes(R._quad_boxes(lb.images, ni),
                                lb.image_clips[:ni]))
    bins_dev, segs_dev, ks, seg_totals = [], [], [], []
    for ci in range(3):
        nc = counts_n[ci]
        if nc == 0:
            bins_dev.append(None)
            segs_dev.append(None)
            ks.append(0)
            seg_totals.append(None)
            continue
        bins, _ = R._bin_indexed(boxes[ci], np.arange(nc, dtype=np.int64),
                                 tiles_y, tiles_x, _CLS_KCAP[ci])
        valid = bins >= 0
        total = valid.sum(axis=1).astype(np.int32)
        # Segment bounds: entries per tile are ascending (submission
        # order), so "index < pos" is a per-tile prefix.
        rows = [np.zeros_like(total)]
        for pos in pos_lists[ci]:
            rows.append((valid & (bins < pos)).sum(axis=1)
                        .astype(np.int32))
        rows.append(total)
        seg = np.stack(rows)  # (S+2, T)
        bins_dev.append(upload(bins, device))
        segs_dev.append(upload(seg, device))
        ks.append(bins.shape[1])
        # host-side per-segment totals so the compose path can skip empty
        # chrome segments without a device readback
        seg_totals.append(tuple(
            int((seg[si + 1] - seg[si]).sum())
            for si in range(seg.shape[0] - 1)))
    # Per-(class, segment) pixel bounding boxes (command boxes already
    # carry the AA pad): lets the compose path crop chrome group layers
    # to their ink instead of blending full-frame transparency.
    seg_boxes = []
    for ci in range(3):
        nc = counts_n[ci]
        if nc == 0:
            seg_boxes.append(None)
            continue
        bounds = [0] + [min(int(p), nc) for p in pos_lists[ci]] + [nc]
        per_seg = []
        for si in range(len(bounds) - 1):
            b = boxes[ci][bounds[si]:bounds[si + 1]]
            b = b[(b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])]
            per_seg.append(None if b.shape[0] == 0 else
                           (float(b[:, 0].min()), float(b[:, 1].min()),
                            float(b[:, 2].max()), float(b[:, 3].max())))
        seg_boxes.append(tuple(per_seg))
    entry = {"parts": parts, "bins": tuple(bins_dev),
             "segs": tuple(segs_dev), "ks": tuple(ks), "caps": caps,
             "counts": counts_n, "key": key,
             "seg_totals": tuple(seg_totals),
             "seg_boxes": tuple(seg_boxes)}
    while len(_CHROME_CACHE) > 24:
        _CHROME_CACHE.pop(next(iter(_CHROME_CACHE)))
    _CHROME_CACHE[key] = entry
    return entry


# ---------------------------------------------------------------------------
# Dynamic tail (per-frame, tiny).
# ---------------------------------------------------------------------------

_DYN_HW: dict = {}


def _dyn_bucket(n: int, hw_key) -> int:
    if n == 0 and not _DYN_HW.get(hw_key):
        return 0
    cap = 8
    while cap < n:
        cap *= 2
    cap = max(cap, _DYN_HW.get(hw_key, 0))
    _DYN_HW[hw_key] = cap
    return cap


def _dyn_tables(lb) -> tuple:
    """A layer's volatile tail, the last rows of each class → (its counts
    of shapes, glyphs and images, its seven tables)."""
    nd = (lb.n_dyn_shapes, lb.n_dyn_glyphs, lb.n_dyn_images)
    n = (lb.n_shapes, lb.n_glyphs, lb.n_images)
    return nd, tuple(t[n[c] - nd[c]:n[c]]
                     for t, c in zip(W.parts(lb), W.PART_CLS))


def _dyn_layer(lb, li: int, tiles_y: int, tiles_x: int,
               subgrid: bool = False):
    """Quantized dynamic-tail parts + per-frame bins for one layer.
    Returns (blob_i16, bins_i16 flat, meta) — meta = (caps3, ks3, c0, c1)
    where [c0, c1) is the tile-COLUMN range the bins cover. With `subgrid`
    (the compose path) that range shrinks to the columns the commands'
    boxes touch — a scrollbar thumb occupies a fixed column while it
    moves, so the per-frame render touches about one column instead of
    the frame. Without it (this path) the range is the full grid."""
    nd3, tables = _dyn_tables(lb)
    nds, ndg, ndi = nd3
    caps = (_dyn_bucket(nds, (li, 0)), _dyn_bucket(ndg, (li, 1)),
            _dyn_bucket(ndi, (li, 2)))
    if sum(caps) == 0:
        return (np.zeros(0, np.int16), np.zeros(0, np.int16),
                ((0, 0, 0), (0, 0, 0), 0, tiles_x))
    blob = W.quantize(tables, nd3, caps)
    boxes = (R._intersect_boxes(R._shape_boxes(tables[0], nds), tables[1]),
             R._intersect_boxes(R._quad_boxes(tables[2], ndg), tables[4]),
             R._intersect_boxes(R._quad_boxes(tables[5], ndi), tables[6]))
    c0, c1 = 0, tiles_x
    if subgrid:
        valid = np.concatenate([
            b[(b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])] for b in boxes])
        if valid.shape[0]:
            c0 = min(max(0, int(valid[:, 0].min()) // TILE_W), tiles_x - 1)
            c1 = min(max(c0 + 1, -(-int(valid[:, 2].max() + 1) // TILE_W)),
                     tiles_x)
        else:
            c0, c1 = 0, 1
    off = np.array([c0 * TILE_W, 0.0, c0 * TILE_W, 0.0], np.float32)
    bins_parts, ks = [], []
    for ci, nd in enumerate(nd3):
        if caps[ci] == 0:
            ks.append(0)
            continue
        if nd:
            bins, _ = R._bin_indexed(boxes[ci] - off,
                                     np.arange(nd, dtype=np.int64),
                                     tiles_y, c1 - c0, 32)
        else:
            bins = np.full((tiles_y * (c1 - c0), 1), -1, np.int32)
        k = _dyn_bucket(bins.shape[1], (li, ci, "k"))
        padded = np.full((tiles_y * (c1 - c0), k), -1, np.int16)
        padded[:, :bins.shape[1]] = bins
        bins_parts.append(padded.ravel())
        ks.append(k)
    return blob, (np.concatenate(bins_parts) if bins_parts
                  else np.zeros(0, np.int16)), (caps, tuple(ks), c0, c1)


# ---------------------------------------------------------------------------
# Frame assembly.
# ---------------------------------------------------------------------------

def pack_frame(scene: Scene, device="cpu"):
    """→ (frame_blob i16, chrome_args, win_args, meta), the cached values
    in chrome_args and win_args being tensors on `device`. Steady-state
    frames only rebuild frame_blob (uniforms + dynamic tail)."""
    device = torch.device(device)
    tiles_x = -(-scene.width // TILE_W)
    tiles_y = -(-scene.height // TILE_H)
    windows = list(getattr(scene, "windows", ()) or ())
    slot_count: dict[int, int] = {}
    win_args = []
    win_meta = []
    uni = np.zeros((len(windows), 8), np.int16)
    # Per-window per-class (row0, WR): content-dependent, beside the
    # scroll uniforms.
    uni2 = np.zeros((len(windows), 8), np.int16)
    for gi, w in enumerate(windows):
        slot = slot_count.get(w.layer, 0)
        slot_count[w.layer] = slot + 1
        caps = R._window_caps(w, slot)
        art = R._window_artifacts(w, caps)
        parts = _win_parts(w.comp.uid, caps, art["blob"], device)
        uni[gi] = W.quantize_uniform(w)
        cls_args, cls_meta = [], []
        for ci in range(3):
            pb = (_win_pair_entry(w.comp.uid, ci, caps, art["boxes"][ci],
                                  w.dx, w.clip, tiles_x, device)
                  if art["ns"][ci] else None)
            if pb is None:
                cls_args.append(None)
                cls_meta.append(None)
            else:
                cls_args.append((pb["P"], pb["counts"]))
                cls_meta.append((pb["kP"], pb["wr_cap"]))
                uni2[gi, 2 * ci] = pb["row0"]
                uni2[gi, 2 * ci + 1] = pb["WR"]
        win_args.append((parts, tuple(cls_args)))
        win_meta.append((w.layer, caps, tuple(cls_meta)))

    blob_parts = [uni.ravel(), uni2.ravel()]
    chrome_args = []
    layers_meta = []
    for li, lb in enumerate(scene.layers):
        lws = [gi for gi, w in enumerate(windows) if w.layer == li]
        pos_lists = tuple(tuple(windows[gi].pos[ci] for gi in lws)
                          for ci in range(3))
        ch = _chrome_entry(lb, li, pos_lists, tiles_y, tiles_x, device)
        dyn_blob, dyn_bins, dyn_meta = _dyn_layer(lb, li, tiles_y, tiles_x)
        blob_parts += [dyn_blob, dyn_bins]
        chrome_args.append((ch["parts"], ch["bins"], ch["segs"]))
        has = tuple(
            ch["counts"][ci] > 0 or dyn_meta[0][ci] > 0
            or any(win_meta[gi][2][ci] is not None for gi in lws)
            for ci in range(3))
        layers_meta.append((ch["caps"], ch["ks"], tuple(lws), dyn_meta,
                            has))
    frame_blob = np.concatenate(blob_parts) if blob_parts else \
        np.zeros(0, np.int16)
    meta = (tiles_y, tiles_x, len(windows), tuple(win_meta),
            tuple(layers_meta))
    return frame_blob, tuple(chrome_args), tuple(win_args), meta


_ROW_ORIGIN: dict = {}   # (tiles_y, device) -> (tiles_y,) f32 row origins


def _pair_rows(uni2_row: torch.Tensor, dy, tiles_y: int) -> tuple:
    """Which pair-bin row each screen tile row reads, for the three
    classes of one window at once. The screen tile row at y = r·TILE_H
    covers window span [y − dy, y − dy + TILE_H), which lies in pair row
    a = floor((y − dy)/TILE_H) − row0, computed in f32 as the reference
    does. `uni2_row` is the window's (row0, WR) pairs as i32 (8,), dy a
    0-d f32 tensor. → (av (3, tiles_y) i64 rows clamped into [0, WR),
    ok (3, tiles_y) i32, 1 where a fell inside [0, WR))."""
    key = (tiles_y, str(dy.device))
    r = _ROW_ORIGIN.get(key)
    if r is None:
        r = torch.arange(tiles_y, dtype=torch.float32,
                         device=dy.device) * TILE_H
        _ROW_ORIGIN[key] = r
    rw = uni2_row[:6].reshape(3, 2)
    row0, WR = rw[:, 0:1], rw[:, 1:2]
    a = torch.floor((r - dy) / TILE_H).to(torch.int32)[None, :] - row0
    ok = ((a >= 0) & (a < WR)).to(torch.int32)
    av = torch.minimum(torch.clamp(a, min=0), torch.clamp(WR - 1, min=0))
    return av.long(), ok


def _gather_pair_bins(P, counts, av, ok, kP: int):
    """A window class's per-frame bins, gathered from its pair bins by
    one class's row of `_pair_rows`. Rows outside [0, WR) get count 0.
    → (bins (T, kP) i32, counts (T,) i32)."""
    return P[av].reshape(-1, kP), (counts[av] * ok[:, None]).reshape(-1)


def build_blocks(frame_blob: torch.Tensor, chrome_args, win_args,
                 meta: tuple) -> tuple:
    """A frame's block lists for K2, per (layer, class): chrome segment,
    window, chrome segment, …, volatile tail. Host bookkeeping alone: no
    tensor is made and nothing runs on the device. A chrome segment is a
    plain block of the cached chrome tables; a window a `WindowBlock` of
    its cached window-relative tables and pair bins; a volatile tail a
    `TailBlock` at its offsets in `frame_blob`, the i16 blob on the device
    of the cached arguments. K2 resolves the last two from the blob
    (`resolve_blocks` does it in torch); they are counted in
    `blocks.windows_inline` and `blocks.tails_inline`."""
    tiles_y, tiles_x, n_win, win_meta, layers_meta = meta
    T = tiles_y * tiles_x
    fo = n_win * 16
    layers_blocks = []
    for li, (caps, ks, lws, dyn_meta, has) in enumerate(layers_meta):
        parts, bins3, segs3 = chrome_args[li]
        dyn_caps, dyn_ks = dyn_meta[0], dyn_meta[1]  # full grid here
        at = fo
        fo += W.words(dyn_caps)
        tails = []
        for k in dyn_ks:
            tails.append(TailBlock(frame_blob, at, dyn_caps, fo, k)
                         if k and sum(dyn_caps) else None)
            fo += T * k
        cls_lists = []
        for ci in range(3):
            blocks = []
            tbl_idx = W.CLS_TABLES[ci]
            chrome_tables = tuple(parts[j] for j in tbl_idx)
            # chrome segment 0, win, segment 1, win, ..., last segment
            for si in range(len(lws) + 1):
                if ks[ci]:
                    blocks.append((chrome_tables, bins3[ci],
                                   segs3[ci][si], segs3[ci][si + 1]))
                # window order within the layer == pos order
                if si < len(lws) and win_meta[lws[si]][2][ci] is not None:
                    wi = lws[si]
                    P, counts = win_args[wi][1][ci]
                    blocks.append(WindowBlock(
                        tuple(win_args[wi][0][j] for j in tbl_idx), P,
                        counts, frame_blob, wi, n_win))
                    tracing.COUNTERS["blocks.windows_inline"] += 1
            if tails[ci] is not None:
                blocks.append(tails[ci])
                tracing.COUNTERS["blocks.tails_inline"] += 1
            cls_lists.append(tuple(blocks))
        layers_blocks.append(tuple(cls_lists))
    return tuple(layers_blocks)


def resolve_blocks(layers_blocks, tiles_y: int, tiles_x: int) -> tuple:
    """`layers_blocks` with every window and tail block made the plain
    block K2 resolves it to, in torch on the blocks' device: a window's
    uniform row from the blob (`wire.uniform`), its tables moved and cut
    (`wire.shift`), its pair-bin rows picked and gathered (`_pair_rows`,
    `_gather_pair_bins`); a tail's tables de-quantized (`wire.dequantize`)
    and its bins widened to i32, each row's `hi` its count of entries.
    Plain blocks are kept as they are."""
    T = tiles_y * tiles_x

    def plain(ci, block):
        if isinstance(block, WindowBlock):
            n, wi = block.n_windows, block.window
            head = block.blob[:n * 16].reshape(2, n, 8)
            u = W.uniform(head[0, wi])
            shifted = W.shift(W.class_parts(ci, block.tables), u)
            av, ok = _pair_rows(head[1, wi].int(), u[1], tiles_y)
            bins, cnt = _gather_pair_bins(block.P, block.counts, av[ci],
                                          ok[ci], block.P.shape[2])
            return (tuple(shifted[j] for j in W.CLS_TABLES[ci]), bins, None,
                    cnt)
        if isinstance(block, TailBlock):
            tables = W.dequantize(
                block.blob[block.at:block.at + W.words(block.caps)],
                block.caps)
            b = block.blob[block.bins:block.bins + T * block.k].reshape(
                T, block.k).int()
            return (tuple(tables[j] for j in W.CLS_TABLES[ci]), b, None,
                    (b >= 0).sum(dim=1, dtype=torch.int32))
        return block

    return tuple(tuple(tuple(plain(ci, b) for b in blocks)
                       for ci, blocks in enumerate(cls_lists))
                 for cls_lists in layers_blocks)


# ---------------------------------------------------------------------------
# Mesh-sharded tile rendering: the frame paths under a device mesh. Every
# shard renders a contiguous slice of whole tile rows of a grid padded to a
# multiple of the mesh size, through the same kernel, with the inputs
# replicated to its device; the slices are gathered onto the first device.
# ---------------------------------------------------------------------------

# A source tensor's copy on another device, kept while the source lives
# (the dictionary holds it weakly, by identity) and unchanged (its version
# counter): the atlases, the cached chrome tables and a plan's layers are
# copied once a device, and a frame's own tables, which die with the frame,
# take their copies with them. No capacity to outgrow: a frame that hands
# over hundreds of fresh tables evicts nothing that lives on.
_REPLICAS: dict = {}   # device -> {source tensor: (its version, its copy)}

# Bytes the mesh paths copied from one device to another, by what: a
# frame's inputs replicated to a shard ("replicas"), compose's cached
# layers committed to every shard once a plan ("layers"), the shards'
# outputs gathered onto the first device ("gather"). The caller zeroes
# them; a mesh of one device repeated copies and counts nothing.
MOVED = {"replicas": 0, "layers": 0, "gather": 0}
tracing.register_counters("moved", MOVED)
# How much larger than a view its base may be for `replicate` to copy the
# base (once) and not the view.
_VIEW_SPAN = 64


def move(t: torch.Tensor, device, kind: str) -> torch.Tensor:
    """`t` on `device`, the bytes of a copy counted under `kind` in
    `MOVED` (`t` itself where it lies there already)."""
    out = t.to(device)
    if out is not t:
        MOVED[kind] += t.numel() * t.element_size()
    return out


def _replica(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    copies = _REPLICAS.get(device)
    if copies is None:
        copies = _REPLICAS[device] = WeakIdKeyDictionary()
    hit = copies.get(t)
    if hit is None or hit[0] != t._version:
        hit = (t._version, move(t, device, "replicas"))
        copies[t] = hit
    return hit[1]


def replicate(tree, device):
    """`tree` (tensors in tuples, lists and dicts; anything else kept) with
    every tensor on `device`: the tensor itself where it lies there
    already, so a mesh of one device copies nothing. A copy made of a
    tensor is kept while the tensor lives unchanged (the atlases, a plan's
    layers), so a steady frame uploads it once a device.

    A view (a frame's row of a cached table, the slices of one buffer of
    a frame's tables) is that view of its base's copy: views taken anew
    each frame of a tensor that lives on copy nothing, and the views of
    one buffer copy it once. A view of a base over `_VIEW_SPAN` times its
    size is copied alone."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        if tree.device == device:
            return tree
        base = tree._base
        if base is not None and base.dtype == tree.dtype \
                and base.is_contiguous() and base.storage_offset() == 0 \
                and base.numel() <= _VIEW_SPAN * max(1, tree.numel()):
            return _replica(base, device).as_strided(
                tree.size(), tree.stride(), tree.storage_offset())
        return _replica(tree, device)
    if isinstance(tree, (tuple, list)):
        items = [replicate(x, device) for x in tree]
        # a block kind (a named tuple) takes its fields one by one
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    return tree


def gather(parts, device) -> torch.Tensor:
    """The shards' outputs, moved to `device` and joined along their first
    axis (rows of a frame or a layer, tiles of a slice). Each output that
    holds a row was one kernel launch of its shard (a slice of pad rows
    alone launches nothing), counted in `mesh.shard_launches`."""
    tracing.COUNTERS["mesh.shard_launches"] += sum(
        1 for p in parts if p.shape[0])
    with span("gather"):
        return torch.cat([move(p, device, "gather") for p in parts])


def _sharded_tile_rows(tiles_y: int, tiles_x: int, mesh) -> tuple:
    """(T_pad, ty_pad) for a tile-ROW-aligned n-way split: tiles_y pads to
    a multiple of the mesh size so each shard owns whole tile rows."""
    ty_pad = -(-tiles_y // mesh.size) * mesh.size
    return ty_pad * tiles_x, ty_pad


def _render_tiles_blocks_sharded(layers_blocks, font_tex, image_atlas,
                                 background, tiles_y: int, tiles_x: int,
                                 height: int, width: int, mesh, *,
                                 layer_i16: bool = False,
                                 tile_rect: tuple | None = None
                                 ) -> torch.Tensor:
    """`render_tiles_blocks` over `mesh` (every axis jointly the spatial
    one): shard s renders tile rows [s·L, (s+1)·L) of the row-padded grid
    (`_sharded_tile_rows`, L = ty_pad / n) on its device, within
    `tile_rect` where one is given, and the slices are gathered onto the
    mesh's first device: the output of one call, bit for bit. A shard
    whose slice holds no row of the frame (or of the rect) launches
    nothing."""
    _, ty_pad = _sharded_tile_rows(tiles_y, tiles_x, mesh)
    local = ty_pad // mesh.size
    parts = []
    for s, dev in enumerate(mesh.flat):
        with span("shard", card=dev.index):
            with span("mesh.replicate"):
                lb, ftex, iatlas = replicate((layers_blocks, font_tex,
                                              image_atlas), dev)
            parts.append(render_tiles_blocks(
                lb, ftex, iatlas, background, tiles_y, tiles_x, height,
                width, n_tiles=local * tiles_x, tile0=s * local * tiles_x,
                layer_i16=layer_i16, tile_rect=tile_rect))
    return gather(parts, mesh.flat[0])


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------

def frame_cache_enabled() -> bool:
    want = os.environ.get("WGIT_FRAME_CACHE")
    if want is not None:
        return want not in ("0", "false", "")
    return True


def render_frame_device(scene: Scene, font_tex: torch.Tensor,
                        image_atlas: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Rasterize → (H, W, 4) u8 frame on `font_tex`'s device (no
    readback), through the frame cache and the blocks kernel. When a render
    mesh is installed (render/meshstate.py) the tile rows shard across
    it."""
    from .meshstate import get_render_mesh

    device = font_tex.device
    if image_atlas is None:
        image_atlas = upload(scene.image_atlas, device)
    with span("frame.pack"):
        frame_blob, chrome_args, win_args, meta = pack_frame(scene, device)
    with span("frame.blocks"):
        blocks = build_blocks(upload(frame_blob, device), chrome_args,
                              win_args, meta)
    args = (blocks, font_tex, image_atlas,
            tuple(float(c) for c in scene.background[:3]), meta[0], meta[1],
            scene.height, scene.width)
    mesh = get_render_mesh()
    with span("frame.launch"):
        if mesh is not None:
            tracing.COUNTERS["mesh.frames"] += 1
            return move(_render_tiles_blocks_sharded(*args, mesh), device,
                        "gather")
        return render_tiles_blocks(*args)


def clear_caches() -> None:
    _CHROME_CACHE.clear()
    _WIN_PARTS_DEV.clear()
    _WIN_PAIR_DEV.clear()
    _REPLICAS.clear()
