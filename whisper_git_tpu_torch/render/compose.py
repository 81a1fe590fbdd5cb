"""Layer-image compose pipeline: a steady frame is a blend of cached,
device-resident layers.

Counterpart of `whisper_git_tpu/render/compose.py`, the kernel mode of it.
The frame cache (`frame.py`) makes the host's half of a frame small, but
the device still composites every command into every tile each frame. This
module exploits the next invariant of an interactive GUI stream: between
frames, the *rendered pixels* of almost everything are unchanged too.

  * **Chrome runs** (the static command segments between scroll windows,
    in z order) are rendered ONCE per content hash into transparent
    premultiplied layers that stay on the device, cut to the tile rect of
    their ink.
  * **Scroll windows** are rendered into a device-resident SLAB, a tall
    transparent image in window-content space covering the viewport plus
    ±`OVERSCAN` rows. A scroll frame reads the slab from a row offset; the
    slab re-renders only when scrolling leaves the overscan or the content
    changes (keyed by the window's content uid).
  * **Volatile commands** (scrollbar thumbs, the per-layer dynamic tail)
    are the only per-frame rasterization: shapes inline in the compose
    kernel, glyphs and images (rare) by one blocks-kernel pass over a
    transparent sub-grid of tile columns.
  * The frame is assembled by `compose_kernel.compose_tiles` (K3), which
    blends the layers in the plan's z order. Per frame the host uploads
    one small i16 blob (slab starts, quantized tails and their bins); the
    kernel's op descriptors ride in its launch, those of the cached layers
    built once a plan.

Cached layers are rendered by `blocks_kernel.render_tiles_blocks` (K2) over
a transparent canvas and written by it as interleaved (h, w, 4) i16 fixed
point at 1/32767, the reference's values in the port's layout; a chrome
group only over the tile rect of its ink. The reference's
other blend modes (f16 layers blended by an XLA chain, what it runs where
it has no Pallas) have no counterpart: on the CPU K3's plain version
blends the same i16 layers.

Under a render mesh (render/meshstate.py; parallel/mesh.py has the device
model) every K2 build (a chrome group over its tile rect, a slab, a
pre-rendered tail) runs a slice of whole tile rows a shard, gathered onto
the first device; `_memo_stack` commits each cached layer to every shard's
device once a plan; and the blend is K3 a shard over its slice of tile rows
(`_compose_frame`), the slices gathered into the frame. The plans and the
stacks key on the mesh, so a plan built under one mesh (or none) never
serves another; the layer caches do not, since a layer is the same bits
either way.

Exactness: every layer keeps the rasterizer's per-command compositing
inside; layer boundaries re-associate the `over` operator (exact where
layers do not overlap, a last-ulp effect where they do) and cached layers
round to 2^-15 (about 0.004 u8). Integer scroll offsets translate commands
exactly in f32, so slab crops reproduce direct rendering; the frame stays
within 1 u8 a channel of the packed path's. A fractional scroll offset
makes `render_frame_composed` return None and the caller takes the frame
cache. Disable with WGIT_FRAME_COMPOSE=0. Times measured on the card are in
PERF.md (`chip_smoke.py` prints them); none is repeated here.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import frame as F
from . import rasterizer as R
from .blocks_kernel import quantize_i16 as _quant_i16_planar  # noqa: F401
from .blocks_kernel import render_tiles_blocks
from .compose_kernel import PlanRows, compose_tiles
from .meshstate import get_render_mesh

TILE_H = R.TILE_H
TILE_W = R.TILE_W

# Slab rows beyond the viewport on each side. The window's content uid
# already changes every ~128 px of scroll (the layout's materialization
# buckets), which rebuilds the slab anyway, so the slab only needs to cover
# one uid bucket's worth of scroll, not survive long scrolls.
OVERSCAN = 192

# Device-image caches. Dicts iterate in insertion order, so re-inserting on
# a hit makes `pop(next(iter(...)))` evict the LEAST recently used entry.
# Device memory at 1280×800 (i16 RGBA, 8 B a pixel): a full-frame chrome
# group is 8.2 MB and a slab (1216 rows) 12.5 MB, so the caps of 12 groups
# and 24 slabs hold under 0.4 GB, and the plans and stacks only hold
# references to the same tensors: well inside a card's 80 GB, and bounded
# however long the program runs.
_GROUP_CACHE: dict = {}   # group key -> (layer i16, ty0, tx0)
_SLAB_CACHE: dict = {}    # slab key  -> dict(y0s, img)


def _lru_get(cache: dict, key):
    hit = cache.pop(key, None)
    if hit is not None:
        cache[key] = hit  # re-insert → most recently used
    return hit


_CLS_TBL = ((0, 1), (2, 3, 4), (5, 6))  # class -> indices into 7-part tuple


def compose_enabled() -> bool:
    want = os.environ.get("WGIT_FRAME_COMPOSE")
    if want is not None:
        return want not in ("0", "false", "")
    return True


# `_quant_i16_planar` (the reference's name) is the plain blocks
# rasterizer's quantizer, `blocks_kernel.quantize_i16`: on the card the
# blocks kernel writes the same i16 values itself.


def _render_layer(layers_blocks, font_tex, image_atlas, tiles_y: int,
                  tiles_x: int, height: int, width: int, **kw):
    """A layer over a transparent canvas from K2 (`render_tiles_blocks`'s
    keywords): one call, or under a render mesh a slice of tile rows a
    shard, gathered onto the first device."""
    mesh = get_render_mesh()
    if mesh is None:
        return render_tiles_blocks(layers_blocks, font_tex, image_atlas,
                                   None, tiles_y, tiles_x, height, width,
                                   **kw)
    return F.move(F._render_tiles_blocks_sharded(
        layers_blocks, font_tex, image_atlas, None, tiles_y, tiles_x,
        height, width, mesh, **kw), font_tex.device, "gather")


def _single_class_blocks(ci: int, block):
    """Wrap one class's block list in the layers_blocks structure."""
    cls = [(), (), ()]
    cls[ci] = (block,)
    return (tuple(cls),)


# ---------------------------------------------------------------------------
# Run flattening: the z-ordered sequence of compose layers.
# ---------------------------------------------------------------------------

def _flatten_runs(scene, chrome_entries, windows, lws_by_layer):
    """→ ordered run list; each run is
    ("chrome", li, ci, si) | ("win", gi, ci) | ("dyn", li, ci)."""
    runs = []
    for li, lb in enumerate(scene.layers):
        ch = chrome_entries[li]
        lws = lws_by_layer[li]
        dyn_counts = (lb.n_dyn_shapes, lb.n_dyn_images, lb.n_dyn_glyphs)
        for zi, ci in enumerate((0, 2, 1)):  # z order: shapes, images, glyphs
            n_seg = len(lws) + 1
            for si in range(n_seg):
                if ch["ks"][ci] and ch["seg_totals"][ci][si]:
                    runs.append(("chrome", li, ci, si))
                if si < len(lws):
                    gi = lws[si]
                    w = windows[gi]
                    counts = (w.comp.shapes.shape[0], w.comp.glyphs.shape[0],
                              w.comp.images.shape[0])
                    if counts[ci]:
                        runs.append(("win", gi, ci))
            if dyn_counts[zi]:
                runs.append(("dyn", li, ci))
    return runs


def _group_chrome(runs):
    """Merge consecutive chrome runs into render groups. Returns a list of
    ops: ("group", [chrome runs...]) | ("win", gi, ci) | ("dyn", li, ci)."""
    ops = []
    for run in runs:
        if run[0] == "chrome":
            if ops and ops[-1][0] == "group":
                ops[-1][1].append(run)
            else:
                ops.append(("group", [run]))
        else:
            ops.append(run)
    return ops


# ---------------------------------------------------------------------------
# Layer image construction.
# ---------------------------------------------------------------------------

def _group_key(members, chrome_entries, height, width):
    return (tuple((chrome_entries[li]["key"], ci, si)
                  for _, li, ci, si in members), height, width)


# Safety margin (px) around a group's ink bbox before cropping: command
# boxes already include the rasterizer's 1.5 px AA pad, this absorbs any
# residual feather.
_BBOX_PAD = 2.0


def _group_bbox(members, chrome_entries, height, width):
    """Pixel-aligned ink bbox (y0, x0, y1, x1) of a chrome group, or the
    full frame when no member reports a box. Every bbox is kept, however
    large: the compose kernel skips the tiles a layer does not cover."""
    x0 = y0 = float("inf")
    x1 = y1 = float("-inf")
    for _, li, ci, si in members:
        sb = chrome_entries[li]["seg_boxes"][ci]
        b = sb[si] if sb is not None else None
        if b is None:
            continue
        x0, y0 = min(x0, b[0]), min(y0, b[1])
        x1, y1 = max(x1, b[2]), max(y1, b[3])
    if not (x1 > x0 and y1 > y0):
        return (0, 0, height, width)
    oy = max(0, int(math.floor(y0 - _BBOX_PAD)))
    ox = max(0, int(math.floor(x0 - _BBOX_PAD)))
    ey = min(height, int(math.ceil(y1 + _BBOX_PAD)))
    ex = min(width, int(math.ceil(x1 + _BBOX_PAD)))
    return (oy, ox, ey, ex)


def _chrome_group_image(members, chrome_entries, font_tex, image_atlas,
                        tiles_y, tiles_x, height, width):
    """Cached chrome group layer → ((h, w, 4) i16 cut to the tile rect of
    the group's ink, ty0, tx0), the offsets in tiles. The layer ends where
    the frame does, so its last tile row or column may be ragged."""
    key = _group_key(members, chrome_entries, height, width)
    hit = _lru_get(_GROUP_CACHE, key)
    if hit is not None:
        return hit
    # One blocks-kernel pass rendering every member segment in z order.
    # Each member gets its own pseudo-layer so the kernel preserves the
    # member order exactly (its class order within a layer is fixed).
    layers = []
    for _, li, ci, si in members:
        ch = chrome_entries[li]
        tables = tuple(ch["parts"][j] for j in _CLS_TBL[ci])
        block = (tables, ch["bins"][ci], ch["segs"][ci][si],
                 ch["segs"][ci][si + 1])
        layers.append(_single_class_blocks(ci, block)[0])
    oy, ox, y1, x1 = _group_bbox(members, chrome_entries, height, width)
    ty0, tx0 = oy // TILE_H, ox // TILE_W
    ty1 = -(-y1 // TILE_H)
    tx1 = -(-x1 // TILE_W)
    # Only the ink's tiles are rasterized, once per content change, and
    # written as i16; every later frame then reads only those tiles.
    layer = _render_layer(tuple(layers), font_tex, image_atlas, tiles_y,
                          tiles_x, height, width, layer_i16=True,
                          tile_rect=(ty0, tx0, ty1, tx1))
    entry = (layer, ty0, tx0)
    while len(_GROUP_CACHE) > _img_cache_cap(12, font_tex.device):
        _GROUP_CACHE.pop(next(iter(_GROUP_CACHE)))
    _GROUP_CACHE[key] = entry
    return entry


def _slab_height(height: int) -> int:
    return -(-(height + 2 * OVERSCAN) // TILE_H) * TILE_H


_SHIFT_ROWS: dict = {}   # (dx, dy, clip, device) -> (6,) f32 uniform row


def _shift_row(dx: float, dy: float, clip: tuple, device) -> torch.Tensor:
    """The uniform row `frame._shift_parts` takes: (dx, dy, clip x0, y0,
    x1, y1) as f32 on `device`, memoized (the same few rows recur)."""
    key = (float(dx), float(dy), tuple(float(c) for c in clip), str(device))
    row = _SHIFT_ROWS.get(key)
    if row is None:
        row = torch.tensor([key[0], key[1], *key[2]], dtype=torch.float32,
                           device=device)
        while len(_SHIFT_ROWS) > 256:
            _SHIFT_ROWS.pop(next(iter(_SHIFT_ROWS)))
        _SHIFT_ROWS[key] = row
    return row


def _window_slab(w, gi, ci, art, caps, font_tex, image_atlas, tiles_x,
                 height, width):
    """Device-resident content-space slab for one window and class, valid
    while the scroll offset stays within ±OVERSCAN of the build offset.
    Returns (slab (slab_h, width, 4) i16, y0s, key)."""
    device = font_tex.device
    slab_h = _slab_height(height)
    dy = float(w.dy)
    key = (w.comp.uid, ci, caps, round(w.dx * 8.0),
           tuple(round(c * 4.0) for c in w.clip), tiles_x, height, width,
           str(device))
    hit = _lru_get(_SLAB_CACHE, key)
    if hit is not None:
        start = -dy - hit["y0s"]
        if 0.0 <= start <= slab_h - height:
            return hit["img"], hit["y0s"], key
    y0s = -dy - OVERSCAN
    c0, c1, c2, c3 = (float(c) for c in w.clip)
    # Device: dequantized window parts shifted (dx, -y0s); x clip baked,
    # y clip left open (it rides the compose mask, which varies with dy).
    parts = F._win_parts(w.comp.uid, caps, art["blob"], device)
    shifted = F._shift_parts(parts, _shift_row(
        float(w.dx), -y0s, (c0, -1e6, c2, 1e6), device))
    # Host: bins over the slab grid from the window-space boxes.
    boxes = art["boxes"][ci]
    b = boxes + np.array([w.dx, -y0s, w.dx, -y0s], np.float32)
    b = np.stack([np.maximum(b[:, 0], c0), b[:, 1],
                  np.minimum(b[:, 2], c2), b[:, 3]], axis=1)
    tiles_y_slab = slab_h // TILE_H
    bins, _ = R._bin_indexed(b, np.arange(b.shape[0], dtype=np.int64),
                             tiles_y_slab, tiles_x, F._CLS_KCAP[ci])
    counts = (bins >= 0).sum(axis=1).astype(np.int32)
    tables = tuple(shifted[j] for j in _CLS_TBL[ci])
    block = (tables, torch.from_numpy(bins).to(device), None,
             torch.from_numpy(counts).to(device))
    img = _render_layer(_single_class_blocks(ci, block), font_tex,
                        image_atlas, tiles_y_slab, tiles_x, slab_h, width,
                        layer_i16=True)
    while len(_SLAB_CACHE) > _img_cache_cap(24, device):
        _SLAB_CACHE.pop(next(iter(_SLAB_CACHE)))
    _SLAB_CACHE[key] = {"img": img, "y0s": y0s}
    return img, y0s, key


# ---------------------------------------------------------------------------
# The per-frame step: ONE small i16 upload (slab starts + quantized
# volatile tails + their bins), the tails' tables de-quantized on the
# device, and ONE compose-kernel launch. Per-frame traffic stays flat no
# matter how much is cached.
# ---------------------------------------------------------------------------

_DYN_PACK_CACHE: dict = {}


def _dyn_layer_cached(lb, li: int, tiles_y: int, tiles_x: int,
                      subgrid: bool):
    """Content-keyed memo of the volatile tail's quantized blob + bins:
    thumb geometry recurs across a scroll cycle, so steady frames skip the
    numpy quantize and bin work."""
    nds, ndg, ndi = lb.n_dyn_shapes, lb.n_dyn_glyphs, lb.n_dyn_images
    s0 = (lb.n_shapes - nds, lb.n_glyphs - ndg, lb.n_images - ndi)
    key = (li, tiles_y, tiles_x, subgrid, nds, ndg, ndi,
           hash(lb.shapes[s0[0]:s0[0] + nds].tobytes()),
           hash(lb.shape_clips[s0[0]:s0[0] + nds].tobytes()),
           hash(lb.glyphs[s0[1]:s0[1] + ndg].tobytes()),
           hash(lb.glyph_colors[s0[1]:s0[1] + ndg].tobytes()),
           hash(lb.glyph_clips[s0[1]:s0[1] + ndg].tobytes()),
           hash(lb.images[s0[2]:s0[2] + ndi].tobytes()),
           hash(lb.image_clips[s0[2]:s0[2] + ndi].tobytes()))
    hit = _DYN_PACK_CACHE.get(key)
    if hit is None:
        hit = F._dyn_layer(lb, li, tiles_y, tiles_x, subgrid=subgrid)
        while len(_DYN_PACK_CACHE) > 512:
            _DYN_PACK_CACHE.pop(next(iter(_DYN_PACK_CACHE)))
        _DYN_PACK_CACHE[key] = hit
    return hit


def _pack_frame_blob(scene, slab_starts, tiles_y: int, tiles_x: int):
    """→ (blob i16, dyn_meta) where dyn_meta[li] = (caps3, ks3, c0, c1).
    The volatile tail's bins cover only its tile-column range, with a mesh
    or without: K3 reads them by the global tile row on every slice. (The
    reference's XLA blend under a mesh renders tails over the full grid;
    the port has only the kernel blend.)"""
    parts = [np.asarray(slab_starts, np.int16)]
    dyn_meta = []
    for li, lb in enumerate(scene.layers):
        dyn_blob, dyn_bins, meta = _dyn_layer_cached(lb, li, tiles_y,
                                                     tiles_x, True)
        parts += [dyn_blob, dyn_bins]
        dyn_meta.append(meta)
    return np.concatenate(parts), tuple(dyn_meta)


def frame_tails(blob: torch.Tensor, font_tex, image_atlas, height: int,
                width: int, tiles_y: int, tiles_x: int, meta: tuple):
    """The device half of a frame up to the kernel: from the i16 blob on
    the device, → (starts (n_slabs,) i32, dyns, kops), the arguments of
    `compose_tiles`. Each layer's tail is de-quantized and translated to
    its sub-grid of tile columns [c0, c1) (the bins were built there);
    shape tails go to the kernel as tables and bins ("dyni"), glyph and
    image tails are pre-rendered by the blocks kernel over a transparent
    sub-grid ("dyn")."""
    ops, dyn_meta, n_slabs = meta
    starts = blob[:n_slabs].int()
    fo = n_slabs
    dyns = {}
    for li, (dyn_caps, dyn_ks, c0, c1) in enumerate(dyn_meta):
        ts = c1 - c0
        Tsub = tiles_y * ts
        x0px = c0 * TILE_W
        sub_w = min(ts * TILE_W, width - x0px)
        dyn_tables = None
        if sum(dyn_caps):
            nwords = sum(dyn_caps[F._PART_CLS[name]] * cols
                         for name, cols, _ in R._PART_SPECS)
            dyn_tables = F._dequant_parts(blob[fo:fo + nwords], dyn_caps)
            if x0px:
                # A pure translate: the clip bounds are wide open.
                dyn_tables = F._shift_parts(dyn_tables, _shift_row(
                    float(-x0px), 0.0, (-1e6, -1e6, 1e6, 1e6), blob.device))
            fo += nwords
        for ci in range(3):
            k = dyn_ks[ci]
            if k == 0:
                continue
            b = blob[fo:fo + Tsub * k].reshape(Tsub, k).int()
            fo += Tsub * k
            if dyn_tables is None or sub_w <= 0:
                continue
            tabs = tuple(dyn_tables[j] for j in _CLS_TBL[ci])
            cnt = (b >= 0).sum(dim=1, dtype=torch.int32)
            if ci == 0:
                # Shapes (thumbs, pulse dots, drag ghosts: the dominant
                # volatile content) are rasterized inline by the kernel.
                dyns[(li, ci)] = (tabs[0].contiguous(), tabs[1].contiguous(),
                                  b, cnt)
            else:
                dyns[(li, ci)] = _render_layer(
                    _single_class_blocks(ci, (tabs, b, None, cnt)),
                    font_tex, image_atlas, tiles_y, ts, height, sub_w)
    kops = []
    for op in ops:
        if op[0] == "dyn":
            li, ci = op[1], op[2]
            if (li, ci) not in dyns:
                continue
            c0, c1 = dyn_meta[li][2], dyn_meta[li][3]
            if ci == 0:
                kops.append(("dyni", li, ci, c0, c1 - c0))
            else:
                kops.append(("dyn", li, ci, c0))
        else:
            kops.append(op)
    return starts, dyns, tuple(kops)


def _compose_frame(blob, images, slabs, font_tex, image_atlas,
                   background: tuple, height: int, width: int,
                   tiles_y: int, tiles_x: int, meta: tuple,
                   rows: PlanRows | None = None, mesh=None) -> torch.Tensor:
    """meta = (ops, dyn_meta, n_slabs); ops entries:
    ("img", i, ty0, tx0): composite images[i] at that tile offset;
    ("slab", j, clip): show slabs[j] from the blob's start j, masked to
    the clip's rows;
    ("dyn", li, ci): that volatile tail, from the blob.
    `rows`: the plan's descriptor rows of its "img" and "slab" ops.
    Under `mesh`, `images`, `slabs` and `rows` hold one entry a shard (the
    plan's layers on that shard's device), and each shard blends its slice
    of tile rows of the row-padded grid; the slices are gathered.
    → the (height, width, 4) u8 frame on the blob's device."""
    starts, dyns, kops = frame_tails(blob, font_tex, image_atlas, height,
                                     width, tiles_y, tiles_x, meta)
    if mesh is None:
        return compose_tiles(starts, tuple(images), tuple(slabs), dyns,
                             ops=kops, tiles_y=tiles_y, tiles_x=tiles_x,
                             background=background, height=height,
                             width=width, rows=rows)
    _, ty_pad = F._sharded_tile_rows(tiles_y, tiles_x, mesh)
    local = ty_pad // mesh.size
    parts = []
    for s, dev in enumerate(mesh.flat):
        starts_s, dyns_s = F.replicate((starts, dyns), dev)
        parts.append(compose_tiles(
            starts_s, images[s], slabs[s], dyns_s, ops=kops,
            tiles_y=tiles_y, tiles_x=tiles_x, background=background,
            height=height, width=width, n_rows=local, row0=s * local,
            rows=rows[s]))
    return F.gather(parts, blob.device)


# Plan memo: everything about a frame that is NOT the scroll offset. A
# steady scroll frame re-validates the plan with hash lookups, computes the
# slab starts, and issues one `_compose_frame` with the plan's device
# tensors: no flattening, grouping or slab rendering.
def _img_cache_cap(cap: int, device) -> int:
    """Image-cache capacity: `cap` on a CUDA device (the reckoning beside
    `_GROUP_CACHE` keeps the caches under half a GB of device memory), a
    quarter of it on the CPU, where the same layers would sit in the
    process's own memory."""
    return cap if torch.device(device).type == "cuda" else max(2, cap // 4)


_PLAN_CACHE: dict = {}
_BLOB_DEV_CACHE: dict = {}
_STACK_CACHE: dict = {}   # (kind, member keys, device) -> tuple of layers


def _memo_stack(kind: str, keys: tuple, arrays, device):
    """Layer collection memoized by the members' content keys and the
    render mesh. A plan rebuild happens every ~128 px of scroll (the window
    uid moves with the layout's materialization bucket) and on any chrome
    change; whichever side (chrome groups or slabs) is still a cache hit
    reuses the previous collection object, and the tests key on its
    identity.

    With no mesh: a plain tuple of the cache-resident tensors (no copies;
    cropped chrome layers keep their own shapes). Under a mesh: such a
    tuple a shard, each layer committed to that shard's device once, here,
    so no frame copies a cached layer (on the layer's own device the
    tensor itself)."""
    mesh = get_render_mesh()
    key = (kind, keys, str(device), mesh)
    hit = _lru_get(_STACK_CACHE, key)
    if hit is not None:
        return hit
    if mesh is None:
        out = tuple(arrays)
    else:
        out = tuple(tuple(F.move(a, dev, "layers") for a in arrays)
                    for dev in mesh.flat)
    while len(_STACK_CACHE) > _img_cache_cap(8, device):
        _STACK_CACHE.pop(next(iter(_STACK_CACHE)))
    _STACK_CACHE[key] = out
    return out


def _build_plan(scene, windows, chrome_entries, win_art, win_caps,
                lws_by_layer, font_tex, image_atlas, tiles_y, tiles_x,
                height, width):
    device = font_tex.device
    runs = _flatten_runs(scene, chrome_entries, windows, lws_by_layer)
    ops = _group_chrome(runs)
    images, slabs, op_meta = [], [], []
    img_keys, slab_keys = [], []
    slab_src = []  # (gi, y0s) per slab, for per-frame start computation
    for op in ops:
        if op[0] == "group":
            img, ty0, tx0 = _chrome_group_image(op[1], chrome_entries,
                                                font_tex, image_atlas,
                                                tiles_y, tiles_x,
                                                height, width)
            op_meta.append(("img", len(images), ty0, tx0))
            images.append(img)
            img_keys.append(_group_key(op[1], chrome_entries, height,
                                       width))
        elif op[0] == "win":
            _, gi, ci = op
            w = windows[gi]
            slab, y0s, skey = _window_slab(w, gi, ci, win_art[gi],
                                           win_caps[gi], font_tex,
                                           image_atlas, tiles_x,
                                           height, width)
            clip = tuple(round(float(c) * 4.0) / 4.0 for c in w.clip)
            op_meta.append(("slab", len(slabs), clip))
            slabs.append(slab)
            slab_keys.append((skey, y0s))
            slab_src.append((gi, y0s))
        else:
            op_meta.append(op)  # ("dyn", li, ci): from the blob, per frame
    ops = tuple(op_meta)
    img_stack = _memo_stack("img", tuple(img_keys), images, device)
    slab_stack = _memo_stack("slab", tuple(slab_keys), slabs, device)
    # The compose kernel's descriptors of the cached layers, checked here
    # and kept while the plan lives (a shard's each under a mesh); a frame
    # fills only its tails'.
    mesh = get_render_mesh()
    rows = PlanRows(img_stack, slab_stack, ops, device) if mesh is None \
        else tuple(PlanRows(img_stack[s], slab_stack[s], ops, dev)
                   for s, dev in enumerate(mesh.flat))
    return {
        "ops": ops,
        "img_stack": img_stack,
        "slab_stack": slab_stack,
        "slab_src": tuple(slab_src),
        "slab_h": _slab_height(height),
        "rows": rows,
    }


def render_frame_composed(scene, font_tex, image_atlas):
    """Compose-path frame render → (H, W, 4) u8 frame on `font_tex`'s
    device, or None when an assumption does not hold (the caller falls
    back to the frame cache)."""
    prepared = prepare_compose_dispatch(scene, font_tex, image_atlas)
    if prepared is None:
        return None
    args, statics = prepared
    return _compose_frame(*args, **statics)


def prepare_compose_dispatch(scene, font_tex, image_atlas):
    """Everything `render_frame_composed` would pass to `_compose_frame`,
    as `(args, statics)`, or None when the compose path cannot serve the
    scene. The host half of a composed frame: plan validation (or build),
    slab starts, the frame blob and its upload."""
    device = font_tex.device
    windows = list(getattr(scene, "windows", ()) or ())
    for w in windows:
        if float(w.dy) != float(int(w.dy)):
            return None  # sub-pixel scroll: a row offset cannot show it
    tiles_x = -(-scene.width // TILE_W)
    tiles_y = -(-scene.height // TILE_H)
    height, width = scene.height, scene.width

    lws_by_layer = []
    chrome_entries = []
    win_art = {}
    slot_count: dict[int, int] = {}
    win_caps = {}
    for gi, w in enumerate(windows):
        slot = slot_count.get(w.layer, 0)
        slot_count[w.layer] = slot + 1
        caps = R._window_caps(w, slot)
        win_caps[gi] = caps
        win_art[gi] = R._window_artifacts(w, caps)
    for li, lb in enumerate(scene.layers):
        lws = [gi for gi, w in enumerate(windows) if w.layer == li]
        lws_by_layer.append(lws)
        pos_lists = tuple(tuple(windows[gi].pos[ci] for gi in lws)
                          for ci in range(3))
        chrome_entries.append(F._chrome_entry(lb, li, pos_lists, tiles_y,
                                              tiles_x, device))

    plan_key = (tuple(ch["key"] for ch in chrome_entries),
                tuple((w.comp.uid, win_caps[gi], w.layer,
                       round(float(w.dx) * 8.0),
                       tuple(round(float(c) * 4.0) for c in w.clip))
                      for gi, w in enumerate(windows)),
                # Volatile-tail PRESENCE per (layer, class): the ops list
                # only contains ("dyn", li, ci) entries for classes that
                # had dyn commands at build time, so a dyn class appearing
                # under identical chrome bytes (the exact situation
                # El.volatile exists for) must invalidate the plan or it
                # would never be composited.
                tuple((lb.n_dyn_shapes > 0, lb.n_dyn_images > 0,
                       lb.n_dyn_glyphs > 0) for lb in scene.layers),
                height, width, str(device),
                # The mesh: a plan's stacks and descriptor rows are one a
                # shard under a mesh, and a plan built under one must never
                # serve another (`render_scene_sharded` flips the mesh per
                # call without clearing caches).
                get_render_mesh())
    plan = _lru_get(_PLAN_CACHE, plan_key)
    if plan is not None:
        # slab validity: the crop must stay inside every cached slab
        for gi, y0s in plan["slab_src"]:
            start = -float(windows[gi].dy) - y0s
            if not (0.0 <= start <= plan["slab_h"] - height):
                plan = None
                break
    if plan is None:
        plan = _build_plan(scene, windows, chrome_entries, win_art,
                           win_caps, lws_by_layer, font_tex, image_atlas,
                           tiles_y, tiles_x, height, width)
        # Plans hold strong references to their layers, so the cap bounds
        # the device-memory high-water mark; it must exceed the number of
        # scroll materialization buckets a continuous scroll cycles
        # through (~5 for a 400 px sweep at the 128 px bucket size), or
        # every cycle evicts the plan it is about to need.
        while len(_PLAN_CACHE) > _img_cache_cap(6, device):
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[plan_key] = plan

    starts = [int(-float(windows[gi].dy) - y0s)
              for gi, y0s in plan["slab_src"]]
    blob, dyn_meta = _pack_frame_blob(scene, starts, tiles_y, tiles_x)
    # Scroll positions and thumb geometry recur: keep the uploaded blob
    # device-resident keyed by content, so a revisited frame state uploads
    # nothing.
    bkey = (hash(blob.tobytes()), str(device))
    blob_dev = _lru_get(_BLOB_DEV_CACHE, bkey)
    if blob_dev is None or blob_dev.shape != blob.shape:
        blob_dev = torch.from_numpy(blob).to(device)
        # Small device tensors; 512 entries cover scroll-offset × pulse-
        # phase combinations so animated steady states still recur.
        while len(_BLOB_DEV_CACHE) > 512:
            _BLOB_DEV_CACHE.pop(next(iter(_BLOB_DEV_CACHE)))
        _BLOB_DEV_CACHE[bkey] = blob_dev
    meta = (plan["ops"], dyn_meta, len(starts))
    args = (blob_dev, plan["img_stack"], plan["slab_stack"], font_tex,
            image_atlas)
    statics = dict(background=tuple(float(c) for c in scene.background[:3]),
                   height=height, width=width, tiles_y=tiles_y,
                   tiles_x=tiles_x, meta=meta, rows=plan["rows"],
                   mesh=get_render_mesh())
    return args, statics


def clear_caches() -> None:
    _GROUP_CACHE.clear()
    _SLAB_CACHE.clear()
    _DYN_PACK_CACHE.clear()
    _PLAN_CACHE.clear()
    _BLOB_DEV_CACHE.clear()
    _STACK_CACHE.clear()
