"""The blocks rasterizer (K2): a CUDA kernel for Hopper and its plain
PyTorch version.

Replaces `whisper_git_tpu/render/pallas_raster.py::render_tiles_blocks`
(the Pallas TPU kernel of the frame-cache path) together with its
epilogues `assemble_planar` and `assemble_f32`, and mirrors the XLA scan
it is tested against (`whisper_git_tpu/render/frame.py::
_render_tiles_blocks_xla`).

The same per-command math as the tile rasterizer (`raster_kernel`), over
an ordered list of blocks per (layer, class) instead of one bins table per
class. `layers_blocks` is a tuple per layer of three per-class block
tuples in (shapes, glyphs, images) index order; within a layer the classes
composite in z order shapes → images → glyphs. A block is of one of three
kinds. The plain block is `(tables, bins, lo, hi)`:

  tables  the class's f32 command tables: (shapes (N,16), shape_clips
          (N,4)), (glyphs (N,8), glyph_colors (N,4), glyph_clips (N,4)) or
          (images (N,8), image_clips (N,4))
  bins    (T, k) i32 indices into those tables, −1 = empty slot
  lo      (T,) i32 first slot of each tile's row to composite, or None (0)
  hi      (T,) i32 one past the last slot

The frame cache's per-frame inputs come as the two others, which the kernel
resolves from the frame blob as it stages commands, so that no pass runs
between the blob's upload and the launch: a `WindowBlock` (a scroll
window's cached tables and pair bins, moved and cut by the window's uniform
row in the blob, its pair-bin row picked per tile from the scroll offset)
and a `TailBlock` (a layer's volatile tail, i16 tables and bins in the
blob, de-quantized as they are read). `frame.resolve_blocks` turns both
into plain blocks with torch, value for value; the plain version draws
that.

With a background the canvas starts opaque and the result is the
(H, W, 4) u8 frame; with `background=None` it starts transparent and the
result is the (H, W, 4) premultiplied RGBA layer, f32 or, with
`layer_i16`, the i16 fixed point at 1/32767 that the compose kernel reads
(`quantize_i16` of the f32 layer, value for value). `tile_rect` = (ty0, tx0,
ty1, tx1) renders only those tiles and returns the output cut to them.
`n_tiles` / `tile0`, a device mesh's slice of whole tile rows, does the same
for the rows [tile0 / tiles_x, (tile0 + n_tiles) / tiles_x) (within a
`tile_rect`, for those of its rows): the rows past the frame's tiles, which
a mesh adds to split the grid evenly, are left out, not rendered, so the
output holds the slice's rows of the frame (none for a slice of pad rows
alone, which launches nothing), and the slices of a mesh put together along
the rows give the whole output. Bins and bounds keep the whole grid's rows
whatever the slice: a mesh replicates them.

`render_tiles_blocks` is the entry point. A tensor on the CPU takes
`render_tiles_blocks_plain`; a CUDA tensor launches the kernel in
`csrc/raster_blocks.cu` (built with nvcc on first use, loaded with ctypes)
or raises. `render_tiles_blocks.launches` counts kernel launches,
`render_tiles_blocks.launches_on` those on each card.

What bounds the kernel on the card is the step functions' scalar f32
arithmetic on the pixels a command inks. Its design: work follows ink
(every command's extent, `raster_kernel.command_extents`, lets a warp skip
the commands and rows it cannot ink, bit for bit); a CTA owns a small unit
of a tile, `STRIP_W` columns by 4 x `ROWS_PER_THREAD` rows (32 x 16: 16
CTAs a tile), so a busy tile spreads over many SMs; a tile's commands are
staged in shared memory, culled to the unit, in z order; up to
`MAX_INLINE_BLOCKS` block descriptors ride in the launch's parameter block
by value (no allocation, no upload), a longer list goes through a device
array; the i16 and tile-rect epilogues write a cached layer once, with no
pass after the kernel.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from . import raster_kernel as K
from .compose_kernel import I16_SCALE

TILE_H = K.TILE_H
TILE_W = K.TILE_W

# Z order of the classes within a layer: shapes, images, glyphs.
Z_ORDER = (0, 2, 1)
_N_TABLES = (2, 3, 2)
# The columns of each class's tables, in the order the frame blob holds a
# tail's seven tables (rasterizer._PART_SPECS).
_TABLE_COLS = ((16, 4), (8, 4, 4), (8, 4))


class WindowBlock(NamedTuple):
    """A scroll window's commands of one class at this frame's offset. The
    window's uniform row in `blob` (i16 at index 8·`window`: dx, dy at 1/8
    px, the clip x0, y0, x1, y1 at 1/4 px) moves the commands and cuts
    their clips; its (row0, WR) row (at 8·(`n_windows` + `window`), a pair
    a class) and dy pick each tile's pair-bin row a = floor((y − dy) / 64)
    − row0, whose `counts` entry is the tile's `hi` where 0 ≤ a < WR and
    0 elsewhere."""
    tables: tuple          # the class's f32 tables, window coordinates
    P: torch.Tensor        # (wr_cap, tiles_x, kP) i32 pair bins
    counts: torch.Tensor   # (wr_cap, tiles_x) i32
    blob: torch.Tensor     # the frame blob, i16
    window: int
    n_windows: int


class TailBlock(NamedTuple):
    """A layer's volatile tail of one class, as the frame blob holds it:
    the tail's seven i16 tables from element `at` (`caps` rows of the
    shapes, glyphs and images), this class's (T, k) i16 bins from element
    `bins`, −1 an empty slot. Each value times its column's reciprocal
    scale is the table's f32 value; every slot of a row is drawn."""
    blob: torch.Tensor     # the frame blob, i16
    at: int
    caps: tuple
    bins: int
    k: int


def tail_tables(at: int, caps: tuple, ci: int) -> tuple:
    """The element offsets in the blob of class `ci`'s tables of a tail
    whose seven tables start at `at`."""
    fo = at + sum(caps[c] * sum(_TABLE_COLS[c]) for c in range(ci))
    out = []
    for cols in _TABLE_COLS[ci]:
        out.append(fo)
        fo += caps[ci] * cols
    return tuple(out)


def quantize_i16(layer_f32: torch.Tensor) -> torch.Tensor:
    """(h, w, 4) f32 premultiplied layer → (h, w, 4) i16 fixed point: the
    reference's values (round half to even, clipped to ±32767), kept
    interleaved as the compose kernel reads them."""
    q = torch.clamp(torch.round(layer_f32 * I16_SCALE), -32767.0, 32767.0)
    return q.to(torch.int16).contiguous()


def rect_extent(tile_rect: tuple | None, tiles_y: int, tiles_x: int,
                height: int, width: int) -> tuple:
    """→ (ty0, tx0, ty1, tx1, out_h, out_w): the tile rect (the whole grid
    for None) and the pixel extent of the output cut to it, which ends
    where the frame does."""
    ty0, tx0, ty1, tx1 = (0, 0, tiles_y, tiles_x) if tile_rect is None \
        else (int(v) for v in tile_rect)
    if not (0 <= ty0 < ty1 <= tiles_y and 0 <= tx0 < tx1 <= tiles_x):
        raise ValueError(f"{_WHO}: tile rect {(ty0, tx0, ty1, tx1)} is not "
                         f"inside the {tiles_y}x{tiles_x} grid")
    out_h = min(ty1 * TILE_H, height) - ty0 * TILE_H
    out_w = min(tx1 * TILE_W, width) - tx0 * TILE_W
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"{_WHO}: tile rect {(ty0, tx0, ty1, tx1)} lies "
                         f"outside the {width}x{height} frame")
    return ty0, tx0, ty1, tx1, out_h, out_w


def _check_modes(background, layer_i16: bool) -> None:
    if layer_i16 and background is not None:
        raise ValueError(f"{_WHO}: layer_i16 is a layer mode; it takes "
                         "background=None")


def slice_rect(n_tiles, tile0, tile_rect: tuple | None, tiles_y: int,
               tiles_x: int, height: int, width: int) -> tuple:
    """The tile rect a call renders: `tile_rect` (the whole grid for
    None) cut to the rows of the slice `n_tiles` / `tile0` and to the
    frame's tiles. → (rect or None where that leaves no row, (out_h, out_w)
    of the output)."""
    if (n_tiles is None) != (tile0 is None):
        raise ValueError(f"{_WHO}: n_tiles and tile0 go together")
    rect = (0, 0, tiles_y, tiles_x) if tile_rect is None \
        else tuple(int(v) for v in tile_rect)
    if n_tiles is not None:
        n_tiles, tile0 = int(n_tiles), int(tile0)
        if n_tiles <= 0 or tile0 < 0 or n_tiles % tiles_x \
                or tile0 % tiles_x:
            raise ValueError(f"{_WHO}: a slice of {n_tiles} tiles from tile "
                             f"{tile0} is not one of whole rows of "
                             f"{tiles_x} tiles")
        r0, r1 = tile0 // tiles_x, (tile0 + n_tiles) // tiles_x
        ty0, ty1 = max(rect[0], r0), min(rect[2], r1, tiles_y)
        out_w = rect_extent(rect, tiles_y, tiles_x, height, width)[5]
        if ty1 <= ty0:
            return None, (0, out_w)
        rect = (ty0, rect[1], ty1, rect[3])
    return rect, rect_extent(rect, tiles_y, tiles_x, height, width)[4:]


def _empty(background, layer_i16: bool, out_w: int, device):
    dtype = torch.uint8 if background is not None else \
        torch.int16 if layer_i16 else torch.float32
    return torch.empty((0, out_w, 4), dtype=dtype, device=device)


def render_tiles_blocks_plain(layers_blocks, font_tex, image_atlas,
                              background: tuple | None, tiles_y: int,
                              tiles_x: int, height: int, width: int,
                              n_tiles: int | None = None, tile0=None, *,
                              layer_i16: bool = False,
                              tile_rect: tuple | None = None
                              ) -> torch.Tensor:
    """The plain version of `render_tiles_blocks`: window and tail blocks
    resolved to plain ones (`frame.resolve_blocks`), then batched over
    tiles, looping k over each block's bin width with slots outside [lo,
    hi) masked, on the per-command functions of `render_tiles_plain`; the
    rows of the rect (`slice_rect`) are rendered, then cut to it and
    quantized."""
    from .frame import resolve_blocks

    _check_modes(background, layer_i16)
    rect, (out_h, out_w) = slice_rect(n_tiles, tile0, tile_rect, tiles_y,
                                      tiles_x, height, width)
    if rect is None:
        return _empty(background, layer_i16, out_w, font_tex.device)
    layers_blocks = resolve_blocks(layers_blocks, tiles_y, tiles_x)
    ty0, tx0, ty1, _ = rect
    rows = slice(ty0 * tiles_x, ty1 * tiles_x)
    grid = K._TileGrid(tiles_y, tiles_x, font_tex.device, rows.start,
                       rows.stop - rows.start)
    if background is not None:
        grid.fill(background)
    ftex = font_tex.float()
    atlas = image_atlas.float()
    for cls_lists in layers_blocks:
        for ci in Z_ORDER:
            for tables, bins, lo, hi in cls_lists[ci]:
                grid.scan(bins[rows], K.class_step(ci, tables, ftex, atlas),
                          lo=None if lo is None else lo[rows], hi=hi[rows])
    img = grid.image(out_h, tx0 * TILE_W + out_w)[:, tx0 * TILE_W:]
    if layer_i16:
        return quantize_i16(img)
    if background is None:
        return img.contiguous()
    return K.quantize_u8(img).contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch.
# ---------------------------------------------------------------------------

# Mirror of `BlockDesc` in csrc/raster_blocks.cu (pointers as u64).
_BLOCK_DESC = np.dtype([("t0", "<u8"), ("t1", "<u8"), ("t2", "<u8"),
                        ("bins", "<u8"), ("lo", "<u8"), ("hi", "<u8"),
                        ("cls", "<i4"), ("k", "<i4"), ("kind", "<i4"),
                        ("aux", "<i4")])
_BLOCK_PACK = struct.Struct("<6Q4i")   # the same row, field by field
_PLAIN, _WINDOW, _TAIL = 0, 1, 2       # `kind`

# Block descriptors that ride in the launch's parameter block by value
# (MAX_INLINE_BLOCKS in csrc/raster_blocks.cu: 64 x 64 B and the rest of the
# block, 4192 B, within the 32764 B a launch carries on Volta and later
# since CUDA 12.1); a longer list goes through an array in device memory.
MAX_INLINE_BLOCKS = 64
# The unit of a tile a CTA owns: STRIP_W columns by 4 * ROWS_PER_THREAD
# rows. 32 x 16 (16 CTAs a tile) measured fastest; csrc/raster_blocks.cu
# lists the pairs it compiles.
STRIP_W = 32
ROWS_PER_THREAD = 4
_OUT_U8, _OUT_F32, _OUT_I16 = 0, 1, 2


class _BlocksParams(ctypes.Structure):
    """Mirror of `BlocksParams` in csrc/raster_blocks.cu."""
    _fields_ = [("blocks", ctypes.c_void_p), ("n_blocks", ctypes.c_int),
                ("out_mode", ctypes.c_int),
                ("font_tex", ctypes.c_void_p), ("font_h", ctypes.c_int),
                ("font_w", ctypes.c_int),
                ("image_atlas", ctypes.c_void_p), ("atlas_h", ctypes.c_int),
                ("atlas_w", ctypes.c_int),
                ("bg_r", ctypes.c_float), ("bg_g", ctypes.c_float),
                ("bg_b", ctypes.c_float),
                ("tiles_x", ctypes.c_int), ("tiles_y", ctypes.c_int),
                ("ty0", ctypes.c_int), ("tx0", ctypes.c_int),
                ("rect_tx", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("out", ctypes.c_void_p),
                ("inline_blocks",
                 ctypes.c_ubyte * (MAX_INLINE_BLOCKS * _BLOCK_DESC.itemsize))]


_LIB = K.new_library_state()
_WHO = "render_tiles_blocks"


def _bind(lib) -> None:
    lib.raster_blocks_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.raster_blocks_launch.restype = ctypes.c_int
    lib.raster_blocks_error_string.argtypes = [ctypes.c_int]
    lib.raster_blocks_error_string.restype = ctypes.c_char_p
    K.check_layout(lib, (
        ("raster_blocks_params_size", ctypes.sizeof(_BlocksParams),
         "sizeof(BlocksParams)"),
        ("raster_blocks_desc_size", _BLOCK_DESC.itemsize,
         "sizeof(BlockDesc)"),
        ("raster_blocks_inline_offset", _BlocksParams.inline_blocks.offset,
         "offsetof(BlocksParams, inline_blocks)"),
        ("raster_blocks_max_inline", MAX_INLINE_BLOCKS,
         "MAX_INLINE_BLOCKS")))


def build() -> dict:
    """Build and load K2's library (see `raster_kernel.build_library`)."""
    return K.build_library(_LIB, "raster_blocks.cu", _bind)


def _check_tables(tables, ci: int, label: str, device) -> None:
    if len(tables) != _N_TABLES[ci]:
        raise ValueError(f"{_WHO}: {label} has {len(tables)} tables, class "
                         f"takes {_N_TABLES[ci]}")
    n = tables[0].shape[0]
    for tb, cols in zip(tables, _TABLE_COLS[ci]):
        K.check_tensor(tb, f"{label} table", torch.float32, device, 2, _WHO)
        if tuple(tb.shape) != (n, cols):
            raise ValueError(f"{_WHO}: {label} table is {tuple(tb.shape)}, "
                             f"expected ({n}, {cols})")


def _check_blob(blob, end: int, label: str, device) -> None:
    K.check_tensor(blob, f"{label} blob", torch.int16, device, 1, _WHO)
    if end > blob.numel():
        raise ValueError(f"{_WHO}: {label} reads the blob to {end}, past its "
                         f"{blob.numel()} values")


def _descriptor(block, ci: int, label: str, tiles_y: int, tiles_x: int,
                device) -> tuple[bytes, list]:
    """One block's descriptor row, and the tensors it points at; raises on
    what the kernel does not take."""
    T = tiles_y * tiles_x
    if isinstance(block, WindowBlock):
        _check_tables(block.tables, ci, label, device)
        P, counts, blob = block.P, block.counts, block.blob
        K.check_tensor(P, f"{label} pair bins", torch.int32, device, 3, _WHO)
        K.check_tensor(counts, f"{label} pair counts", torch.int32, device, 2,
                       _WHO)
        if P.shape[1] != tiles_x or tuple(counts.shape) != tuple(P.shape[:2]):
            raise ValueError(f"{_WHO}: {label} pair bins {tuple(P.shape)} and "
                             f"counts {tuple(counts.shape)} do not match "
                             f"{tiles_x} tile columns")
        if not 0 <= block.window < block.n_windows:
            raise ValueError(f"{_WHO}: {label} is window {block.window} of "
                             f"{block.n_windows}")
        _check_blob(blob, 8 * (block.n_windows + block.window + 1), label,
                    device)
        ptrs = [tb.data_ptr() for tb in block.tables]
        return _BLOCK_PACK.pack(
            *ptrs, *[0] * (3 - len(ptrs)), P.data_ptr(),
            blob.data_ptr() + 16 * block.window, counts.data_ptr(), ci,
            P.shape[2], _WINDOW, 8 * block.n_windows), \
            [*block.tables, P, counts, blob]
    if isinstance(block, TailBlock):
        blob = block.blob
        offs = tail_tables(block.at, block.caps, ci)
        end = block.at + sum(c * sum(cols)
                             for c, cols in zip(block.caps, _TABLE_COLS))
        _check_blob(blob, max(end, block.bins + T * block.k), label, device)
        ptrs = [blob.data_ptr() + 2 * o for o in offs]
        return _BLOCK_PACK.pack(
            *ptrs, *[0] * (3 - len(ptrs)), blob.data_ptr() + 2 * block.bins,
            0, 0, ci, block.k, _TAIL, 0), [blob]
    tables, bins, lo, hi = block
    _check_tables(tables, ci, label, device)
    K.check_tensor(bins, f"{label} bins", torch.int32, device, 2, _WHO)
    bounds = [hi] if lo is None else [lo, hi]
    for bd in bounds:
        K.check_tensor(bd, f"{label} bound", torch.int32, device, 1, _WHO)
    if bins.shape[0] != T or any(b.shape[0] != T for b in bounds):
        raise ValueError(f"{_WHO}: {label} bins or bounds do not have {T} "
                         "rows")
    ptrs = [tb.data_ptr() for tb in tables]
    return _BLOCK_PACK.pack(
        *ptrs, *[0] * (3 - len(ptrs)), bins.data_ptr(),
        0 if lo is None else lo.data_ptr(), hi.data_ptr(), ci, bins.shape[1],
        _PLAIN, 0), [*tables, bins, *bounds]


def _descriptors(layers_blocks, tiles_y: int, tiles_x: int,
                 device) -> tuple[np.ndarray, list]:
    """The flat z-ordered descriptor array of `layers_blocks`, and every
    tensor it points at (to be kept alive until the launch is enqueued)."""
    rows, keep = [], []
    for li, cls_lists in enumerate(layers_blocks):
        for ci in Z_ORDER:
            for bi, block in enumerate(cls_lists[ci]):
                row, tensors = _descriptor(
                    block, ci, f"layer {li} class {ci} block {bi}", tiles_y,
                    tiles_x, device)
                rows.append(row)
                keep += tensors
    return np.frombuffer(b"".join(rows), dtype=_BLOCK_DESC), keep


def _launch(layers_blocks, font_tex, image_atlas, background, tiles_y,
            tiles_x, height, width, layer_i16, tile_rect) -> torch.Tensor:
    device = font_tex.device
    K.check_frame_fits(height, width, tiles_y, tiles_x, _WHO)
    K.check_atlases(font_tex, image_atlas, device, _WHO)
    ty0, tx0, ty1, tx1, out_h, out_w = rect_extent(tile_rect, tiles_y,
                                                   tiles_x, height, width)
    build()
    lib = _LIB["lib"]
    desc, keep = _descriptors(layers_blocks, tiles_y, tiles_x, device)
    p = _BlocksParams()
    desc_dev = K.place_descriptors(p, "blocks", "inline_blocks", desc,
                                   MAX_INLINE_BLOCKS, device)
    p.n_blocks = len(desc)
    p.font_tex = font_tex.data_ptr()
    p.font_h, p.font_w = font_tex.shape
    p.image_atlas = image_atlas.data_ptr()
    p.atlas_h, p.atlas_w = image_atlas.shape[:2]
    if background is not None:
        p.out_mode, dtype = _OUT_U8, torch.uint8
        p.bg_r, p.bg_g, p.bg_b = (float(c) for c in background[:3])
    elif layer_i16:
        p.out_mode, dtype = _OUT_I16, torch.int16
    else:
        p.out_mode, dtype = _OUT_F32, torch.float32
    p.tiles_x, p.tiles_y = tiles_x, tiles_y
    p.ty0, p.tx0, p.rect_tx = ty0, tx0, tx1 - tx0
    p.height, p.width = out_h, out_w
    out = torch.empty((out_h, out_w, 4), device=device, dtype=dtype)
    p.out = out.data_ptr()
    rc = K.launch_on(device, lambda stream: lib.raster_blocks_launch(
        ctypes.byref(p), (ty1 - ty0) * (tx1 - tx0), STRIP_W, ROWS_PER_THREAD,
        stream))
    if rc != 0:
        raise RuntimeError("raster_blocks kernel launch failed: "
                           + lib.raster_blocks_error_string(rc).decode())
    K.count_launch(render_tiles_blocks, device)
    # The tables, bins, bounds and a device array of descriptors were alive
    # up to here; the allocator hands their memory out again only to later
    # work on this stream, which runs after the kernel.
    del keep, desc_dev
    return out


def render_tiles_blocks(layers_blocks, font_tex: torch.Tensor,
                        image_atlas: torch.Tensor,
                        background: tuple | None, tiles_y: int, tiles_x: int,
                        height: int, width: int, n_tiles: int | None = None,
                        tile0=None, *, layer_i16: bool = False,
                        tile_rect: tuple | None = None) -> torch.Tensor:
    """Rasterize block lists (see the module docstring) on `font_tex`'s
    device → the (height, width, 4) u8 frame, or with `background=None`
    the (height, width, 4) premultiplied layer, f32 or with `layer_i16`
    i16 at 1/32767; with `tile_rect` = (ty0, tx0, ty1, tx1) only those
    tiles, cut out; with `n_tiles` / `tile0`, a slice of whole tile rows
    from global tile `tile0`, the slice's rows of that output (see the
    module docstring). font_tex (FH, FW) u8 SDF atlas; image_atlas (AH, AW,
    4) u8. On the CPU this is `render_tiles_blocks_plain`; on a CUDA device
    it launches the kernel (and counts the launch in
    `render_tiles_blocks.launches`) or raises."""
    if font_tex.device.type == "cpu":
        return render_tiles_blocks_plain(layers_blocks, font_tex,
                                         image_atlas, background, tiles_y,
                                         tiles_x, height, width, n_tiles,
                                         tile0, layer_i16=layer_i16,
                                         tile_rect=tile_rect)
    if font_tex.device.type != "cuda":
        raise ValueError(f"{_WHO}: unsupported device {font_tex.device}")
    _check_modes(background, layer_i16)
    rect, (_, out_w) = slice_rect(n_tiles, tile0, tile_rect, tiles_y,
                                  tiles_x, height, width)
    if rect is None:   # pad rows alone: nothing to draw
        return _empty(background, layer_i16, out_w, font_tex.device)
    return _launch(layers_blocks, font_tex, image_atlas, background,
                   tiles_y, tiles_x, height, width, layer_i16, rect)


render_tiles_blocks.launches = 0
render_tiles_blocks.launches_on = {}
tracing.register_counters("launches.K2",
                          lambda: render_tiles_blocks.launches)
