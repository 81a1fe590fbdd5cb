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
composite in z order shapes → images → glyphs. A block is
`(tables, bins, lo, hi)`:

  tables  the class's f32 command tables: (shapes (N,16), shape_clips
          (N,4)), (glyphs (N,8), glyph_colors (N,4), glyph_clips (N,4)) or
          (images (N,8), image_clips (N,4))
  bins    (T, k) i32 indices into those tables, −1 = empty slot
  lo      (T,) i32 first slot of each tile's row to composite, or None (0)
  hi      (T,) i32 one past the last slot

With a background the canvas starts opaque and the result is the
(H, W, 4) u8 frame; with `background=None` it starts transparent and the
result is the (H, W, 4) f32 premultiplied RGBA layer.

`render_tiles_blocks` is the entry point. A tensor on the CPU takes
`render_tiles_blocks_plain`; a CUDA tensor launches the kernel in
`csrc/raster_blocks.cu` (built with nvcc on first use, loaded with ctypes)
or raises. `render_tiles_blocks.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import raster_kernel as K

# Z order of the classes within a layer: shapes, images, glyphs.
Z_ORDER = (0, 2, 1)
_N_TABLES = (2, 3, 2)
_TABLE_COLS = ((16, 4), (8, 4, 4), (8, 4))


def render_tiles_blocks_plain(layers_blocks, font_tex, image_atlas,
                              background: tuple | None, tiles_y: int,
                              tiles_x: int, height: int, width: int
                              ) -> torch.Tensor:
    """The plain version of `render_tiles_blocks`: batched over tiles,
    looping k over each block's bin width with slots outside [lo, hi)
    masked, on the per-command functions of `render_tiles_plain`."""
    grid = K._TileGrid(tiles_y, tiles_x, font_tex.device)
    if background is not None:
        grid.fill(background)
    ftex = font_tex.float()
    atlas = image_atlas.float()
    for cls_lists in layers_blocks:
        for ci in Z_ORDER:
            for tables, bins, lo, hi in cls_lists[ci]:
                grid.scan(bins, K.class_step(ci, tables, ftex, atlas),
                          lo=lo, hi=hi)
    img = grid.image(height, width)
    if background is None:
        return img.contiguous()
    return K.quantize_u8(img)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch.
# ---------------------------------------------------------------------------

# Mirror of `BlockDesc` in csrc/raster_blocks.cu (pointers as u64).
_BLOCK_DESC = np.dtype([("t0", "<u8"), ("t1", "<u8"), ("t2", "<u8"),
                        ("bins", "<u8"), ("lo", "<u8"), ("hi", "<u8"),
                        ("cls", "<i4"), ("k", "<i4")])


class _BlocksParams(ctypes.Structure):
    """Mirror of `BlocksParams` in csrc/raster_blocks.cu."""
    _fields_ = [("blocks", ctypes.c_void_p), ("n_blocks", ctypes.c_int),
                ("has_background", ctypes.c_int),
                ("font_tex", ctypes.c_void_p), ("font_h", ctypes.c_int),
                ("font_w", ctypes.c_int),
                ("image_atlas", ctypes.c_void_p), ("atlas_h", ctypes.c_int),
                ("atlas_w", ctypes.c_int),
                ("bg_r", ctypes.c_float), ("bg_g", ctypes.c_float),
                ("bg_b", ctypes.c_float),
                ("tiles_x", ctypes.c_int), ("tiles_y", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("out", ctypes.c_void_p)]


_LIB = K.new_library_state()
_WHO = "render_tiles_blocks"


def _bind(lib) -> None:
    lib.raster_blocks_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.raster_blocks_launch.restype = ctypes.c_int
    lib.raster_blocks_error_string.argtypes = [ctypes.c_int]
    lib.raster_blocks_error_string.restype = ctypes.c_char_p
    for fn, want, what in (
            (lib.raster_blocks_params_size, ctypes.sizeof(_BlocksParams),
             "BlocksParams"),
            (lib.raster_blocks_desc_size, _BLOCK_DESC.itemsize,
             "BlockDesc")):
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{what} is {fn()} bytes in C, {want} in "
                               "Python")


def build() -> dict:
    """Build and load K2's library (see `raster_kernel.build_library`)."""
    return K.build_library(_LIB, "raster_blocks.cu", _bind)


def _descriptors(layers_blocks, T: int, device) -> tuple[np.ndarray, list]:
    """The flat z-ordered descriptor array of `layers_blocks`, and every
    tensor it points at (to be kept alive until the launch is enqueued)."""
    rows, keep = [], []
    for li, cls_lists in enumerate(layers_blocks):
        for ci in Z_ORDER:
            for bi, (tables, bins, lo, hi) in enumerate(cls_lists[ci]):
                label = f"layer {li} class {ci} block {bi}"
                if len(tables) != _N_TABLES[ci]:
                    raise ValueError(f"{_WHO}: {label} has {len(tables)} "
                                     f"tables, class takes {_N_TABLES[ci]}")
                n = tables[0].shape[0]
                for tb, cols in zip(tables, _TABLE_COLS[ci]):
                    K.check_tensor(tb, f"{label} table", torch.float32,
                                   device, 2, _WHO)
                    if tuple(tb.shape) != (n, cols):
                        raise ValueError(
                            f"{_WHO}: {label} table is {tuple(tb.shape)}, "
                            f"expected ({n}, {cols})")
                K.check_tensor(bins, f"{label} bins", torch.int32, device, 2,
                               _WHO)
                bounds = [hi] if lo is None else [lo, hi]
                for bd in bounds:
                    K.check_tensor(bd, f"{label} bound", torch.int32, device,
                                   1, _WHO)
                if bins.shape[0] != T or any(b.shape[0] != T for b in bounds):
                    raise ValueError(f"{_WHO}: {label} bins or bounds do not "
                                     f"have {T} rows")
                ptrs = [tb.data_ptr() for tb in tables] + [0] * (
                    3 - len(tables))
                rows.append((*ptrs, bins.data_ptr(),
                             0 if lo is None else lo.data_ptr(),
                             hi.data_ptr(), ci, bins.shape[1]))
                keep += [*tables, bins, *bounds]
    return np.array(rows, dtype=_BLOCK_DESC), keep


def _launch(layers_blocks, font_tex, image_atlas, background, tiles_y,
            tiles_x, height, width) -> torch.Tensor:
    device = font_tex.device
    T = tiles_y * tiles_x
    K.check_frame_fits(height, width, tiles_y, tiles_x, _WHO)
    K.check_atlases(font_tex, image_atlas, device, _WHO)
    build()
    lib = _LIB["lib"]
    desc, keep = _descriptors(layers_blocks, T, device)
    p = _BlocksParams()
    # One small upload a frame; at least one row so the pointer is valid.
    desc_dev = torch.from_numpy(
        np.frombuffer(desc.tobytes() or bytes(_BLOCK_DESC.itemsize),
                      np.uint8).copy()).to(device)
    p.blocks = desc_dev.data_ptr()
    p.n_blocks = len(desc)
    p.has_background = int(background is not None)
    p.font_tex = font_tex.data_ptr()
    p.font_h, p.font_w = font_tex.shape
    p.image_atlas = image_atlas.data_ptr()
    p.atlas_h, p.atlas_w = image_atlas.shape[:2]
    if background is not None:
        p.bg_r, p.bg_g, p.bg_b = (float(c) for c in background[:3])
    p.tiles_x, p.tiles_y = tiles_x, tiles_y
    p.height, p.width = height, width
    out = torch.empty((height, width, 4), device=device,
                      dtype=torch.float32 if background is None
                      else torch.uint8)
    p.out = out.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.raster_blocks_launch(ctypes.byref(p), T, stream)
    if rc != 0:
        raise RuntimeError("raster_blocks kernel launch failed: "
                           + lib.raster_blocks_error_string(rc).decode())
    render_tiles_blocks.launches += 1
    # The tables, bins, bounds and descriptors were alive up to here; the
    # allocator hands their memory out again only to later work on this
    # stream, which runs after the kernel.
    del keep, desc_dev
    return out


def render_tiles_blocks(layers_blocks, font_tex: torch.Tensor,
                        image_atlas: torch.Tensor,
                        background: tuple | None, tiles_y: int, tiles_x: int,
                        height: int, width: int, n_tiles: int | None = None,
                        tile0=None) -> torch.Tensor:
    """Rasterize block lists (see the module docstring) on `font_tex`'s
    device → the (height, width, 4) u8 frame, or with `background=None`
    the (height, width, 4) f32 premultiplied layer. font_tex (FH, FW) u8
    SDF atlas; image_atlas (AH, AW, 4) u8. On the CPU this is
    `render_tiles_blocks_plain`; on a CUDA device it launches the kernel
    (and counts the launch in `render_tiles_blocks.launches`) or raises.
    `n_tiles` / `tile0` (a contiguous slice of tiles for a device mesh)
    are not ported."""
    if n_tiles is not None or tile0 is not None:
        raise NotImplementedError(
            f"{_WHO}: n_tiles / tile0 (a mesh slice of tiles) are not "
            "ported")
    if font_tex.device.type == "cpu":
        return render_tiles_blocks_plain(layers_blocks, font_tex,
                                         image_atlas, background, tiles_y,
                                         tiles_x, height, width)
    if font_tex.device.type != "cuda":
        raise ValueError(f"{_WHO}: unsupported device {font_tex.device}")
    return _launch(layers_blocks, font_tex, image_atlas, background,
                   tiles_y, tiles_x, height, width)


render_tiles_blocks.launches = 0
