"""The tile rasterizer (K1): a CUDA kernel for Hopper and its plain
PyTorch version.

Replaces `whisper_git_tpu/render/pallas_raster.py::render_tiles_pallas`
(the Pallas TPU kernel, `_kernel_body` with `_shape_step`, `_glyph_step`
and `_image_step`) together with its epilogue `assemble_planar`, and
mirrors the XLA scan it is tested against
(`whisper_git_tpu/render/rasterizer.py::_render_tiles_impl`).

Per 64×128 tile: fill the background, then for each layer composite its
shapes, image quads and glyph quads in bin order. Shapes are rounded-rect
or capsule SDFs with coverage clip(0.5 − d) plus a border ring; glyphs
resample a 64×64 SDF atlas cell bilinearly (coverage clip(0.5 − d/0.7),
d scaled by w/uw); image quads resample an RGBA cell. Every command is
masked by its clip rect and blended with a premultiplied `over`. The
result is quantized to (H, W, 4) u8 with clip(x·255 + 0.5).

`render_tiles` is the entry point. A tensor on the CPU takes
`render_tiles_plain`; a CUDA tensor launches the kernel in
`csrc/raster_tiles.cu` (built with nvcc on first use, loaded with ctypes)
or raises. `render_tiles.launches` counts kernel launches,
`render_tiles.launches_on` those on each card (by its index).

What bounds the kernel on the card is the step functions' scalar f32
arithmetic on the pixels a command inks. Its design: a CTA owns a 32 x 16
unit of a tile (16 CTAs a tile; `UNIT_W`, `UNIT_ROWS` in the source), so a
busy tile spreads over many SMs; the tile's bins are staged in shared
memory layer by layer and class by class, culled to the unit by each
command's extent (`command_extents`), in z order; the per-layer tables ride
in the launch's parameter block, packed with `struct` in one call a layer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time

import numpy as np
import torch

from .. import tracing
from .scene import MAX_LAYERS  # the parameter block holds every layer
from .transfer import upload

TILE_H = 64
TILE_W = 128
CELL = 64          # atlas cell extent (glyph cells and image tiles)
SDF_SPREAD = 8.0   # atlas SDF spread in atlas px (128 = the edge)


# ---------------------------------------------------------------------------
# Plain version (PyTorch ops; the CPU path and the kernel's reference).
# ---------------------------------------------------------------------------

def _over(fb, rgb, a):
    """Premultiplied over of colour `rgb` (..., 3, 1|TH, 1|TW) with
    coverage `a` (..., TH, TW) onto fb (..., 4, TH, TW)."""
    a = a[:, None]
    out_rgb = rgb * a + fb[:, :3] * (1.0 - a)
    out_a = a + fb[:, 3:] * (1.0 - a)
    return torch.cat([out_rgb, out_a], dim=1)


def _clip_mask(px, py, clip):
    """px (A, 1, TW), py (A, TH, 1), clip (A, 4) → (A, TH, TW) f32."""
    c = clip[:, :, None, None]
    return ((px >= c[:, 0]) & (py >= c[:, 1])
            & (px <= c[:, 2]) & (py <= c[:, 3])).float()


def _shape_cmd(fb, px, py, c, clips):
    """One rounded-rect / capsule command per tile of the batch."""
    clip = _clip_mask(px, py, clips)
    c = c[:, :, None, None]
    is_seg = c[:, 0] == 1.0
    hx, hy = c[:, 3] * 0.5, c[:, 4] * 0.5
    cx, cy = c[:, 1] + hx, c[:, 2] + hy
    r = torch.minimum(c[:, 5], torch.minimum(hx, hy))
    qx = torch.abs(px - cx) - (hx - r)
    qy = torch.abs(py - cy) - (hy - r)
    mx, my = torch.clamp(qx, min=0.0), torch.clamp(qy, min=0.0)
    d_rect = (torch.sqrt(mx * mx + my * my)
              + torch.clamp(torch.maximum(qx, qy), max=0.0) - r)
    ax, ay, bx, by = c[:, 1], c[:, 2], c[:, 3], c[:, 4]
    abx, aby = bx - ax, by - ay
    denom = torch.clamp(abx * abx + aby * aby, min=1e-6)
    t = torch.clamp(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
    ex, ey = px - (ax + t * abx), py - (ay + t * aby)
    d_seg = torch.sqrt(ex * ex + ey * ey) - c[:, 5]
    d = torch.where(is_seg, d_seg, d_rect)
    cov_fill = torch.clamp(0.5 - d, 0.0, 1.0) * clip
    fb = _over(fb, c[:, 7:10], cov_fill * c[:, 10])
    bw = c[:, 6]
    has_border = (~is_seg) & (bw > 0.0)
    cov_b = (torch.clamp(0.5 - d, 0.0, 1.0)
             * torch.clamp(d + bw + 0.5, 0.0, 1.0)
             * clip * has_border.float())
    return _over(fb, c[:, 11:14], cov_b * c[:, 14])


def _sample_weights(pix, origin, extent, atlas_extent):
    """Bilinear resampling weights (A, P, CELL): row p holds the tent
    weights clip(1 − |s − j|) of cell texel j for screen coordinate
    pix[p], zeroed outside the sampled region. pix (A, P); the rest (A,)."""
    origin, extent, atlas_extent = (v[:, None] for v in
                                    (origin, extent, atlas_extent))
    s = (pix - origin) / torch.clamp(extent, min=1e-6) * atlas_extent - 0.5
    j = torch.arange(CELL, dtype=torch.float32, device=pix.device)
    w = torch.clamp(1.0 - torch.abs(s[..., None] - j), 0.0, 1.0)
    inside = ((s > -1.0) & (s < atlas_extent)).float()
    return w * inside[..., None]


def _cells(tex, u, v):
    """Gather the CELL×CELL texture patches at (v, u) (A,) → (A, CELL,
    CELL[, C]), start indices clamped into the texture like
    `lax.dynamic_slice`."""
    v0 = torch.clamp(v.int(), 0, tex.shape[0] - CELL).long()
    u0 = torch.clamp(u.int(), 0, tex.shape[1] - CELL).long()
    j = torch.arange(CELL, device=tex.device)
    return tex[(v0[:, None] + j)[:, :, None], (u0[:, None] + j)[:, None, :]]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _glyph_cmd(fb, px1, py1, g, colors, clips, ftex, px, py):
    """One SDF glyph per tile of the batch. The two resampling products
    mirror the XLA scan's bf16 casts as XLA executes them
    (rasterizer.py `_glyphs_pass`): weights and texels rounded to bf16,
    products and sums in f32. Under jit XLA drops the bf16 round trip of
    the first product's result, so the intermediate stays f32 here too."""
    clip = _clip_mask(px, py, clips)
    x, y, w, h, u, v, uw, uh = g.unbind(1)
    patch = _cells(ftex, u, v)
    wy = _sample_weights(py1, y, h, uh)                   # (A, TH, CELL)
    wx = _sample_weights(px1, x, w, uw)                   # (A, TW, CELL)
    enc0 = torch.bmm(_bf16(wy), _bf16(patch))
    enc = torch.bmm(enc0, _bf16(wx).transpose(1, 2))
    sdf_atlas = (128.0 - enc) * (SDF_SPREAD / 128.0)
    screen_scale = w / torch.clamp(uw, min=1e-6)
    d = sdf_atlas * screen_scale[:, None, None]
    cov = torch.clamp(0.5 - d / 0.7, 0.0, 1.0) * clip
    return _over(fb, colors[:, :3, None, None], cov * colors[:, 3, None, None])


def _image_cmd(fb, px1, py1, q, clips, atlas, px, py):
    """One RGBA image quad per tile of the batch (f32 resampling)."""
    clip = _clip_mask(px, py, clips)
    x, y, w, h, u, v, uw, uh = q.unbind(1)
    patch = _cells(atlas, u, v)                           # (A, CELL, CELL, 4)
    wy = _sample_weights(py1, y, h, uh)
    wx = _sample_weights(px1, x, w, uw)
    rgba = torch.einsum("apj,ajkc,aqk->acpq", wy, patch, wx) / 255.0
    a = rgba[:, 3] * clip
    return _over(fb, rgba[:, :3], a)


class _TileGrid:
    """Pixel-centre coordinates of every tile, and the canvas; with
    `tile0` / `n_tiles` of the tiles [tile0, tile0 + n_tiles) alone, each
    at its place in the grid (`image` then takes whole tile rows)."""

    def __init__(self, tiles_y: int, tiles_x: int, device, tile0: int = 0,
                 n_tiles: int | None = None):
        T = tiles_y * tiles_x if n_tiles is None else n_tiles
        tile = tile0 + torch.arange(T, device=device)
        org_x = (tile % tiles_x).float() * TILE_W
        org_y = (tile // tiles_x).float() * TILE_H
        xx = torch.arange(TILE_W, dtype=torch.float32, device=device)
        yy = torch.arange(TILE_H, dtype=torch.float32, device=device)
        self.px1 = xx + org_x[:, None] + 0.5                  # (T, TW)
        self.py1 = yy + org_y[:, None] + 0.5                  # (T, TH)
        self.tiles_y, self.tiles_x = T // tiles_x, tiles_x
        self.fb = torch.zeros((T, 4, TILE_H, TILE_W), dtype=torch.float32,
                              device=device)

    def fill(self, background: tuple):
        for ch in range(3):
            self.fb[:, ch] = torch.tensor(background[ch],
                                          dtype=torch.float32)
        self.fb[:, 3] = 1.0

    def scan(self, bins, step, lo=None, hi=None):
        """Composite slot k of every tile's bins row, k ascending. A slot
        holding −1, or outside the tile's [lo, hi), is skipped, which the
        XLA scan does by compositing with zero coverage (an exact no-op)."""
        fb = self.fb
        for k in range(bins.shape[1]):
            idx = bins[:, k]
            ok = idx >= 0
            if lo is not None:
                ok = ok & (lo <= k)
            if hi is not None:
                ok = ok & (hi > k)
            act = torch.nonzero(ok).squeeze(1)
            if act.numel() == 0:
                continue
            px1, py1 = self.px1[act], self.py1[act]
            fb[act] = step(fb[act], idx[act].long(), px1, py1,
                           px1[:, None, :], py1[:, :, None])

    def image(self, height: int, width: int) -> torch.Tensor:
        """The canvas as one (height, width, 4) f32 image, ragged edge
        cropped (of a slice: its rows, from its first)."""
        img = self.fb.reshape(self.tiles_y, self.tiles_x, 4, TILE_H, TILE_W)
        img = img.permute(0, 3, 1, 4, 2).reshape(self.tiles_y * TILE_H,
                                                 self.tiles_x * TILE_W, 4)
        return img[:height, :width]


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def class_step(ci: int, tables, ftex, atlas):
    """The per-slot step of class `ci` (0 shapes, 1 glyphs, 2 images) over
    its tables, for `_TileGrid.scan`. ftex and atlas are f32."""
    if ci == 0:
        shapes, shape_clips = tables
        return lambda f, i, px1, py1, px, py: _shape_cmd(
            f, px, py, shapes[i], shape_clips[i])
    if ci == 1:
        glyphs, glyph_colors, glyph_clips = tables
        return lambda f, i, px1, py1, px, py: _glyph_cmd(
            f, px1, py1, glyphs[i], glyph_colors[i], glyph_clips[i], ftex,
            px, py)
    images, image_clips = tables
    return lambda f, i, px1, py1, px, py: _image_cmd(
        f, px1, py1, images[i], image_clips[i], atlas, px, py)


# One pixel more around every extent, against rounding (EXTENT_PAD in
# csrc/raster_steps.cuh).
EXTENT_PAD = 1.0


def command_extents(ci: int, tables) -> torch.Tensor:
    """The extent of every command of class `ci` (0 shapes, 1 glyphs, 2
    images) → (N, 4) f32 (x0, y0, x1, y1): the rectangle of pixel centres,
    bounds inclusive, outside which the command's coverage is exactly 0, so
    that compositing it there changes no bit. The mirror of
    `command_extent` in csrc/raster_steps.cuh, which the kernels skip by.

    A shape: its box grown by 0.5 px (a capsule's segment box by half
    width + 0.5 px), beyond which `clamp(0.5 - d)` is 0. A glyph or image
    quad: grown by one texel (w / uw px), beyond which both taps of an axis
    weigh 0; for a glyph only when `8 * (w / uw) / 0.7 >= 0.5`, since the
    distance outside the quad is 8 * w / uw and a smaller one still covers.
    Every class: grown by EXTENT_PAD, then cut by the clip rect."""
    t0, clip = tables[0], tables[-1]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=t0.device)
    if ci == 0:
        seg = t0[:, 0] == 1.0
        g = torch.where(seg, torch.clamp(t0[:, 5], min=0.0), 0.0) \
            + (0.5 + EXTENT_PAD)
        far_x = torch.where(seg, t0[:, 3], t0[:, 1] + t0[:, 3])
        far_y = torch.where(seg, t0[:, 4], t0[:, 2] + t0[:, 4])
        x0 = torch.minimum(t0[:, 1], far_x) - g
        x1 = torch.maximum(t0[:, 1], far_x) + g
        y0 = torch.minimum(t0[:, 2], far_y) - g
        y1 = torch.maximum(t0[:, 2], far_y) + g
    else:
        w = torch.clamp(t0[:, 2], min=1e-6)
        h = torch.clamp(t0[:, 3], min=1e-6)
        gx = torch.where(t0[:, 6] > 0.0, w / t0[:, 6] + EXTENT_PAD, inf)
        gy = torch.where(t0[:, 7] > 0.0, h / t0[:, 7] + EXTENT_PAD, inf)
        if ci == 1:
            d = SDF_SPREAD * (t0[:, 2] / torch.clamp(t0[:, 6], min=1e-6))
            bounded = d / 0.7 >= 0.5
            gx = torch.where(bounded, gx, inf)
            gy = torch.where(bounded, gy, inf)
        x0, x1 = t0[:, 0] - gx, (t0[:, 0] + w) + gx
        y0, y1 = t0[:, 1] - gy, (t0[:, 1] + h) + gy
    return torch.stack([torch.maximum(x0, clip[:, 0]),
                        torch.maximum(y0, clip[:, 1]),
                        torch.minimum(x1, clip[:, 2]),
                        torch.minimum(y1, clip[:, 3])], dim=1)


def extent_tile_pixels(ext: torch.Tensor, tile: torch.Tensor, tiles_x: int,
                       height: int | None = None, width: int | None = None
                       ) -> torch.Tensor:
    """How many pixel centres of tile `tile[m]` lie inside extent `ext[m]`
    → (M,) i64: the pixels a bin entry has to be computed on. With
    `height` and `width`, only pixels of the frame count (its last tile row
    and column may be ragged)."""
    def span(lo, hi, org, size, limit):
        last = org + size - 1
        if limit is not None:
            last = torch.clamp(last, max=limit - 1)
        a = torch.clamp(torch.ceil(lo.double() - 0.5), min=org.double())
        b = torch.clamp(torch.floor(hi.double() - 0.5), max=last.double())
        return torch.clamp(b - a + 1.0, min=0.0)

    tile = tile.long()
    nx = span(ext[:, 0], ext[:, 2], (tile % tiles_x) * TILE_W, TILE_W, width)
    ny = span(ext[:, 1], ext[:, 3], (tile // tiles_x) * TILE_H, TILE_H,
              height)
    return (nx * ny).long()


def render_tiles_plain(layer_data, font_tex, image_atlas, background: tuple,
                       tiles_y: int, tiles_x: int, layer_sig: tuple,
                       height: int, width: int, n_tiles: int | None = None,
                       tile0: int | None = None) -> torch.Tensor:
    """The plain version of `render_tiles`: batched over tiles, looping k
    over each class's bin width; of a slice, its tiles alone."""
    t0 = _check_slice(n_tiles, tile0)
    grid = _TileGrid(tiles_y, tiles_x, font_tex.device, t0, n_tiles)
    grid.fill(background)
    ftex = font_tex.float()
    atlas = image_atlas.float()
    rows = slice(t0, t0 + grid.px1.shape[0])
    for li, (has_s, has_g, has_i) in enumerate(layer_sig):
        (shapes, shape_clips, glyphs, glyph_colors, glyph_clips, images,
         image_clips, s_bins, g_bins, i_bins) = layer_data[li]
        s_bins, g_bins, i_bins = s_bins[rows], g_bins[rows], i_bins[rows]
        if has_s:
            grid.scan(s_bins, class_step(0, (shapes, shape_clips), ftex,
                                         atlas))
        if has_i:
            grid.scan(i_bins, class_step(2, (images, image_clips), ftex,
                                         atlas))
        if has_g:
            grid.scan(g_bins, class_step(
                1, (glyphs, glyph_colors, glyph_clips), ftex, atlas))
    if n_tiles is not None:
        return grid.fb.permute(0, 2, 3, 1).contiguous()
    return quantize_u8(grid.image(height, width))


def _check_slice(n_tiles, tile0) -> int:
    """The first tile of a slice `n_tiles` / `tile0` (both or neither),
    0 for none; raises on a slice that is not one."""
    if (n_tiles is None) != (tile0 is None):
        raise ValueError("render_tiles: n_tiles and tile0 go together")
    if n_tiles is None:
        return 0
    if int(n_tiles) <= 0 or int(tile0) < 0:
        raise ValueError(f"render_tiles: no slice of {n_tiles} tiles from "
                         f"tile {tile0}")
    return int(tile0)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch.
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
HEADERS = ("raster_steps.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_TABLES = ("shapes", "shape_clips", "glyphs", "glyph_colors", "glyph_clips",
           "images", "image_clips")
_BINS = ("s_bins", "g_bins", "i_bins")

# `RasterParams` of csrc/raster_tiles.cu as bytes: a `LayerTables` row a
# layer (its ten pointers, the three widths, the pad), empty rows up to
# MAX_LAYERS, then the atlases, background, grid and output.
_LAYER_PACK = struct.Struct("<10Q4i")
_TAIL_PACK = struct.Struct("<Q2iQ2i3f5iQ2i")
_NO_LAYER = bytes(_LAYER_PACK.size)


def new_library_state() -> dict:
    """The state of one kernel library: loaded handle, path, whether this
    process compiled it, nvcc's seconds and output, and a lock."""
    return {"lib": None, "path": None, "built": False, "seconds": 0.0,
            "log": "", "lock": threading.Lock()}


_LIB = new_library_state()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: install the CUDA toolkit or "
                           "set CUDA_HOME")
    return path


def _source_digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_library(state: dict, source: str, bind) -> dict:
    """Build (once per source hash) `csrc/<source>` into a shared library
    under `_build/` and load it; `bind(lib)` declares its C functions.
    Returns {"path", "built": compiled in this call, "seconds": compile
    time, "log": nvcc's output (ptxas register and spill report)}. Raises
    with nvcc's stderr when the build fails."""
    with state["lock"]:
        if state["lib"] is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            stem = os.path.splitext(source)[0]
            path = os.path.join(BUILD_DIR,
                                f"lib{stem}-{_source_digest(source)}.so")
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC_DIR, source)]
                t0 = time.perf_counter()
                res = subprocess.run(cmd, capture_output=True, text=True)
                state["seconds"] = time.perf_counter() - t0
                state["log"] = res.stdout + res.stderr
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                        f"{res.stderr}")
                os.replace(tmp, path)
                state["built"] = True
            lib = ctypes.CDLL(path)
            bind(lib)
            state["lib"] = lib
            state["path"] = path
        return {k: state[k] for k in ("path", "built", "seconds", "log")}


def _bind(lib) -> None:
    lib.raster_tiles_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
    lib.raster_tiles_launch.restype = ctypes.c_int
    lib.raster_tiles_error_string.argtypes = [ctypes.c_int]
    lib.raster_tiles_error_string.restype = ctypes.c_char_p
    check_layout(lib, (("raster_params_size",
                        MAX_LAYERS * _LAYER_PACK.size + _TAIL_PACK.size,
                        "sizeof(RasterParams)"),))


def check_layout(lib, checks) -> None:
    """Hold a library's view of its parameter structs against the Python
    mirrors: `checks` lists (C function returning an int, the value the
    mirror has, what it is). Raises on the first that differs."""
    for fn_name, want, what in checks:
        fn = getattr(lib, fn_name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{what} is {fn()} in C, {want} in Python")


def place_descriptors(p, ptr_field: str, inline_field: str, desc, cap: int,
                      device):
    """Hand a launch its descriptor array `desc` (a numpy structured
    array): up to `cap` rows are copied into the parameter block's
    `inline_field` and ride in the launch by value (no allocation, no
    upload, no wait); a longer list is uploaded and `ptr_field` set to the
    device array. → that array, to keep alive until the launch is enqueued,
    or None."""
    if len(desc) <= cap:
        if len(desc):
            ctypes.memmove(
                ctypes.addressof(p) + getattr(type(p), inline_field).offset,
                desc.ctypes.data, desc.nbytes)
        return None
    desc_dev = upload(desc.view(np.uint8).copy(), device)
    setattr(p, ptr_field, desc_dev.data_ptr())
    return desc_dev


def launch_on(device, launch):
    """Call `launch(stream)` with `device` the calling thread's current
    CUDA device and `stream` PyTorch's current stream there, as the integer
    a C function takes → what `launch` returns. The device is switched, and
    back, only where it is not the current one already."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        return launch(_current_stream(index))
    with torch.cuda.device(index):
        return launch(_current_stream(index))


def count_launch(kernel, device) -> None:
    """One launch of `kernel` (a wrapper) enqueued on `device`: counted in
    `kernel.launches`, and in `kernel.launches_on` under the card's
    index."""
    kernel.launches += 1
    kernel.launches_on[device.index] = \
        kernel.launches_on.get(device.index, 0) + 1


def _current_stream(index: int) -> int:
    # The stream's handle without a Stream object around it, where this
    # PyTorch has the call: a launch's host time counts on a short kernel.
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def build() -> dict:
    """Build and load K1's library (see `build_library`)."""
    return build_library(_LIB, "raster_tiles.cu", _bind)


def check_tensor(t: torch.Tensor, name: str, dtype, device, ndim: int,
                 who: str = "render_tiles"):
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{who}: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor on {device}; got {tuple(t.shape)} {t.dtype} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def check_atlases(font_tex, image_atlas, device, who: str):
    check_tensor(font_tex, "font_tex", torch.uint8, device, 2, who)
    check_tensor(image_atlas, "image_atlas", torch.uint8, device, 3, who)
    if min(font_tex.shape) < CELL or min(image_atlas.shape[:2]) < CELL \
            or image_atlas.shape[2] != 4:
        raise ValueError(f"{who}: atlases must hold at least one "
                         f"{CELL}x{CELL} cell (image atlas RGBA)")


def check_frame_fits(height, width, tiles_y, tiles_x, who: str):
    if not (0 < height <= tiles_y * TILE_H and 0 < width <= tiles_x * TILE_W):
        raise ValueError(f"{who}: {width}x{height} frame does not "
                         f"fit {tiles_x}x{tiles_y} tiles")


def _layer_row(li: int, sig: tuple, parts, device, T: int,
               at_least: bool = False) -> bytes:
    """Layer `li`'s `LayerTables` row: its seven f32 tables and three bins
    tables checked (contiguous, 2-d, on `device`; the bins' T rows, or with
    `at_least` T or more) and their pointers packed, a class the layer does
    not draw at width 0. Raises on the first tensor the kernel cannot
    take."""
    if len(parts) != 10:
        raise ValueError(f"render_tiles: layer {li} has {len(parts)} "
                         "tensors, expected 7 tables and 3 bins")
    f32, i32 = torch.float32, torch.int32
    for i, t in enumerate(parts):
        if t.dtype is not (f32 if i < 7 else i32) or t.ndim != 2 \
                or not t.is_contiguous() or t.device != device:
            check_tensor(t, f"layer {li} {(_TABLES + _BINS)[i]}",
                         f32 if i < 7 else i32, device, 2)
    s_bins, g_bins, i_bins = parts[7:]
    if not s_bins.shape[0] == g_bins.shape[0] == i_bins.shape[0] \
            or (s_bins.shape[0] < T if at_least else s_bins.shape[0] != T):
        raise ValueError(f"render_tiles: layer {li} bins have "
                         f"{s_bins.shape[0]}, {g_bins.shape[0]} and "
                         f"{i_bins.shape[0]} rows for {T} tiles")
    return _LAYER_PACK.pack(
        *[t.data_ptr() for t in parts],
        s_bins.shape[1] if sig[0] else 0, g_bins.shape[1] if sig[1] else 0,
        i_bins.shape[1] if sig[2] else 0, 0)


def _pack_params(rows, font_tex, image_atlas, background, tiles_y, tiles_x,
                height, width, out, tile0: int = 0) -> bytes:
    """The `RasterParams` block: the layers' rows (`_layer_row`), empty rows
    up to MAX_LAYERS, the atlases, background, grid, output and the first
    tile launched (an f32 `out` is a slice's canvas)."""
    return b"".join(rows) + _NO_LAYER * (MAX_LAYERS - len(rows)) \
        + _TAIL_PACK.pack(font_tex.data_ptr(), *font_tex.shape,
                          image_atlas.data_ptr(), *image_atlas.shape[:2],
                          *(float(c) for c in background[:3]), len(rows),
                          tiles_x, tiles_y, height, width, out.data_ptr(),
                          tile0, int(out.dtype == torch.float32))


def _launch(layer_data, font_tex, image_atlas, background, tiles_y,
            tiles_x, layer_sig, height, width, n_tiles=None,
            tile0=None) -> torch.Tensor:
    device = font_tex.device
    t0 = _check_slice(n_tiles, tile0)
    T = tiles_y * tiles_x if n_tiles is None else t0 + n_tiles
    if len(layer_sig) > MAX_LAYERS:
        raise ValueError(f"render_tiles: {len(layer_sig)} layers; the "
                         f"kernel takes at most {MAX_LAYERS}")
    check_frame_fits(height, width, tiles_y, tiles_x, "render_tiles")
    check_atlases(font_tex, image_atlas, device, "render_tiles")
    if _LIB["lib"] is None:
        build()
    lib = _LIB["lib"]
    rows = [_layer_row(li, sig, layer_data[li], device, T,
                       n_tiles is not None)
            for li, sig in enumerate(layer_sig)]
    if n_tiles is None:
        out = torch.empty((height, width, 4), dtype=torch.uint8,
                          device=device)
    else:
        out = torch.empty((n_tiles, TILE_H, TILE_W, 4), dtype=torch.float32,
                          device=device)
    params = _pack_params(rows, font_tex, image_atlas, background, tiles_y,
                          tiles_x, height, width, out, t0)
    rc = launch_on(device, lambda stream: lib.raster_tiles_launch(
        params, T - t0, stream))
    if rc != 0:
        raise RuntimeError("raster_tiles kernel launch failed: "
                           + lib.raster_tiles_error_string(rc).decode())
    count_launch(render_tiles, device)
    return out


def render_tiles(layer_data, font_tex: torch.Tensor,
                 image_atlas: torch.Tensor, background: tuple,
                 tiles_y: int, tiles_x: int, layer_sig: tuple,
                 height: int, width: int, n_tiles: int | None = None,
                 tile0: int | None = None) -> torch.Tensor:
    """Rasterize unpacked layer tables → (height, width, 4) u8 on
    `font_tex`'s device.

    layer_data: per layer (shapes (NS,16), shape_clips (NS,4), glyphs
    (NG,8), glyph_colors (NG,4), glyph_clips (NG,4), images (NI,8),
    image_clips (NI,4)) f32 and (s_bins, g_bins, i_bins) (T, k) i32
    padded with −1; layer_sig: per layer (has_shapes, has_glyphs,
    has_images). font_tex (FH, FW) u8 SDF atlas; image_atlas (AH, AW, 4)
    u8. On the CPU this is `render_tiles_plain`; on a CUDA device it
    launches the kernel (and counts the launch in `render_tiles.launches`)
    or raises.

    `n_tiles` / `tile0`, a slice for a device mesh (the reference's
    `parallel/mesh.py::_render_tile_slice`): only the tiles [tile0, tile0
    + n_tiles), each with its pixel origin and bins row from its global id
    (the bins keep at least tile0 + n_tiles rows; a row past the frame's
    tiles, −1 throughout, gives the bare background) → their canvas before
    the quantize, (n_tiles, TILE_H, TILE_W, 4) f32, whole tiles."""
    if font_tex.device.type == "cpu":
        return render_tiles_plain(layer_data, font_tex, image_atlas,
                                  background, tiles_y, tiles_x, layer_sig,
                                  height, width, n_tiles, tile0)
    if font_tex.device.type != "cuda":
        raise ValueError(f"render_tiles: unsupported device {font_tex.device}")
    return _launch(layer_data, font_tex, image_atlas, background, tiles_y,
                   tiles_x, layer_sig, height, width, n_tiles, tile0)


render_tiles.launches = 0
render_tiles.launches_on = {}
tracing.register_counters("launches.K1", lambda: render_tiles.launches)
