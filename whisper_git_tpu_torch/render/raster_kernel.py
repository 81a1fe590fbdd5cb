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
or raises. `render_tiles.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .scene import MAX_LAYERS  # the parameter block holds every layer

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
    """Pixel-centre coordinates of every tile, and the canvas."""

    def __init__(self, tiles_y: int, tiles_x: int, device):
        T = tiles_y * tiles_x
        tile = torch.arange(T, device=device)
        org_x = (tile % tiles_x).float() * TILE_W
        org_y = (tile // tiles_x).float() * TILE_H
        xx = torch.arange(TILE_W, dtype=torch.float32, device=device)
        yy = torch.arange(TILE_H, dtype=torch.float32, device=device)
        self.px1 = xx + org_x[:, None] + 0.5                  # (T, TW)
        self.py1 = yy + org_y[:, None] + 0.5                  # (T, TH)
        self.tiles_y, self.tiles_x = tiles_y, tiles_x
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
        cropped."""
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


def render_tiles_plain(layer_data, font_tex, image_atlas, background: tuple,
                       tiles_y: int, tiles_x: int, layer_sig: tuple,
                       height: int, width: int) -> torch.Tensor:
    """The plain version of `render_tiles`: batched over tiles, looping k
    over each class's bin width."""
    grid = _TileGrid(tiles_y, tiles_x, font_tex.device)
    grid.fill(background)
    ftex = font_tex.float()
    atlas = image_atlas.float()
    for li, (has_s, has_g, has_i) in enumerate(layer_sig):
        (shapes, shape_clips, glyphs, glyph_colors, glyph_clips, images,
         image_clips, s_bins, g_bins, i_bins) = layer_data[li]
        if has_s:
            grid.scan(s_bins, class_step(0, (shapes, shape_clips), ftex,
                                         atlas))
        if has_i:
            grid.scan(i_bins, class_step(2, (images, image_clips), ftex,
                                         atlas))
        if has_g:
            grid.scan(g_bins, class_step(
                1, (glyphs, glyph_colors, glyph_clips), ftex, atlas))
    return quantize_u8(grid.image(height, width))


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


class _LayerTables(ctypes.Structure):
    """Mirror of `LayerTables` in csrc/raster_steps.cuh."""
    _fields_ = ([(name, ctypes.c_void_p) for name in _TABLES]
                + [("s_bins", ctypes.c_void_p), ("g_bins", ctypes.c_void_p),
                   ("i_bins", ctypes.c_void_p), ("ks", ctypes.c_int),
                   ("kg", ctypes.c_int), ("ki", ctypes.c_int),
                   ("pad", ctypes.c_int)])


class _RasterParams(ctypes.Structure):
    """Mirror of `RasterParams` in csrc/raster_steps.cuh."""
    _fields_ = [("layers", _LayerTables * MAX_LAYERS),
                ("font_tex", ctypes.c_void_p), ("font_h", ctypes.c_int),
                ("font_w", ctypes.c_int),
                ("image_atlas", ctypes.c_void_p), ("atlas_h", ctypes.c_int),
                ("atlas_w", ctypes.c_int),
                ("bg_r", ctypes.c_float), ("bg_g", ctypes.c_float),
                ("bg_b", ctypes.c_float),
                ("n_layers", ctypes.c_int), ("tiles_x", ctypes.c_int),
                ("tiles_y", ctypes.c_int), ("height", ctypes.c_int),
                ("width", ctypes.c_int), ("out", ctypes.c_void_p)]


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
    lib.raster_params_size.argtypes = []
    lib.raster_params_size.restype = ctypes.c_int
    if lib.raster_params_size() != ctypes.sizeof(_RasterParams):
        raise RuntimeError(
            f"RasterParams is {lib.raster_params_size()} bytes in C, "
            f"{ctypes.sizeof(_RasterParams)} in ctypes")


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


def _launch(layer_data, font_tex, image_atlas, background, tiles_y,
            tiles_x, layer_sig, height, width) -> torch.Tensor:
    device = font_tex.device
    T = tiles_y * tiles_x
    if len(layer_sig) > MAX_LAYERS:
        raise ValueError(f"render_tiles: {len(layer_sig)} layers; the "
                         f"kernel takes at most {MAX_LAYERS}")
    check_frame_fits(height, width, tiles_y, tiles_x, "render_tiles")
    check_atlases(font_tex, image_atlas, device, "render_tiles")
    build()
    lib = _LIB["lib"]
    p = _RasterParams()
    for li, sig in enumerate(layer_sig):
        lt = p.layers[li]
        parts = layer_data[li]
        for name, t in zip(_TABLES, parts[:7]):
            check_tensor(t, f"layer {li} {name}", torch.float32, device, 2)
            setattr(lt, name, t.data_ptr())
        for ci, (bname, kname) in enumerate((("s_bins", "ks"),
                                             ("g_bins", "kg"),
                                             ("i_bins", "ki"))):
            bins = parts[7 + ci]
            check_tensor(bins, f"layer {li} {bname}", torch.int32, device,
                         2)
            if bins.shape[0] != T:
                raise ValueError(f"render_tiles: layer {li} {bname} has "
                                 f"{bins.shape[0]} rows for {T} tiles")
            setattr(lt, bname, bins.data_ptr())
            # A class the layer does not draw gets width 0: no loop.
            setattr(lt, kname, bins.shape[1] if sig[ci] else 0)
    p.font_tex = font_tex.data_ptr()
    p.font_h, p.font_w = font_tex.shape
    p.image_atlas = image_atlas.data_ptr()
    p.atlas_h, p.atlas_w = image_atlas.shape[:2]
    p.bg_r, p.bg_g, p.bg_b = (float(c) for c in background[:3])
    p.n_layers = len(layer_sig)
    p.tiles_x, p.tiles_y = tiles_x, tiles_y
    p.height, p.width = height, width
    out = torch.empty((height, width, 4), dtype=torch.uint8, device=device)
    p.out = out.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.raster_tiles_launch(ctypes.byref(p), T, stream)
    if rc != 0:
        raise RuntimeError("raster_tiles kernel launch failed: "
                           + lib.raster_tiles_error_string(rc).decode())
    render_tiles.launches += 1
    return out


def render_tiles(layer_data, font_tex: torch.Tensor,
                 image_atlas: torch.Tensor, background: tuple,
                 tiles_y: int, tiles_x: int, layer_sig: tuple,
                 height: int, width: int) -> torch.Tensor:
    """Rasterize unpacked layer tables → (height, width, 4) u8 on
    `font_tex`'s device.

    layer_data: per layer (shapes (NS,16), shape_clips (NS,4), glyphs
    (NG,8), glyph_colors (NG,4), glyph_clips (NG,4), images (NI,8),
    image_clips (NI,4)) f32 and (s_bins, g_bins, i_bins) (T, k) i32
    padded with −1; layer_sig: per layer (has_shapes, has_glyphs,
    has_images). font_tex (FH, FW) u8 SDF atlas; image_atlas (AH, AW, 4)
    u8. On the CPU this is `render_tiles_plain`; on a CUDA device it
    launches the kernel (and counts the launch in `render_tiles.launches`)
    or raises."""
    if font_tex.device.type == "cpu":
        return render_tiles_plain(layer_data, font_tex, image_atlas,
                                  background, tiles_y, tiles_x, layer_sig,
                                  height, width)
    if font_tex.device.type != "cuda":
        raise ValueError(f"render_tiles: unsupported device {font_tex.device}")
    return _launch(layer_data, font_tex, image_atlas, background, tiles_y,
                   tiles_x, layer_sig, height, width)


render_tiles.launches = 0
