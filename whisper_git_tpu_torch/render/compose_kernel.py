"""The compose kernel (K3): a CUDA kernel for Hopper and its plain PyTorch
version.

Replaces `whisper_git_tpu/render/pallas_compose.py::compose_tiles` (the
Pallas TPU kernel of the layer-image compose path) together with its
epilogue `pallas_raster.assemble_u8`.

Blends the plan's layers in z order over an opaque background into the
(height, width, 4) u8 frame: f32 accumulate, `src + fb·(1 − a)` a layer,
one quantize clip(x·255 + 0.5), alpha 255. The layouts are the port's own:

  images  tuple of (h, w, 4) i16 interleaved chrome layers, fixed point at
          1/32767, each cut to a tile-aligned rect whose tile offset rides
          in its op; a layer ends at its pixel extent (the frame's ragged
          edge), and what lies beyond counts as transparent
  slabs   tuple of (slab_h, w, 4) i16 scroll slabs; the frame shows rows
          [start, start + height) of a slab
  starts  (n_slabs,) i32, the first slab row of this frame, a slab
  dyns    dict (li, ci) -> (shapes f32 (cap, 16), shape_clips f32 (cap, 4),
          bins i32 (tiles_y·ts, k), counts i32 (tiles_y·ts,)) for a shape
          tail rasterized inline (op "dyni"), in the coordinates of the
          sub-grid of tile columns [c0, c0 + ts); or an (h, w, 4) f32
          premultiplied layer pre-rendered over that sub-grid (op "dyn")
  ops     z-ordered tuple of ("img", i, ty0, tx0), ("slab", j, clip),
          ("dyni", li, ci, c0, ts), ("dyn", li, ci, c0); a "dyni" or "dyn"
          whose key is not in `dyns` is skipped

`n_rows` / `row0`, a device mesh's slice, blend only the tile rows [row0,
row0 + n_rows) and give those rows of the frame; every input and every
coordinate stays the whole frame's (a layer's tile offset, a slab's start, a
tail's rows). The rows a mesh pads the grid with, past the frame's, are left
out: no CTA runs there, and a slice of pad rows alone launches nothing. The
slices of a mesh put together along the rows are the frame.

`compose_tiles` is the entry point. Tensors on the CPU take
`compose_tiles_plain`; CUDA tensors launch the kernel in
`csrc/compose_tiles.cu` (built with nvcc on first use, loaded with ctypes)
or raise. `compose_tiles.launches` counts kernel launches,
`compose_tiles.launches_on` those on each card.

What bounds the kernel on the card is bytes: 8 B a pixel of every covered
layer and slab crop read, 4 B a pixel written. It is short, so it waits for
its slowest CTA, for each op's loads in turn and, before this design, for
its own descriptors' upload. The design: a thread owns two neighbouring
pixels (one 16-byte load a layer), a CTA a strip of 2 x `ROWS_PER_THREAD`
rows of a tile (eight CTAs a tile), so the tiles under every layer spread
over more SMs; the op list is walked one op ahead, the next layer's loads
in flight while this one is blended; up to `MAX_INLINE_OPS` op descriptors
ride in the launch's parameter block by value (no allocation, no upload,
no wait), a longer list goes through a device array; and the `img` and
`slab` rows, fixed while a plan lives, are built and checked once a plan
(`PlanRows`), so a frame packs only its tails' rows.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from . import raster_kernel as K

TILE_H = K.TILE_H
TILE_W = K.TILE_W

I16_SCALE = 32767.0
_I16_INV = np.float32(1.0 / 32767.0)

_KINDS = {"img": 0, "slab": 1, "dyni": 2, "dyn": 3}
# Bytes the kernel loads at once from an op's source: an i16 or f32 pixel,
# or one f32 of a shape table.
_SRC_ALIGN = {"img": 8, "slab": 8, "dyni": 4, "dyn": 16}


# ---------------------------------------------------------------------------
# Plain version (PyTorch ops; the CPU path and the kernel's reference).
# ---------------------------------------------------------------------------

def _over_region(fb, y0: int, x0: int, src):
    """Blend premultiplied `src` (h, w, 4) f32 over fb (H, W, 3) at pixel
    offset (y0, x0), cut to fb (y0 < 0: src starts above it)."""
    if y0 < 0:
        src, y0 = src[-y0:], 0
    h = min(src.shape[0], fb.shape[0] - y0)
    w = min(src.shape[1], fb.shape[1] - x0)
    if h <= 0 or w <= 0:
        return
    src = src[:h, :w]
    region = fb[y0:y0 + h, x0:x0 + w]
    fb[y0:y0 + h, x0:x0 + w] = src[..., :3] + region * (1.0 - src[..., 3:])


def _dequant_i16(layer: torch.Tensor) -> torch.Tensor:
    return layer.float() * torch.tensor(_I16_INV, device=layer.device)


def slice_rows(n_rows, row0, tiles_y: int, height: int) -> tuple:
    """The tile rows a call blends, [r0, r1): the slice `n_rows` / `row0`
    (both or neither; the whole grid for neither) cut to the frame's tiles.
    → (r0, r1, the output's rows, ≥ 0)."""
    if (n_rows is None) != (row0 is None):
        raise ValueError(f"{_WHO}: n_rows and row0 go together")
    if n_rows is None:
        return 0, tiles_y, height
    n_rows, row0 = int(n_rows), int(row0)
    if n_rows <= 0 or row0 < 0:
        raise ValueError(f"{_WHO}: no slice of {n_rows} tile rows from row "
                         f"{row0}")
    r1 = min(row0 + n_rows, tiles_y)
    return row0, max(r1, row0), max(min(r1 * TILE_H, height)
                                    - row0 * TILE_H, 0)


def compose_tiles_plain(starts, images, slabs, dyns, *, ops: tuple,
                        tiles_y: int, tiles_x: int, background: tuple,
                        height: int, width: int, n_rows: int | None = None,
                        row0=None) -> torch.Tensor:
    """The plain version of `compose_tiles`: the same ops in the same
    order on whole-frame tensors, or on a slice's rows (a region blend for
    "img" and "dyn", a row slice for "slab", the plain shape command of
    `raster_kernel` on the sub-grid's own tile grid for "dyni")."""
    device = starts.device
    r0, r1, out_h = slice_rows(n_rows, row0, tiles_y, height)
    y_base = r0 * TILE_H   # frame row of fb's first
    fb = torch.empty((out_h, width, 3), dtype=torch.float32, device=device)
    fb[:] = torch.tensor([float(c) for c in background[:3]],
                         dtype=torch.float32, device=device)
    py = torch.arange(out_h, dtype=torch.float32, device=device) \
        + (y_base + 0.5)
    for op in ops if out_h else ():
        if op[0] == "img":
            _, i, ty0, tx0 = op
            _over_region(fb, ty0 * TILE_H - y_base, tx0 * TILE_W,
                         _dequant_i16(images[i]))
        elif op[0] == "slab":
            _, j, clip = op
            slab = slabs[j]
            start = int(starts[j]) + y_base
            lo = max(start, 0)
            hi = min(start + out_h, slab.shape[0])
            if hi <= lo:
                continue
            y0 = lo - start
            ymask = ((py >= float(clip[1])) & (py <= float(clip[3]))
                     ).float()[y0:y0 + hi - lo, None, None]
            _over_region(fb, y0, 0, _dequant_i16(slab[lo:hi]) * ymask)
        elif op[0] == "dyni":
            entry = dyns.get((op[1], op[2]))
            if entry is None:
                continue
            shapes, sclips, bins, counts = entry
            c0, ts = op[3], op[4]
            x0 = c0 * TILE_W
            sub_w = min(ts * TILE_W, width - x0)
            if sub_w <= 0:
                continue
            n = r1 - r0
            grid = K._TileGrid(tiles_y, ts, device, r0 * ts, n * ts)
            canvas = torch.zeros((n * TILE_H, ts * TILE_W, 4),
                                 dtype=torch.float32, device=device)
            canvas[:out_h, :sub_w, :3] = fb[:, x0:x0 + sub_w]
            canvas[..., 3] = 1.0
            grid.fb = canvas.reshape(n, TILE_H, ts, TILE_W, 4).permute(
                0, 2, 4, 1, 3).reshape(n * ts, 4, TILE_H, TILE_W
                                       ).contiguous()
            rows = slice(r0 * ts, r1 * ts)
            grid.scan(bins[rows], K.class_step(0, (shapes, sclips), None,
                                               None), hi=counts[rows])
            fb[:, x0:x0 + sub_w] = grid.image(out_h, sub_w)[..., :3]
        else:
            layer = dyns.get((op[1], op[2]))
            if layer is None:
                continue
            _over_region(fb, -y_base, op[3] * TILE_W, layer)
    out = torch.empty((out_h, width, 4), dtype=torch.uint8, device=device)
    out[..., :3] = K.quantize_u8(fb)
    out[..., 3] = 255
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch.
# ---------------------------------------------------------------------------

# Mirror of `ComposeOp` in csrc/compose_tiles.cu (pointers as u64).
_OP_DESC = np.dtype([("src", "<u8"), ("clips", "<u8"), ("bins", "<u8"),
                     ("counts", "<u8"), ("kind", "<i4"), ("h", "<i4"),
                     ("w", "<i4"), ("ty0", "<i4"), ("tx0", "<i4"),
                     ("ts", "<i4"), ("k", "<i4"), ("slab", "<i4"),
                     ("cy0", "<f4"), ("cy1", "<f4")])
# The same row packed field by field, in `_OP_DESC.names` order: a frame
# joins its rows' bytes, which costs less than building a numpy array.
_OP_PACK = struct.Struct("<4Q8i2f")

# Op descriptors that ride in the launch's parameter block by value
# (MAX_INLINE_OPS in csrc/compose_tiles.cu: 48 x 72 B and the rest of the
# block stay under the 4 KB a launch may carry); a longer list goes through
# an array in device memory.
MAX_INLINE_OPS = 48
# Rows of a tile a thread owns (2, 4 or 8); a CTA owns twice as many.
ROWS_PER_THREAD = 4


class _ComposeParams(ctypes.Structure):
    """Mirror of `ComposeParams` in csrc/compose_tiles.cu."""
    _fields_ = [("ops", ctypes.c_void_p), ("n_ops", ctypes.c_int),
                ("n_starts", ctypes.c_int), ("starts", ctypes.c_void_p),
                ("bg_r", ctypes.c_float), ("bg_g", ctypes.c_float),
                ("bg_b", ctypes.c_float),
                ("tiles_x", ctypes.c_int), ("tiles_y", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("row0", ctypes.c_int), ("out", ctypes.c_void_p),
                ("inline_ops",
                 ctypes.c_ubyte * (MAX_INLINE_OPS * _OP_DESC.itemsize))]


_LIB = K.new_library_state()
_WHO = "compose_tiles"


def _bind(lib) -> None:
    lib.compose_tiles_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
    lib.compose_tiles_launch.restype = ctypes.c_int
    lib.compose_tiles_error_string.argtypes = [ctypes.c_int]
    lib.compose_tiles_error_string.restype = ctypes.c_char_p
    K.check_layout(lib, (
        ("compose_tiles_params_size", ctypes.sizeof(_ComposeParams),
         "sizeof(ComposeParams)"),
        ("compose_tiles_desc_size", _OP_DESC.itemsize, "sizeof(ComposeOp)"),
        ("compose_tiles_inline_offset", _ComposeParams.inline_ops.offset,
         "offsetof(ComposeParams, inline_ops)"),
        ("compose_tiles_max_inline", MAX_INLINE_OPS, "MAX_INLINE_OPS")))


def build() -> dict:
    """Build and load K3's library (see `raster_kernel.build_library`)."""
    return K.build_library(_LIB, "compose_tiles.cu", _bind)


def _check_layer(t, label: str, dtype, device):
    K.check_tensor(t, label, dtype, device, 3, _WHO)
    if t.shape[2] != 4 or t.shape[0] == 0 or t.shape[1] == 0:
        raise ValueError(f"{_WHO}: {label} is {tuple(t.shape)}, expected a "
                         "non-empty (h, w, 4)")


def _row(label: str, kind: str, src: int, clips: int = 0, bins: int = 0,
         counts: int = 0, h: int = 0, w: int = 0, ty0: int = 0, tx0: int = 0,
         ts: int = 0, k: int = 0, slab: int = 0, cy0: float = 0.0,
         cy1: float = 0.0) -> bytes:
    """One descriptor's bytes (the fields of `_OP_DESC`, in its order), its
    source checked for the alignment the kernel's loads of that kind
    need."""
    if src % _SRC_ALIGN[kind]:
        raise ValueError(f"{_WHO}: {label} is not aligned to "
                         f"{_SRC_ALIGN[kind]} bytes")
    return _OP_PACK.pack(src, clips, bins, counts, _KINDS[kind], h, w, ty0,
                         tx0, ts, k, slab, cy0, cy1)


def _static_row(op: tuple, label: str, images, slabs, device) -> bytes:
    """The descriptor of an "img" or "slab" op, with the checks that guard
    the kernel's reads of its layer. It depends on the plan alone."""
    _static_row.built += 1
    if op[0] == "img":
        _, i, ty0, tx0 = op
        layer = images[i]
        _check_layer(layer, label, torch.int16, device)
        if ty0 < 0 or tx0 < 0:
            raise ValueError(f"{_WHO}: {label} has a negative tile offset")
        return _row(label, "img", src=layer.data_ptr(), h=layer.shape[0],
                    w=layer.shape[1], ty0=ty0, tx0=tx0)
    _, j, clip = op
    slab = slabs[j]
    _check_layer(slab, label, torch.int16, device)
    return _row(label, "slab", src=slab.data_ptr(), h=slab.shape[0],
                w=slab.shape[1], slab=j, cy0=float(clip[1]),
                cy1=float(clip[3]))


_static_row.built = 0


class PlanRows:
    """The "img" and "slab" rows of a plan's ops, built and checked once,
    when the plan is: they are fixed while the plan lives. Holds the layers
    they point at, so those live as long as the rows do. A frame hands it
    to `compose_tiles`, which then fills only the tails' rows."""

    def __init__(self, images: tuple, slabs: tuple, ops: tuple, device):
        self.images, self.slabs = images, slabs
        self.device = torch.device(device)
        self.rows = {op: _static_row(op, f"op {oi} {op[0]}", images, slabs,
                                     self.device)
                     for oi, op in enumerate(ops)
                     if op[0] in ("img", "slab")}

    def serves(self, images, slabs, device) -> bool:
        return (images is self.images and slabs is self.slabs
                and device == self.device)


def op_descriptors(images, slabs, dyns, ops: tuple, tiles_y: int,
                   device, rows: PlanRows | None = None
                   ) -> tuple[np.ndarray, list]:
    """The flat z-ordered descriptor array of `ops`, and every tensor it
    points at (to be kept alive until the launch is enqueued). "img" and
    "slab" rows come from `rows` where it was built for these very layers;
    else they are built and checked here."""
    out, keep = [], []
    kept = rows.rows if rows is not None and rows.serves(
        images, slabs, device) else {}
    for oi, op in enumerate(ops):
        kind = op[0]
        label = f"op {oi} {kind}"
        if kind not in _KINDS:
            raise ValueError(f"{_WHO}: {label}: unknown kind")
        if kind in ("img", "slab"):
            row = kept.get(op)
            if row is None:
                row = _static_row(op, label, images, slabs, device)
            out.append(row)
            keep.append((images if kind == "img" else slabs)[op[1]])
        elif kind == "dyni":
            entry = dyns.get((op[1], op[2]))
            if entry is None:
                continue
            shapes, sclips, bins, counts = entry
            c0, ts = op[3], op[4]
            K.check_tensor(shapes, f"{label} shapes", torch.float32, device,
                           2, _WHO)
            K.check_tensor(sclips, f"{label} clips", torch.float32, device,
                           2, _WHO)
            K.check_tensor(bins, f"{label} bins", torch.int32, device, 2,
                           _WHO)
            K.check_tensor(counts, f"{label} counts", torch.int32, device,
                           1, _WHO)
            n = shapes.shape[0]
            if tuple(shapes.shape) != (n, 16) \
                    or tuple(sclips.shape) != (n, 4) \
                    or bins.shape[0] != tiles_y * ts \
                    or counts.shape[0] != tiles_y * ts or c0 < 0 or ts <= 0:
                raise ValueError(
                    f"{_WHO}: {label}: shapes {tuple(shapes.shape)}, clips "
                    f"{tuple(sclips.shape)}, bins {tuple(bins.shape)}, "
                    f"counts {tuple(counts.shape)} for a {tiles_y}x{ts} "
                    f"sub-grid at column {c0}")
            out.append(_row(label, kind, src=shapes.data_ptr(),
                            clips=sclips.data_ptr(), bins=bins.data_ptr(),
                            counts=counts.data_ptr(), tx0=c0, ts=ts,
                            k=bins.shape[1]))
            keep += [shapes, sclips, bins, counts]
        else:
            layer = dyns.get((op[1], op[2]))
            if layer is None:
                continue
            _check_layer(layer, label, torch.float32, device)
            out.append(_row(label, kind, src=layer.data_ptr(),
                            h=layer.shape[0], w=layer.shape[1], tx0=op[3],
                            ts=-(-layer.shape[1] // TILE_W)))
            keep.append(layer)
    return np.frombuffer(b"".join(out), dtype=_OP_DESC), keep


def _launch(starts, images, slabs, dyns, ops, tiles_y, tiles_x, background,
            height, width, rows, r0=0, r1=None,
            out_h=None) -> torch.Tensor:
    device = starts.device
    K.check_frame_fits(height, width, tiles_y, tiles_x, _WHO)
    K.check_tensor(starts, "starts", torch.int32, device, 1, _WHO)
    if any(op[0] == "slab" and not 0 <= op[1] < starts.shape[0]
           for op in ops):
        raise ValueError(f"{_WHO}: a slab op has no entry in starts "
                         f"({starts.shape[0]})")
    build()
    lib = _LIB["lib"]
    desc, keep = op_descriptors(images, slabs, dyns, ops, tiles_y, device,
                                rows)
    p = _ComposeParams()
    desc_dev = K.place_descriptors(p, "ops", "inline_ops", desc,
                                   MAX_INLINE_OPS, device)
    p.n_ops = len(desc)
    p.n_starts = starts.shape[0]
    p.starts = starts.data_ptr()
    p.bg_r, p.bg_g, p.bg_b = (float(c) for c in background[:3])
    p.tiles_x, p.tiles_y = tiles_x, tiles_y
    p.height, p.width = height, width
    r1 = tiles_y if r1 is None else r1
    p.row0 = r0
    out = torch.empty((height if out_h is None else out_h, width, 4),
                      device=device, dtype=torch.uint8)
    p.out = out.data_ptr()
    rc = K.launch_on(device, lambda stream: lib.compose_tiles_launch(
        ctypes.byref(p), (r1 - r0) * tiles_x, ROWS_PER_THREAD, stream))
    if rc != 0:
        raise RuntimeError("compose_tiles kernel launch failed: "
                           + lib.compose_tiles_error_string(rc).decode())
    K.count_launch(compose_tiles, device)
    # The layers, tails, starts and a device array of descriptors were
    # alive up to here; the allocator hands their memory out again only to
    # later work on this stream, which runs after the kernel.
    del keep, desc_dev
    return out


def compose_tiles(starts: torch.Tensor, images: tuple, slabs: tuple,
                  dyns: dict, *, ops: tuple, tiles_y: int, tiles_x: int,
                  background: tuple, height: int, width: int,
                  n_rows: int | None = None, row0=None,
                  rows: PlanRows | None = None) -> torch.Tensor:
    """Blend the plan's layers (see the module docstring) on `starts`'
    device → the (height, width, 4) u8 frame; with `n_rows` / `row0`, a
    slice of tile rows from global row `row0`, that slice's rows of it. On
    the CPU this is `compose_tiles_plain`; on a CUDA device it launches the
    kernel (and counts the launch in `compose_tiles.launches`) or raises.
    `rows`: the plan's `PlanRows`, which spare a frame the "img" and "slab"
    rows."""
    if starts.device.type == "cpu":
        return compose_tiles_plain(starts, images, slabs, dyns, ops=ops,
                                   tiles_y=tiles_y, tiles_x=tiles_x,
                                   background=background, height=height,
                                   width=width, n_rows=n_rows, row0=row0)
    if starts.device.type != "cuda":
        raise ValueError(f"{_WHO}: unsupported device {starts.device}")
    r0, r1, out_h = slice_rows(n_rows, row0, tiles_y, height)
    if not out_h:   # pad rows alone: nothing to blend
        return torch.empty((0, width, 4), device=starts.device,
                           dtype=torch.uint8)
    return _launch(starts, images, slabs, dyns, ops, tiles_y, tiles_x,
                   background, height, width, rows, r0, r1, out_h)


compose_tiles.launches = 0
compose_tiles.launches_on = {}
