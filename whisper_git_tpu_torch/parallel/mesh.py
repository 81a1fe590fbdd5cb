"""Mesh-sharded rendering: the frame pipeline over a mesh of devices.

Counterpart of `whisper_git_tpu/parallel/mesh.py`. Two parallel axes, as
there:

  dp: data parallel over independent frames (scenes): each group of
      devices renders different frames (golden sweeps, animation batches).
  sp: spatial parallel over the tiles of one frame: each shard renders a
      contiguous slice of tiles.

The device model. JAX inserts the collectives from shardings; here they are
plain calls, in this order:

  * inputs are replicated to each shard's device (`frame.replicate`): the
    command tables, bins and bounds keep the whole grid's rows, and a
    shard's kernel reads the rows of its slice; the compose path commits
    its cached layers to every shard's device once a plan;
  * each shard launches its kernel on that device's current stream: K2 and
    K3 on a slice of whole tile rows (`n_tiles` / `tile0`, `n_rows` /
    `row0`), K1 on a slice of tiles (the batched sweep below);
  * the shards' rows are gathered onto the first device with `torch.cat`
    (`frame.gather`);
  * on repeated entries of one device (a mesh of 4 × `cuda:0`, or 8 ×
    `cpu` in the tests), replication and the gather's moves copy nothing,
    and the shards run one after another on one stream: every shard's
    launch, slice and gather runs on real kernels, but nothing runs side
    by side.

The grid is padded to a multiple of the shard count in tile rows
(`frame._sharded_tile_rows`), so each shard owns whole rows; the pad rows
are never rendered (the kernels' slices leave them out). Slicing changes no
per-pixel arithmetic, so a frame under a mesh equals the single-device
frame bit for bit.

Two consumers:

  * The frame paths the app and the bench run (render/frame.py's frame
    cache, render/compose.py's layer builds and blend) shard through
    `set_render_mesh`. `Renderer.__init__` installs a mesh when more than
    one card is visible (`maybe_auto_mesh`); `render_scene_sharded` is a
    thin convenience over this path (install the mesh, render, restore).
  * `render_batch_sharded` below is the batched dp × sp sweep only (B
    frames data-parallel × tiles spatial), through K1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..render import rasterizer as R
from ..render.meshstate import (  # noqa: F401  (public re-exports)
    available_devices,
    get_render_mesh,
    maybe_auto_mesh,
    set_render_mesh,
)


class Mesh:
    """A (dp, sp) array of `torch.device`s, the shards in row-major order
    (`flat`). An entry may repeat: a mesh of one device several times runs
    every shard there. Equal meshes (the same devices in the same places)
    hash alike, so the compose caches that key on the mesh serve both."""

    axis_names = ("dp", "sp")

    def __init__(self, devices):
        rows = [[_indexed(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangle of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                self.devices[i, j] = d
        self.shape = {"dp": len(rows), "sp": len(rows[0])}
        self.flat = tuple(self.devices.ravel())
        self.size = len(self.flat)
        self._key = (self.devices.shape, tuple(str(d) for d in self.flat))

    def __eq__(self, other):
        return isinstance(other, Mesh) and other._key == self._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.flat]})")


def _indexed(device) -> torch.device:
    """`device` with its index: a CUDA device named without one is the
    current card, as a tensor placed there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (dp, sp) mesh over `devices` (default: every card, or
    `meshstate.CPU_DEVICES` times the CPU where there is none), the first
    `n_devices` of them. dp defaults to 1 (pure spatial sharding).
    `devices` may name one device more than once."""
    devices = list(devices) if devices is not None else available_devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"{n} devices asked for, {len(devices)} available")
    dp = dp or 1
    if n % dp:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    devices = devices[:n]
    sp = n // dp
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(dp)])


def render_scene_sharded(scene, font_tex, mesh: Mesh,
                         image_atlas=None) -> np.ndarray:
    """One frame over the mesh through the production kernels.

    Installs `mesh` with `set_render_mesh` and renders with
    `render_scene_device` (the frame-cache / compose pipeline the app and
    the bench run), then restores the previous mesh. `font_tex` (and
    `image_atlas`, by default the scene's) may be arrays: they go to the
    mesh's first device. → the (H, W, 4) u8 frame on the host.

    With WGIT_FRAME_CACHE=0 the device path takes the single-shot packed
    path, which renders on one device, as does a scene over 4095 px (the
    frame cache and compose are where the mesh plumbing lives)."""
    first = mesh.flat[0]
    if not isinstance(font_tex, torch.Tensor):
        font_tex = torch.from_numpy(np.ascontiguousarray(font_tex))
    font_tex = font_tex.to(first)
    if image_atlas is None:
        image_atlas = scene.image_atlas
    if not isinstance(image_atlas, torch.Tensor):
        image_atlas = torch.from_numpy(np.ascontiguousarray(image_atlas))
    prev = get_render_mesh()
    set_render_mesh(mesh)
    try:
        return R.render_scene_device(scene, font_tex,
                                     image_atlas.to(first)).cpu().numpy()
    finally:
        set_render_mesh(prev)


def render_batch_sharded(batched_layer_data, font_tex, image_atlas,
                         background, tiles_y: int, tiles_x: int,
                         layer_sig: tuple, mesh: Mesh) -> torch.Tensor:
    """batched_layer_data: like `render_tiles`' layer_data but every tensor
    has a leading frame axis B (divisible by the mesh's dp), and the bins
    (B, T, k) a tile axis T divisible by its sp (pad with rows of −1, as
    the reference's callers do). Frames split over dp, tiles over sp: the
    shard (i, j) renders the frames of group i, for each its tiles [j·T/sp,
    (j+1)·T/sp), one K1 launch a frame. → (B, T, TILE_H, TILE_W, 4) f32,
    the canvas before the quantize, on the mesh's first device."""
    from ..render.frame import gather, replicate
    from ..render.raster_kernel import TILE_H, TILE_W, render_tiles

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    B = batched_layer_data[0][0].shape[0]
    T = batched_layer_data[0][7].shape[1]
    if B % dp or T % sp:
        raise ValueError(f"render_batch_sharded: {B} frames of {T} tiles do "
                         f"not split over a {dp} x {sp} mesh")
    per_group, local_t = B // dp, T // sp
    frames = []
    for b in range(B):
        frame = tuple(tuple(x[b] for x in layer)
                      for layer in batched_layer_data)
        tiles = []
        for j in range(sp):
            dev = mesh.devices[b // per_group, j]
            ld, ftex, iatlas = replicate((frame, font_tex, image_atlas), dev)
            tiles.append(render_tiles(
                ld, ftex, iatlas, background, tiles_y, tiles_x, layer_sig,
                tiles_y * TILE_H, tiles_x * TILE_W, n_tiles=local_t,
                tile0=j * local_t))
        frames.append(gather(tiles, mesh.flat[0]))
    return torch.stack(frames)
