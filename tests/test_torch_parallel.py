"""The port's mesh paths (`whisper_git_tpu_torch/parallel/mesh.py`,
`render/meshstate.py`, the mesh branches of `render/frame.py` and
`render/compose.py`) on the CPU, mirroring `tests/test_parallel.py` test for
test with the same fixtures and meshes: 8 × `cpu` in the port, the 8
virtual CPU devices on the JAX side.

Each holds two things:
  * the port under its mesh equals the port on one device bit for bit:
    slicing the tile rows changes no per-pixel arithmetic;
  * the port under its mesh is within ±4 u8 of the JAX package under its
    mesh (the reference's own bound, `tests/test_parallel.py:1-12`), with
    WGIT_COMPOSE_KERNEL=interpret where the reference's test sets it.

The caches are cleared between a single-device pass and a mesh pass, as
the reference's tests do: layer caches keyed without the mesh would let the
mesh pass reuse single-device layers and certify nothing.

Then the plain versions of K1, K2 and K3 on slices (pad rows, a slice that
starts mid-frame) against their unsliced output, and the batched dp × sp
sweep against one K1 call a frame."""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import whisper_git_tpu.render.compose as C
import whisper_git_tpu.render.frame as F
import whisper_git_tpu.render.rasterizer as R
from test_torch_slice import fresh_compile_caches
from whisper_git_tpu.parallel.mesh import make_mesh as ref_make_mesh
from whisper_git_tpu.parallel.mesh import (
    render_scene_sharded as ref_render_scene_sharded)
from whisper_git_tpu.render.meshstate import set_render_mesh as ref_set_mesh
from whisper_git_tpu_torch.parallel import mesh as PM
from whisper_git_tpu_torch.render import blocks_kernel as B
from whisper_git_tpu_torch.render import compose as PC
from whisper_git_tpu_torch.render import compose_kernel as CK
from whisper_git_tpu_torch.render import frame as PF
from whisper_git_tpu_torch.render import meshstate as PMS
from whisper_git_tpu_torch.render import raster_kernel as K
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import (compose_args_to,
                                                   synthetic_compose,
                                                   synthetic_scene)

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8
OFFSETS = (0.0, 16.0, 32.0)
TOL = 4   # u8, the reference's bound for a mesh against one device


@pytest.fixture(scope="module")
def renderers():
    from whisper_git_tpu.render.renderer import get_renderer

    return get_renderer(), Renderer("cpu")


@pytest.fixture(autouse=True)
def no_mesh_after():
    yield
    PMS.set_render_mesh(None)
    ref_set_mesh(None)


def _clear():
    for mod in (C, F, PC, PF):
        mod.clear_caches()


def _u8(img) -> np.ndarray:
    return img.cpu().numpy() if isinstance(img, torch.Tensor) \
        else np.asarray(img)


def _max_diff(a, b) -> int:
    return int(np.abs(_u8(a).astype(np.int16) - _u8(b).astype(np.int16))
               .max())


def _ui(pkg: str):
    return importlib.import_module(f"{pkg}.ui"), importlib.import_module(
        f"{pkg}.ui.theme").DARK


def _scene(pkg: str, renderer, w=256, h=128):
    """`tests/test_parallel.py::_scene`, in the package `pkg`."""
    ui, dark = _ui(pkg)
    tree = ui.stack(
        ui.column(
            ui.rect(ui.text("Sharded render", bold=True,
                            color=dark.text_bright),
                    fill=dark.surface_raised, radius=6,
                    padding=(6, 10, 6, 10), width="fill", height=32),
            ui.rect(ui.path([("vline", 16, 0, 60, 2.0, (0.4, 0.6, 0.9, 1.0)),
                             ("circle", 16, 30, 5.0,
                              (0.4, 0.6, 0.9, 1.0))]),
                    ui.text("hello tiles", color=dark.text),
                    flex=1, width="fill", fill=dark.background,
                    padding=(8, 8, 8, 40)),
            width="fill", height="fill"),
        width="fill", height="fill", fill=dark.background)
    root = renderer.layout(tree, (w, h))
    return renderer.compile(root, (w, h), dark.background)


def _steady(pkg: str, renderer, off: float, w=384, h=256):
    fixtures = importlib.import_module(f"{pkg}.tools.fixtures")
    return fixtures.steady_window_scene(renderer, off, (w, h))


def _ref_frame(ref, scene):
    return np.asarray(R.render_scene_device(
        scene, ref.font_tex_device(), ref.image_atlas_device()))


def _port_frame(port, scene):
    return P.render_scene_device(scene, port.font_tex_device(),
                                 port.image_atlas_device())


def _steady_passes(renderers, port_mesh, ref_mesh, size=(384, 256),
                   offsets=OFFSETS):
    """Both packages: the steady frames at `offsets`, one device, caches
    cleared, then under the mesh. → (port single, port mesh, reference
    mesh) frame lists."""
    ref, port = renderers
    fresh_compile_caches(ref, port)
    scenes = [(_steady("whisper_git_tpu", ref, off, *size),
               _steady("whisper_git_tpu_torch", port, off, *size))
              for off in offsets]
    assert all(rs.windows and ps.windows for rs, ps in scenes)
    _clear()
    single = [_port_frame(port, ps) for _, ps in scenes]
    _clear()
    PMS.set_render_mesh(port_mesh)
    ref_set_mesh(ref_mesh)
    try:
        mesh = [_port_frame(port, ps) for _, ps in scenes]
        ref_mesh_frames = [_ref_frame(ref, rs) for rs, _ in scenes]
    finally:
        PMS.set_render_mesh(None)
        ref_set_mesh(None)
    return single, mesh, ref_mesh_frames


def _hold(single, mesh, ref_mesh_frames):
    for i, (s, m, r) in enumerate(zip(single, mesh, ref_mesh_frames)):
        assert torch.equal(m, s), f"frame {i}: the mesh changed pixels"
        assert _max_diff(m, r) <= TOL, (i, _max_diff(m, r))


def test_sharded_matches_single_chip(renderers):
    ref, port = renderers
    fresh_compile_caches(ref, port)
    rs = _scene("whisper_git_tpu", ref)
    ps = _scene("whisper_git_tpu_torch", port)
    _clear()
    single = P.render_scene(ps, port.font_tex_device())
    _clear()
    mesh = PM.make_mesh(8, dp=1, devices=CPU8)
    assert mesh.shape == {"dp": 1, "sp": 8}
    sharded = PM.render_scene_sharded(ps, port.font_tex, mesh)
    assert sharded.shape == single.shape == (128, 256, 4)
    assert np.array_equal(sharded, single)
    got_ref = ref_render_scene_sharded(rs, ref.font_tex, ref_make_mesh(8))
    assert _max_diff(sharded, got_ref) <= TOL


def test_sharded_2d_mesh(renderers):
    ref, port = renderers
    fresh_compile_caches(ref, port)
    rs = _scene("whisper_git_tpu", ref, w=384)
    ps = _scene("whisper_git_tpu_torch", port, w=384)
    _clear()
    single = P.render_scene(ps, port.font_tex_device())
    _clear()
    mesh = PM.make_mesh(8, dp=2, devices=CPU8)   # (2, 4), jointly tiles
    assert mesh.shape == {"dp": 2, "sp": 4}
    sharded = PM.render_scene_sharded(ps, port.font_tex, mesh)
    assert np.array_equal(sharded, single)
    got_ref = ref_render_scene_sharded(rs, ref.font_tex,
                                       ref_make_mesh(8, dp=2))
    assert _max_diff(sharded, got_ref) <= TOL


@pytest.mark.parametrize("compose", [True, False])
def test_production_frame_path_sharded(renderers, compose, monkeypatch):
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "1" if compose else "0")
    counts = {"K2": 0, "K3": 0}
    real_k2, real_k3 = B.render_tiles_blocks, CK.compose_tiles

    # The calls on a slice that gave rows (a CUDA tensor's launches).
    def k2(*a, **k):
        out = real_k2(*a, **k)
        counts["K2"] += k.get("n_tiles") is not None and out.shape[0] > 0
        return out

    def k3(*a, **k):
        out = real_k3(*a, **k)
        counts["K3"] += k.get("n_rows") is not None and out.shape[0] > 0
        return out

    monkeypatch.setattr(PF, "render_tiles_blocks", k2)
    monkeypatch.setattr(PC, "compose_tiles", k3)
    _hold(*_steady_passes(renderers, PM.make_mesh(8, dp=2, devices=CPU8),
                          ref_make_mesh(8, dp=2)))
    # Every frame ran sliced: 4 tile rows over 8 shards, so 4 shards hold
    # a row: K3 on each of them, 3 frames (compose, with K2 for the layers
    # it builds), or K2 on each (the frame cache).
    if compose:
        assert counts["K3"] == 3 * 4 and counts["K2"] > 0
    else:
        assert counts["K3"] == 0 and counts["K2"] == 3 * 4


def test_production_kernel_blend_sharded(renderers, monkeypatch):
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "1")
    monkeypatch.setenv("WGIT_COMPOSE_KERNEL", "interpret")
    calls = {"sharded": 0}
    real = CK.compose_tiles

    def spy(*args, **kw):
        if kw.get("n_rows") is not None:
            calls["sharded"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(PC, "compose_tiles", spy)
    _hold(*_steady_passes(renderers, PM.make_mesh(8, dp=2, devices=CPU8),
                          ref_make_mesh(8, dp=2)))
    assert calls["sharded"] >= 1, \
        "K3 never ran on a slice of tile rows under the mesh"


def test_sharded_tile_axis_not_divisible(renderers):
    # 256×192: 3 tile rows over 8 shards (5 of them pad rows alone).
    single, mesh, ref_mesh_frames = _steady_passes(
        renderers, PM.make_mesh(8, dp=1, devices=CPU8), ref_make_mesh(8),
        size=(256, 192), offsets=(16.0,))
    _hold(single, mesh, ref_mesh_frames)
    assert mesh[0].shape == (192, 256, 4)


def test_wgit_mesh_env_activation(renderers, monkeypatch):
    from whisper_git_tpu.render.meshstate import (
        maybe_auto_mesh as ref_auto_mesh)

    ref, port = renderers
    monkeypatch.setattr(PMS, "CPU_DEVICES", 8)
    monkeypatch.setenv("WGIT_MESH", "8")
    mesh = PMS.maybe_auto_mesh(torch.device("cpu"))
    assert mesh is not None and PMS.get_render_mesh() is mesh
    assert mesh.shape == {"dp": 1, "sp": 8}
    assert all(d == torch.device("cpu") for d in mesh.flat)
    ref_mesh = ref_auto_mesh()
    fresh_compile_caches(ref, port)
    rs = _steady("whisper_git_tpu", ref, 16.0)
    ps = _steady("whisper_git_tpu_torch", port, 16.0)
    _clear()
    img_mesh = _port_frame(port, ps)
    img_ref_mesh = _ref_frame(ref, rs)
    PMS.set_render_mesh(None)
    ref_set_mesh(None)
    _clear()
    img_single = _port_frame(port, ps)
    assert torch.equal(img_mesh, img_single)
    assert ref_mesh is not None and _max_diff(img_mesh, img_ref_mesh) <= TOL

    monkeypatch.setenv("WGIT_MESH", "0")
    assert PMS.maybe_auto_mesh(torch.device("cpu")) is None
    monkeypatch.setenv("WGIT_MESH", "auto")
    assert PMS.maybe_auto_mesh(torch.device("cpu")) is None  # cpu: off
    monkeypatch.setattr(PMS, "CPU_DEVICES", 1)
    monkeypatch.setenv("WGIT_MESH", "8")
    assert PMS.maybe_auto_mesh(torch.device("cpu")) is None  # one entry
    assert PMS.get_render_mesh() is None


def test_mesh_flip_without_cache_clear_is_safe(renderers, monkeypatch):
    ref, port = renderers
    monkeypatch.setattr(PMS, "CPU_DEVICES", 8)
    mesh = PM.make_mesh(4)
    assert mesh.shape == {"dp": 1, "sp": 4}
    rmesh = ref_make_mesh(4)
    fresh_compile_caches(ref, port)
    _clear()
    outs, ref_outs = {}, {}
    for label, m, rm in (("single1", None, None), ("mesh1", mesh, rmesh),
                         ("single2", None, None), ("mesh2", mesh, rmesh)):
        PMS.set_render_mesh(m)
        ref_set_mesh(rm)
        outs[label] = _port_frame(
            port, _steady("whisper_git_tpu_torch", port, 16.0, 256, 128))
        ref_outs[label] = _ref_frame(
            ref, _steady("whisper_git_tpu", ref, 16.0, 256, 128))
    assert torch.equal(outs["single1"], outs["single2"])
    assert torch.equal(outs["mesh1"], outs["mesh2"])
    assert torch.equal(outs["single1"], outs["mesh1"])
    assert _max_diff(outs["mesh1"], ref_outs["mesh1"]) <= TOL


def test_sharded_kernel_prerendered_volatile_class(renderers, monkeypatch):
    monkeypatch.setenv("WGIT_COMPOSE_KERNEL", "interpret")
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "1")
    ref, port = renderers
    tile = np.zeros((16, 16, 4), np.uint8)
    tile[:, :, 0] = 220
    tile[:, :, 3] = 255

    def render(pkg, renderer, composed):
        ui, dark = _ui(pkg)
        # Height 320 → 5 tile rows: 8 on the mesh (3 pad rows).
        tree = ui.stack(
            ui.rect(width="fill", height="fill", fill=dark.background),
            ui.row(ui.spacer(300),
                   ui.image(tile, width=16, height=16, volatile=True),
                   width="fill", height=60),
            width="fill", height="fill")
        _clear()
        root = renderer.layout(tree, (512, 320))
        scene = renderer.compile(root, (512, 320), dark.background)
        out = composed(scene, renderer.font_tex_device(),
                       renderer.image_atlas_device())
        assert out is not None
        return out

    fresh_compile_caches(ref, port)
    single = render("whisper_git_tpu_torch", port, PC.render_frame_composed)
    assert int(single[:, :, 0].max()) >= 200, "volatile image not rendered"
    PMS.set_render_mesh(PM.make_mesh(8, dp=2, devices=CPU8))
    ref_set_mesh(ref_make_mesh(8, dp=2))
    fresh_compile_caches(ref, port)
    got = render("whisper_git_tpu_torch", port, PC.render_frame_composed)
    got_ref = render("whisper_git_tpu", ref, C.render_frame_composed)
    assert torch.equal(got, single)
    assert _max_diff(got, got_ref) <= TOL, "sharded dyn-class tail"


# ---------------------------------------------------------------------------
# The plain versions on slices, and the batched sweep.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_renderer(renderers):
    return renderers[1]


def _k2_args(port, kind):
    scene = synthetic_scene(kind, 3, port.regular,
                            port.regular.texture.shape[0])
    blob, chrome, wins, meta = PF.pack_frame(scene, "cpu")
    blocks = PF.build_blocks(torch.from_numpy(blob), chrome, wins, meta)
    return (blocks, port.font_tex_device(),
            torch.from_numpy(scene.image_atlas),
            tuple(float(c) for c in scene.background[:3]), meta[0],
            meta[1], scene.height, scene.width)


@pytest.mark.parametrize("mode", ["u8", "f32", "i16", "i16 rect"])
@pytest.mark.parametrize("kind", ["volatile", "ragged"])
def test_plain_k2_slices_are_the_rows_of_the_whole(port_renderer, kind,
                                                   mode):
    args = list(_k2_args(port_renderer, kind))
    kw = {}
    if mode != "u8":
        args[3] = None
        kw["layer_i16"] = mode.startswith("i16")
    if mode == "i16 rect":
        kw["tile_rect"] = (1, 1, args[4], args[5])
    whole = B.render_tiles_blocks(*args, **kw)
    ty, tx, height = args[4], args[5], args[6]
    y0 = kw.get("tile_rect", (0,))[0] * 64
    # A slice that starts mid-frame, one past the last row (pad rows), and
    # shards of two rows that put the slices together.
    for r0, n in ((2, 2), (ty - 1, 3), (ty + 1, 2)):
        got = B.render_tiles_blocks(*args, n_tiles=n * tx, tile0=r0 * tx,
                                    **kw)
        lo = max(r0 * 64, y0) - y0
        hi = max(min((r0 + n) * 64, height) - y0, lo)
        assert torch.equal(got, whole[lo:hi]), (r0, n)
    parts = [B.render_tiles_blocks(*args, n_tiles=2 * tx, tile0=2 * s * tx,
                                   **kw) for s in range(-(-ty // 2))]
    assert torch.equal(torch.cat(parts), whole)
    with pytest.raises(ValueError):   # not whole rows
        B.render_tiles_blocks(*args, n_tiles=tx + 1, tile0=0, **kw)


@pytest.mark.parametrize("case", ["layers", "tails", "windowless"])
def test_plain_k3_slices_are_the_rows_of_the_whole(case):
    a = compose_args_to(synthetic_compose(case, 5), "cpu")
    pos = (a.pop("starts"), tuple(a.pop("images")), tuple(a.pop("slabs")),
           a.pop("dyns"))
    whole = CK.compose_tiles(*pos, **a)
    ty, height = a["tiles_y"], a["height"]
    for r0, n in ((1, 2), (ty - 1, 4), (ty + 2, 1)):
        got = CK.compose_tiles(*pos, **a, n_rows=n, row0=r0)
        lo = min(r0 * 64, height)
        assert torch.equal(got, whole[lo:max(min((r0 + n) * 64, height),
                                             lo)]), (r0, n)
    for shards in (2, 3, 8):
        L = -(-ty // shards)
        got = torch.cat([CK.compose_tiles(*pos, **a, n_rows=L, row0=s * L)
                         for s in range(shards)])
        assert torch.equal(got, whole), shards


def _k1_args(port, kind="glyphs"):
    scene = synthetic_scene(kind, 4, port.regular,
                            port.regular.texture.shape[0])
    fused, meta, ty, tx, wl = P.pack_scene(scene)
    wins = tuple(torch.from_numpy(b) for _, _, b in wl)
    layer_data, sig = P.unpack_layers(torch.from_numpy(fused), wins, meta,
                                      ty * tx)
    return (layer_data, port.font_tex_device(),
            torch.from_numpy(scene.image_atlas),
            tuple(float(c) for c in scene.background[:3]), ty, tx, sig,
            scene.height, scene.width)


def _assemble(tiles, ty, tx, height, width):
    img = tiles.reshape(ty, tx, 64, 128, 4).permute(0, 2, 1, 3, 4)
    return K.quantize_u8(img.reshape(ty * 64, tx * 128, 4)[:height, :width])


def test_plain_k1_slices_are_the_tiles_of_the_whole(port_renderer):
    args = _k1_args(port_renderer)
    ty, tx, height, width = args[4], args[5], args[7], args[8]
    T = ty * tx
    whole = K.render_tiles(*args)
    parts = [K.render_tiles(*args, n_tiles=n, tile0=t0)
             for t0, n in ((0, 3), (3, T - 7), (T - 4, 4))]
    assert all(p.dtype == torch.float32 and p.shape[1:] == (64, 128, 4)
               for p in parts)
    assert torch.equal(_assemble(torch.cat(parts), ty, tx, height, width),
                       whole)
    # A slice past the frame's tiles: bins of −1 give the bare background.
    layer_data = tuple(tuple(t if i < 7 else torch.cat(
        [t, torch.full((2 * tx, t.shape[1]), -1, dtype=t.dtype)])
        for i, t in enumerate(layer)) for layer in args[0])
    pad = K.render_tiles(layer_data, *args[1:], n_tiles=2 * tx, tile0=T)
    bg = torch.tensor(list(args[3][:3]) + [1.0])
    assert torch.equal(pad, bg.expand_as(pad))
    with pytest.raises(ValueError):
        K.render_tiles(*args, n_tiles=2)


def test_render_batch_sharded_matches_k1_a_frame(port_renderer):
    """`render_batch_sharded` with B = 4 on a 2 × 4 mesh of 8 × cpu: each
    frame's tiles, assembled and quantized, equal one K1 call on the
    frame; the reference's test pads T to a multiple of sp the same way."""
    frames, per_frame = [], []
    for kind in ("shapes", "glyphs", "images", "window"):
        args = _k1_args(port_renderer, kind)
        frames.append(args)
        per_frame.append(K.render_tiles(*args))
    # One size for all: the frames' tables and bins are stacked.
    ty, tx = frames[0][4], frames[0][5]
    assert all(a[4:6] == (ty, tx) for a in frames)
    T = ty * tx
    T_pad = -(-T // 4) * 4
    n_layers = max(len(a[6]) for a in frames)
    sig = tuple(tuple(any(a[6][li][c] for a in frames if li < len(a[6]))
                      for c in range(3)) for li in range(n_layers))

    def stack(li, i):
        ts = []
        for a in frames:
            layer = a[0][li] if li < len(a[0]) else None
            t = layer[i] if layer is not None else None
            ts.append(t)
        if i >= 7:
            k = max(t.shape[1] if t is not None else 1 for t in ts)
            out = torch.full((len(ts), T_pad, k), -1, dtype=torch.int32)
            for b, t in enumerate(ts):
                if t is not None:
                    out[b, :T, :t.shape[1]] = t
            return out
        n = max(t.shape[0] if t is not None else 0 for t in ts)
        cols = next(t.shape[1] for t in ts if t is not None)
        out = torch.zeros((len(ts), max(n, 1), cols))
        for b, t in enumerate(ts):
            if t is not None:
                out[b, :t.shape[0]] = t
        return out

    batched = tuple(tuple(stack(li, i) for i in range(10))
                    for li in range(n_layers))
    mesh = PM.make_mesh(8, dp=2, devices=CPU8)
    tiles = PM.render_batch_sharded(batched, frames[0][1], frames[0][2],
                                    frames[0][3], ty, tx, sig, mesh)
    assert tiles.shape == (4, T_pad, 64, 128, 4)
    for b in range(4):
        got = _assemble(tiles[b, :T], ty, tx, frames[b][7], frames[b][8])
        assert torch.equal(got, per_frame[b]), b
    with pytest.raises(ValueError):   # 4 frames do not split over dp = 3
        PM.render_batch_sharded(batched, frames[0][1], frames[0][2],
                                frames[0][3], ty, tx, sig,
                                PM.make_mesh(6, dp=3, devices=CPU8))
