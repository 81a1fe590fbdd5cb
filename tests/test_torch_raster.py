"""The plain version of the port's tile kernel against the reference
rasterizer: the XLA scan as the packed path runs it (jit, on the CPU) and
the Pallas kernel in interpret mode. Same unpacked inputs, handed over as
numpy arrays."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_git_tpu.render.rasterizer as R
from whisper_git_tpu.render import pallas_raster as PR
from whisper_git_tpu_torch.render import raster_kernel as K
from whisper_git_tpu_torch.render.rasterizer import render_scene
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import KINDS, synthetic_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_renderer():
    return Renderer("cpu")


@pytest.fixture(scope="module")
def graft():
    import __graft_entry__ as g

    return g._compiled_scene(256, 128)


def _inputs(scene):
    """Unpacked layer tables of `scene` as the reference makes them."""
    fused, meta, ty, tx, win_list = R.pack_scene(scene)
    wins = tuple(jnp.asarray(b) for _, _, b in win_list)
    layer_data, sig = R.unpack_layers(jnp.asarray(fused), wins, meta, ty * tx)
    return layer_data, sig, ty, tx


def _plain(layer_data, sig, ty, tx, font, atlas, scene):
    ld = tuple(tuple(torch.from_numpy(np.array(a)) for a in layer)
               for layer in layer_data)
    bg = tuple(float(c) for c in scene.background[:3])
    return K.render_tiles_plain(ld, torch.from_numpy(np.array(font)),
                                torch.from_numpy(np.array(atlas)), bg, ty,
                                tx, sig, scene.height, scene.width).numpy()


def _xla(layer_data, sig, ty, tx, font, atlas, scene):
    bg = tuple(float(c) for c in scene.background[:3])
    tiles = R._render_tiles(layer_data, jnp.asarray(font),
                            jnp.asarray(atlas), bg, ty, tx, sig)
    return R.assemble_image(np.asarray(tiles), ty, tx, scene.height,
                            scene.width)


def _stats(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 2).mean())


def _assert_glyph_bound(a, b, label):
    """The reference's Pallas-vs-XLA bound from bf16 resampling
    (tests/test_pallas_raster.py)."""
    assert a.shape == b.shape, label
    mx, share = _stats(a, b)
    assert mx <= 8, (label, mx)
    assert share < 0.01, (label, share)


def test_plain_matches_xla_on_fixture_scene(graft):
    renderer, scene = graft
    layer_data, sig, ty, tx = _inputs(scene)
    args = (layer_data, sig, ty, tx, renderer.font_tex, scene.image_atlas,
            scene)
    got, want = _plain(*args), _xla(*args)
    assert got.shape == want.shape == (128, 256, 4)
    _assert_glyph_bound(got, want, "graft vs xla")


def test_plain_matches_pallas_interpret(graft):
    renderer, scene = graft
    layer_data, sig, ty, tx = _inputs(scene)
    got = _plain(layer_data, sig, ty, tx, renderer.font_tex,
                 scene.image_atlas, scene)
    font = jnp.asarray(renderer.font_tex)
    atlas = jnp.asarray(scene.image_atlas)
    font_cells, font_cols = PR.cellify(font.astype(jnp.bfloat16))
    image_cells, img_cols = PR.cellify(atlas.astype(jnp.bfloat16),
                                       channels=4)
    bg = tuple(float(c) for c in scene.background[:3])
    tiles = PR.render_tiles_pallas(layer_data, font_cells, font_cols,
                                   image_cells, img_cols, bg, ty, tx, sig,
                                   interpret=True)
    want = np.asarray(PR.assemble_planar(tiles, ty, tx, scene.height,
                                         scene.width))
    _assert_glyph_bound(got, want, "graft vs pallas interpret")


def test_plain_empty_scene_is_background():
    """No commands → background only (tests/test_pallas_raster.py
    `test_pallas_empty_scene`)."""
    from whisper_git_tpu_torch.render.scene import Scene

    scene = Scene(layers=[], width=128, height=64,
                  background=(0.1, 0.2, 0.3, 1.0),
                  image_atlas=np.zeros((64, 64, 4), np.uint8))
    layer_data, sig, ty, tx = _inputs(scene)
    font = np.zeros((64, 64), np.uint8)
    img = _plain(layer_data, sig, ty, tx, font, scene.image_atlas, scene)
    assert img.shape == (64, 128, 4)
    assert abs(int(img[0, 0, 0]) - int(0.1 * 255 + 0.5)) <= 1
    assert abs(int(img[0, 0, 2]) - int(0.3 * 255 + 0.5)) <= 1
    assert (img[..., 3] == 255).all()
    assert np.array_equal(img, _xla(layer_data, sig, ty, tx, font,
                                    scene.image_atlas, scene))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_xla_on_synthetic_scenes(port_renderer, kind):
    scene = synthetic_scene(kind, 3, port_renderer.regular,
                            port_renderer.regular.texture.shape[0])
    layer_data, sig, ty, tx = _inputs(scene)
    args = (layer_data, sig, ty, tx, port_renderer.font_tex,
            scene.image_atlas, scene)
    got, want = _plain(*args), _xla(*args)
    assert got.shape == want.shape == (scene.height, scene.width, 4)
    if kind in ("shapes", "empty"):
        assert _stats(got, want)[0] <= 1, kind
    else:
        _assert_glyph_bound(got, want, kind)


def test_image_quads_are_drawn(port_renderer):
    """The image-quad scene really composites images: it differs from the
    same scene with its image class switched off."""
    scene = synthetic_scene("images", 5, port_renderer.regular,
                            port_renderer.regular.texture.shape[0])
    layer_data, sig, ty, tx = _inputs(scene)
    assert sig[0][2]
    args = (layer_data, sig, ty, tx, port_renderer.font_tex,
            scene.image_atlas, scene)
    no_images = tuple((s, g, False) for s, g, _ in sig)
    with_images = _plain(*args)
    without = _plain(layer_data, no_images, ty, tx, port_renderer.font_tex,
                     scene.image_atlas, scene)
    assert (np.abs(with_images.astype(int) - without.astype(int)) > 8).mean() \
        > 0.01


def test_render_scene_defaults_to_the_scenes_image_atlas(port_renderer):
    scene = synthetic_scene("images", 2, port_renderer.regular,
                            port_renderer.regular.texture.shape[0], 256, 128)
    font = port_renderer.font_tex_device()
    assert np.array_equal(
        render_scene(scene, font),
        render_scene(scene, font, torch.from_numpy(scene.image_atlas)))


def test_wrapper_takes_plain_version_on_cpu(graft):
    renderer, scene = graft
    layer_data, sig, ty, tx = _inputs(scene)
    ld = tuple(tuple(torch.from_numpy(np.array(a)) for a in layer)
               for layer in layer_data)
    font = torch.from_numpy(renderer.font_tex)
    atlas = torch.from_numpy(scene.image_atlas)
    bg = tuple(float(c) for c in scene.background[:3])
    before = K.render_tiles.launches
    a = K.render_tiles(ld, font, atlas, bg, ty, tx, sig, scene.height,
                       scene.width)
    b = K.render_tiles_plain(ld, font, atlas, bg, ty, tx, sig, scene.height,
                             scene.width)
    assert torch.equal(a, b)
    assert K.render_tiles.launches == before  # no kernel launch on the CPU


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(K.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setitem(K._LIB, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build()


# ---- the extent of a command: the kernels skip by it ---------------------------

EXT_W, EXT_H = 256, 128     # 2 x 2 tiles


def _clip_rows(rng, n, boxes):
    """Clip rects (n, 4): a third wide open, the rest cutting their
    command's box somewhere inside it."""
    clips = np.tile(np.array([-1e6, -1e6, 1e6, 1e6], np.float32), (n, 1))
    for i in range(n):
        if i % 3 == 0:
            continue
        x0, y0, x1, y1 = boxes[i]
        cx = np.sort(rng.uniform(x0 - 4.0, x1 + 4.0, 2))
        cy = np.sort(rng.uniform(y0 - 4.0, y1 + 4.0, 2))
        clips[i] = (cx[0], cy[0], cx[1], cy[1])
    return clips


def _random_class_tables(ci: int, seed: int, n: int = 12):
    """Seeded commands of class `ci` on an EXT_W x EXT_H frame, with the
    cases the extent has a rule for: a capsule and a bordered rounded rect
    (shapes), a glyph scaled below the point where its coverage outside the
    quad vanishes (w / uw < 0.04375), clips that cut the quad."""
    rng = np.random.default_rng(1000 * ci + seed)
    x = rng.uniform(-10.0, EXT_W - 20.0, n).astype(np.float32)
    y = rng.uniform(-10.0, EXT_H - 20.0, n).astype(np.float32)
    w = rng.uniform(2.0, 70.0, n).astype(np.float32)
    h = rng.uniform(2.0, 50.0, n).astype(np.float32)
    if ci == 0:
        t0 = np.zeros((n, 16), np.float32)
        t0[:, 1], t0[:, 2], t0[:, 3], t0[:, 4] = x, y, w, h
        t0[:, 5] = rng.uniform(0.0, 12.0, n)           # radius
        t0[:, 6] = np.where(np.arange(n) % 2 == 0, 0.0,
                            rng.uniform(0.5, 4.0, n))   # border width
        t0[:, 7:15] = rng.uniform(0.2, 1.0, (n, 8))
        seg = np.arange(n) % 4 == 1                     # capsules
        t0[seg, 0] = 1.0
        t0[seg, 3] = x[seg] + rng.uniform(-40.0, 40.0, seg.sum())
        t0[seg, 4] = y[seg] + rng.uniform(-30.0, 30.0, seg.sum())
        t0[seg, 5] = rng.uniform(0.5, 6.0, seg.sum())   # half width
        far_x = np.where(seg, t0[:, 3], x + w)
        far_y = np.where(seg, t0[:, 4], y + h)
        boxes = np.stack([np.minimum(x, far_x), np.minimum(y, far_y),
                          np.maximum(x, far_x), np.maximum(y, far_y)], 1)
        tables = (t0, _clip_rows(rng, n, boxes))
    else:
        t0 = np.zeros((n, 8), np.float32)
        t0[:, 0], t0[:, 1], t0[:, 2], t0[:, 3] = x, y, w, h
        t0[:, 4] = rng.integers(0, 3, n) * 64.0
        t0[:, 5] = rng.integers(0, 2, n) * 64.0
        t0[:, 6] = rng.uniform(8.0, 64.0, n)
        t0[:, 7] = rng.uniform(8.0, 64.0, n)
        if ci == 1:
            # tiny glyphs: 8 * (w / uw) / 0.7 < 0.5, ink all over the clip
            t0[:3, 2], t0[:3, 6] = (1.5, 2.0, 0.9), (48.0, 64.0, 40.0)
            assert (t0[:3, 2] / t0[:3, 6] < 0.04375).all()
        boxes = np.stack([x, y, x + t0[:, 2], y + h], 1)
        clips = _clip_rows(rng, n, boxes)
        if ci == 1:
            colors = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
            tables = (t0, colors, clips)
        else:
            tables = (t0, clips)
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32))
                 for t in tables)


def _extent_case(ci: int, seed: int):
    """Every command of the seeded tables composited alone over a random
    canvas by the plain step → (tables, extents (N, 4), changed (N, H, W)
    bool: the pixels whose bits the command changed, inside (N, H, W) bool:
    the pixel centres inside its extent)."""
    tables = _random_class_tables(ci, seed)
    rng = np.random.default_rng(77 + seed)
    ftex = torch.from_numpy(rng.integers(0, 256, (128, 192)).astype(
        np.float32))
    atlas = torch.from_numpy(rng.integers(0, 256, (128, 192, 4)).astype(
        np.float32))
    ext = K.command_extents(ci, tables)
    step = K.class_step(ci, tables, ftex, atlas)
    ty, tx = EXT_H // K.TILE_H, EXT_W // K.TILE_W
    canvas = torch.from_numpy(rng.uniform(0.0, 1.0, (
        ty * tx, 4, K.TILE_H, K.TILE_W)).astype(np.float32))
    px = torch.arange(EXT_W, dtype=torch.float32) + 0.5
    py = torch.arange(EXT_H, dtype=torch.float32) + 0.5
    changed, inside = [], []
    for n in range(tables[0].shape[0]):
        grid = K._TileGrid(ty, tx, "cpu")
        grid.fb = canvas.clone()
        grid.scan(torch.full((ty * tx, 1), n, dtype=torch.int32), step)
        before = K._TileGrid(ty, tx, "cpu")
        before.fb = canvas
        a = grid.image(EXT_H, EXT_W).contiguous().view(torch.int32)
        b = before.image(EXT_H, EXT_W).contiguous().view(torch.int32)
        changed.append((a != b).any(dim=2))
        x0, y0, x1, y1 = ext[n]
        inside.append(((py >= y0) & (py <= y1))[:, None]
                      & ((px >= x0) & (px <= x1))[None, :])
    return tables, ext, torch.stack(changed), torch.stack(inside)


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("ci", (0, 1, 2))
def test_extent_bounds_every_bit_a_command_changes(ci, seed):
    """Outside `command_extents` the plain step's coverage is exactly 0:
    compositing the command there leaves every bit of the canvas as it was,
    so a kernel that skips by the extent changes nothing."""
    tables, ext, changed, inside = _extent_case(ci, seed)
    assert ext.shape == (tables[0].shape[0], 4) and ext.dtype == torch.float32
    assert not (changed & ~inside).any(), (
        ci, seed, torch.nonzero(changed & ~inside)[:4])
    # the commands do ink, and the extent is not the whole frame for most
    assert changed.flatten(1).any(dim=1).float().mean() > 0.6
    assert inside.flatten(1).float().mean(dim=1).median() < 0.5


def test_extent_of_a_tiny_glyph_is_its_clip_alone():
    """A glyph with 8 * (w / uw) / 0.7 < 0.5 still covers outside its quad
    (the reference's coverage of a zero texel there is not 0), so only its
    clip bounds it; one at the threshold or above is bounded by its quad
    grown by a texel."""
    glyphs = torch.tensor([[40.0, 30.0, 1.5, 3.0, 0.0, 0.0, 48.0, 48.0],
                           [40.0, 30.0, 12.0, 16.0, 0.0, 0.0, 48.0, 48.0]])
    colors = torch.ones((2, 4))
    clips = torch.tensor([[10.0, 5.0, 200.0, 100.0]] * 2)
    ext = K.command_extents(1, (glyphs, colors, clips))
    assert ext[0].tolist() == [10.0, 5.0, 200.0, 100.0]
    grow = 12.0 / 48.0 + K.EXTENT_PAD
    assert ext[1].tolist() == pytest.approx(
        [40.0 - grow, 30.0 - 16.0 / 48.0 - K.EXTENT_PAD, 52.0 + grow,
         46.0 + 16.0 / 48.0 + K.EXTENT_PAD])
    # and the tiny one does ink far outside its quad
    ftex = torch.zeros((64, 64))
    fb = torch.zeros((1, 4, K.TILE_H, K.TILE_W))
    px1 = (torch.arange(K.TILE_W, dtype=torch.float32) + 0.5)[None]
    py1 = (torch.arange(K.TILE_H, dtype=torch.float32) + 0.5)[None]
    out = K._glyph_cmd(fb, px1, py1, glyphs[:1], colors[:1], clips[:1], ftex,
                       px1[:, None, :], py1[:, :, None])
    assert out[0, 3, 50, 100] > 0.1


@pytest.mark.parametrize("ci", (0, 1, 2))
def test_extent_tile_pixels_counts_the_centres_inside(ci):
    """`extent_tile_pixels`, which the smoke test's bound is counted with:
    the pixel centres of a tile inside an extent, for every (command,
    tile) pair."""
    tables, ext, _, inside = _extent_case(ci, 0)
    ty, tx = EXT_H // K.TILE_H, EXT_W // K.TILE_W
    n = ext.shape[0]
    tile = torch.arange(ty * tx).repeat(n)
    got = K.extent_tile_pixels(ext.repeat_interleave(ty * tx, dim=0), tile,
                               tx).reshape(n, ty, tx)
    want = inside.reshape(n, ty, K.TILE_H, tx, K.TILE_W).sum(dim=(2, 4))
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < n * EXT_W * EXT_H


def test_extent_tile_pixels_stops_at_the_frames_ragged_edge():
    ext = torch.tensor([[-1e6, -1e6, 1e6, 1e6]] * 4)
    tile = torch.arange(4)
    assert K.extent_tile_pixels(ext, tile, 2).tolist() == [64 * 128] * 4
    assert K.extent_tile_pixels(ext, tile, 2, height=100, width=200
                                ).tolist() == [64 * 128, 64 * 72, 36 * 128,
                                               36 * 72]


# ---- the parameter block ----------------------------------------------------

def _layer_tensors(rng, T: int, n: int = 5):
    """One layer's ten tensors on the CPU: seven f32 tables, three bins."""
    return tuple(torch.from_numpy(rng.uniform(0, 1, (n, c)).astype(np.float32))
                 for c in (16, 4, 8, 4, 4, 8, 4)) + tuple(
        torch.from_numpy(rng.integers(-1, n, (T, k)).astype(np.int32))
        for k in (8, 16, 32))


def _c_struct(name: str, structs: dict) -> tuple[list, int]:
    """The fields of C struct `name` in csrc/raster_tiles.cu as nvcc lays
    them out for a 64-bit target → ([(field, offset, kind)], size): a
    pointer is 8 bytes ("P"), an int or a float 4 ("i", "f"), each at a
    multiple of its size; an array of a struct in `structs` (name → its
    fields and size) inline, element by element as "field[i].member"."""
    import os
    import re

    with open(os.path.join(K.CSRC_DIR, "raster_tiles.cu")) as f:
        src = f.read()
    assert int(re.search(r"constexpr int MAX_LAYERS = (\d+);",
                         src).group(1)) == K.MAX_LAYERS
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    fields, off = [], 0
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.match(r"(.*?[\s*])(\w+(?:\[\w+\])?(?:,\s*\w+)*)$",
                     decl.strip())
        if m is None:
            continue
        ctype = m.group(1).strip()
        for field in re.split(r",\s*", m.group(2)):
            array = re.match(r"(\w+)\[MAX_LAYERS\]$", field)
            if array:
                inner, size = structs[ctype]
                off = -(-off // 8) * 8
                for i in range(K.MAX_LAYERS):
                    fields += [(f"{array.group(1)}[{i}].{f}", off + o, k)
                               for f, o, k in inner]
                    off += size
                continue
            kind, size = (("P", 8) if ctype.endswith("*")
                          else ({"int": "i", "float": "f"}[ctype], 4))
            off = -(-off // size) * size
            fields.append((field, off, kind))
            off += size
    return fields, -(-off // 8) * 8


def test_params_struct_layout_and_packing():
    """The bytes `_pack_params` writes hold every field of `RasterParams`,
    as csrc/raster_tiles.cu declares it, at its offset: two layers (one
    drawing no images), empty rows up to MAX_LAYERS, the tail. The size the
    wrapper checks at load is the struct's."""
    import struct

    layer = _c_struct("LayerTables", {})
    fields, size = _c_struct("RasterParams", {"LayerTables": layer})
    assert layer[1] == K._LAYER_PACK.size == 96
    assert size == K.MAX_LAYERS * K._LAYER_PACK.size + K._TAIL_PACK.size \
        == 464

    rng = np.random.default_rng(0)
    T, device = 6, torch.device("cpu")
    layers = [_layer_tensors(rng, T), _layer_tensors(rng, T)]
    sig = ((True, True, True), (True, True, False))
    font = torch.zeros((64, 128), dtype=torch.uint8)
    atlas = torch.zeros((64, 64, 4), dtype=torch.uint8)
    out = torch.empty((100, 200, 4), dtype=torch.uint8)
    bg = (0.25, 0.5, 0.75)
    rows = [K._layer_row(li, s, layers[li], device, T)
            for li, s in enumerate(sig)]
    got = K._pack_params(rows, font, atlas, bg, 2, 3, 100, 200, out)
    assert len(got) == size
    # A slice's canvas: the first tile launched and the f32 output.
    tiles = torch.empty((4, 64, 128, 4))
    sliced = K._pack_params(rows, font, atlas, bg, 2, 3, 100, 200, tiles, 2)
    offsets = {f: o for f, o, _ in fields}
    assert struct.unpack_from("<QiI", sliced, offsets["out"]) == (
        tiles.data_ptr(), 2, 1)

    want = {"font_tex": font.data_ptr(), "font_h": 64, "font_w": 128,
            "image_atlas": atlas.data_ptr(), "atlas_h": 64, "atlas_w": 64,
            "bg_r": 0.25, "bg_g": 0.5, "bg_b": 0.75, "n_layers": 2,
            "tiles_x": 3, "tiles_y": 2, "height": 100, "width": 200,
            "out": out.data_ptr()}
    for li, s in enumerate(sig):
        for name, t in zip(K._TABLES + K._BINS, layers[li]):
            want[f"layers[{li}].{name}"] = t.data_ptr()
        for ci, k in enumerate(("ks", "kg", "ki")):
            want[f"layers[{li}].{k}"] = (layers[li][7 + ci].shape[1]
                                         if s[ci] else 0)
    assert set(want) <= {f for f, _, _ in fields}
    for field, off, kind in fields:
        value = struct.unpack_from({"P": "<Q", "i": "<i", "f": "<f"}[kind],
                                   got, off)[0]
        assert value == want.get(field, 0), field
    assert want["layers[1].ki"] == 0 and want["layers[1].kg"] == 16


@pytest.mark.parametrize("case", ("dtype", "strided", "device", "rows",
                                  "count"))
def test_layer_row_refuses_what_the_kernel_cannot_take(case):
    rng = np.random.default_rng(1)
    T = 6
    parts = list(_layer_tensors(rng, T))
    if case == "dtype":
        parts[2] = parts[2].double()
    elif case == "strided":
        parts[0] = torch.zeros((5, 32))[:, ::2]
    elif case == "device":
        parts[8] = parts[8].to("meta")
    elif case == "rows":
        parts[9] = parts[9][:T - 1]
    else:
        parts = parts[:9]
    with pytest.raises(ValueError, match="render_tiles"):
        K._layer_row(0, (True, True, True), tuple(parts),
                     torch.device("cpu"), T)


@pytest.mark.parametrize("source, kernel, unit", (
    ("raster_tiles.cu", "raster_tiles_kernel",
     (("UNIT_W", 32), ("UNIT_ROWS", 4))),
    ("raster_blocks.cu", "raster_blocks_kernel",
     (("UNIT_W", 32), ("UNIT_ROWS", 4))),
    ("compose_tiles.cu", "compose_tiles_kernel", (("COMPOSE_ROWS", 4),))))
def test_default_unit_is_compiled(source, kernel, unit):
    """Each kernel's source instantiates exactly the unit its launch
    function launches: the kernel template is named with arguments once,
    in the launch, and they are the source's constants (K1's and K2's 32 x
    16 unit of a tile, K3's 8 rows a CTA); the launch takes no unit from
    its wrapper, only the parameters, the tile count and the stream."""
    import os
    import re

    with open(os.path.join(K.CSRC_DIR, source)) as f:
        code = re.sub(r"//[^\n]*", "", f.read())
    assert re.findall(kernel + r"\s*<([^>]*)>", code) == \
        [", ".join(name for name, _ in unit)], source
    for name, value in unit:
        assert f"constexpr int {name} = {value};" in code, (source, name)
    launches = re.findall(r"int \w+_launch\(([^)]*)\)", code)
    assert len(launches) == 1 and len(launches[0].split(",")) == 3, source
