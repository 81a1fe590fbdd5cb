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
