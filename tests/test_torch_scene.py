"""The port's host half against the reference: the port's `_bucket`,
`pack_scene` (byte-equal) and the device unpack (bit-equal), on seeded
synthetic scenes and the reference's small fixture scene."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_git_tpu.render.rasterizer as R
import whisper_git_tpu.render.scene as ref_scene
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render import scene as port_scene
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import KINDS, synthetic_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def port_renderer():
    return Renderer("cpu")


@pytest.fixture(scope="module")
def graft_scene():
    import __graft_entry__ as g

    return g._compiled_scene(256, 128)[1]


def _scenes(port_renderer, graft_scene):
    bold_v = port_renderer.regular.texture.shape[0]
    out = [(f"{kind}-{seed}", synthetic_scene(kind, seed,
                                              port_renderer.regular, bold_v))
           for kind in KINDS for seed in (0, 1)]
    return out + [("graft-256x128", graft_scene)]


def test_bucket_matches_reference_fine_ladder():
    ref = ref_scene._bucket  # JAX on the CPU: the reference's fine ladder
    ns = sorted({0, 1, 2, 63, 64, 65, 255, 256, 257, 1023, 1024, 1025, 4095,
                 4096, 4097, 16384, 16385, 65536, 65537, 70000, 100000}
                | set(range(0, 5000, 37)))
    for n in ns:
        for key in (None, (0, "s"), ("win", 0, 0, "g")):
            assert port_scene._bucket(n, key) == ref(n, key), (n, key)


def _assert_pack_equal(a, b, label):
    fa, ma, tya, txa, wa = a
    fb, mb, tyb, txb, wb = b
    assert fa.dtype == fb.dtype == np.int32, label
    assert fa.tobytes() == fb.tobytes(), label
    assert ma == mb, label
    assert (tya, txa) == (tyb, txb), label
    assert len(wa) == len(wb), label
    for (ua, ca, ba), (ub, cb, bb) in zip(wa, wb):
        assert (ua, ca) == (ub, cb), label
        assert ba.dtype == bb.dtype and ba.tobytes() == bb.tobytes(), label


def test_pack_scene_byte_equal(port_renderer, graft_scene):
    for label, scene in _scenes(port_renderer, graft_scene):
        _assert_pack_equal(R.pack_scene(scene), P.pack_scene(scene), label)


def test_unpack_layers_bit_equal(port_renderer, graft_scene):
    for label, scene in _scenes(port_renderer, graft_scene):
        fused, meta, ty, tx, win_list = P.pack_scene(scene)
        T = ty * tx
        ld_j, sig_j = R.unpack_layers(
            jnp.asarray(fused), tuple(jnp.asarray(b) for _, _, b in win_list),
            meta, T)
        ld_t, sig_t = P.unpack_layers(
            torch.from_numpy(fused),
            tuple(torch.from_numpy(b) for _, _, b in win_list), meta, T)
        assert sig_j == sig_t, label
        assert len(ld_j) == len(ld_t), label
        for li, (lj, lt) in enumerate(zip(ld_j, ld_t)):
            for pi, (x, y) in enumerate(zip(lj, lt)):
                x = np.asarray(x)
                y = y.numpy()
                assert x.dtype == y.dtype and x.shape == y.shape, \
                    (label, li, pi)
                assert x.tobytes() == y.tobytes(), (label, li, pi)


def test_window_scene_records_a_fractional_window(port_renderer):
    scene = synthetic_scene("window", 0, port_renderer.regular,
                            port_renderer.regular.texture.shape[0])
    (w,) = scene.windows
    assert w.dy != int(w.dy)
    fused, meta, ty, tx, win_list = P.pack_scene(scene)
    assert meta[1] == 1 and len(win_list) == 1
    assert meta[2][10] == ((0, win_list[0][1]),)



def test_oversized_scene_renders_its_background(port_renderer):
    """A scene over MAX_PACKED_PX takes the unquantized f32 path instead
    of the packed one (tests/test_torch_oversized.py holds that path
    against the reference's); with no layers it is the background."""
    scene = port_scene.Scene(layers=[], width=P.MAX_PACKED_PX + 1, height=64,
                             background=(0.1, 0.2, 0.3, 1.0),
                             image_atlas=np.zeros((64, 64, 4), np.uint8))
    img = P.render_scene_device(scene, port_renderer.font_tex_device(),
                                port_renderer.image_atlas_device())
    assert img.shape == (64, P.MAX_PACKED_PX + 1, 4)
    want = torch.tensor([int(c * 255 + 0.5) for c in (0.1, 0.2, 0.3)]
                        + [255], dtype=torch.uint8)
    assert bool((img == want).all())
