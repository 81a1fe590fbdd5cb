"""The port's oversized-scene path (`rasterizer._render_scene_f32_device`,
for scenes over MAX_PACKED_PX) against the reference's on the CPU: the host
binning byte-equal, the tables and bins handed to the tile kernel equal,
and the frames, the port's plain tile kernel against the reference's XLA
scan, within the reference's tolerances."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import whisper_git_tpu.render.rasterizer as R
import whisper_git_tpu.render.scene as ref_scene
from whisper_git_tpu_torch.render import raster_kernel as K
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import synthetic_scene

torch.set_num_threads(2)

EDGE_W, EDGE_H = 4480, 64   # wider than MAX_PACKED_PX, small in area


@pytest.fixture(scope="module")
def port_renderer():
    return Renderer("cpu")


def _stats(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(d.max()), float((d > 2).mean())


def _assert_within(got, want, label, glyphs=True):
    """The reference's tolerances: shapes within 1 u8; glyphs at most 8 u8
    with more than 2 u8 on under 1 % of values."""
    assert got.shape == want.shape, label
    mx, share = _stats(got, want)
    print(f"{label}: max {mx} u8, >2 u8 on {share:.6f}")
    if glyphs:
        assert mx <= 8 and share < 0.01, (label, mx, share)
    else:
        assert mx <= 1, (label, mx)


def _as_reference_scene(scene):
    """The same buffers and windows in the reference's Scene, so that its
    own `inline_windows` splices them."""
    return ref_scene.Scene(**{f.name: getattr(scene, f.name)
                              for f in dataclasses.fields(scene)})


def _ref_frame(scene, font):
    return np.asarray(R.render_scene_device(
        scene, font, scene.image_atlas))


# ---- host binning -----------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1, 2))
def test_bin_commands_byte_equal(seed):
    """Boxes in and out of the grid, inverted, spanning many tiles, and a
    tile busier than the cap (the overflow is dropped, as the reference
    drops it)."""
    rng = np.random.default_rng(seed)
    tiles_y, tiles_x = 7, 40
    n = 400
    x0 = rng.uniform(-300, tiles_x * 128 + 100, n)
    y0 = rng.uniform(-100, tiles_y * 64 + 50, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(-20, 900, n),
                      y0 + rng.uniform(-10, 200, n)], 1).astype(np.float32)
    boxes[:60] = (130.0, 70.0, 140.0, 80.0)          # 60 in one tile
    for k in (16, 32, 256):
        for m in (0, 1, 59, n):
            want = R._bin_commands(boxes, m, tiles_y, tiles_x, k)
            got = P._bin_commands(boxes, m, tiles_y, tiles_x, k)
            assert got[1] == want[1], (k, m)
            assert got[0].dtype == want[0].dtype == np.int32, (k, m)
            assert got[0].tobytes() == want[0].tobytes(), (k, m)
    assert P._bin_commands(boxes, n, tiles_y, tiles_x, 16)[1] > 0


# ---- what reaches the tile kernel -------------------------------------------

def _captured_inputs(monkeypatch, scene, font):
    """The arguments each package's oversized path hands its tile
    renderer: the reference's `_render_unpacked`, the port's
    `render_tiles`."""
    seen = {}

    def ref_spy(layer_data, font_tex, image_atlas, background, tiles_y,
                tiles_x, layer_sig, height, width, use_pallas=False):
        seen["ref"] = ([[np.asarray(a) for a in layer]
                        for layer in layer_data], background, tiles_y,
                       tiles_x, layer_sig, height, width)
        return np.zeros((height, width, 4), np.uint8)

    def port_spy(layer_data, font_tex, image_atlas, background, tiles_y,
                 tiles_x, layer_sig, height, width):
        seen["port"] = ([[a.numpy() for a in layer] for layer in layer_data],
                        background, tiles_y, tiles_x, layer_sig, height,
                        width)
        return torch.zeros((height, width, 4), dtype=torch.uint8)

    monkeypatch.setattr(R, "_render_unpacked", ref_spy)
    monkeypatch.setattr(P, "render_tiles", port_spy)
    R.render_scene_device(_as_reference_scene(scene), font.numpy(),
                          scene.image_atlas)
    P.render_scene_device(scene, font)
    return seen["ref"], seen["port"]


@pytest.mark.parametrize("kind", ("glyphs", "images", "windows2"))
def test_kernel_inputs_equal_reference(port_renderer, monkeypatch, kind):
    """Every f32 table, every bins table, the grid, the background and the
    signature the port's oversized path gives the tile kernel, byte-equal
    to what the reference's gives its own; a scene with two scroll windows
    spliced inline by each package's `inline_windows`."""
    scene = synthetic_scene(kind, 4, port_renderer.regular,
                            port_renderer.regular.texture.shape[0],
                            P.MAX_PACKED_PX + 129, 128)
    assert max(scene.width, scene.height) > P.MAX_PACKED_PX
    ref, port = _captured_inputs(monkeypatch, scene,
                                 port_renderer.font_tex_device())
    assert port[1:] == ref[1:], kind
    assert len(port[0]) == len(ref[0]) == len(scene.layers), kind
    for li, (lp, lr) in enumerate(zip(port[0], ref[0])):
        for ai, (a, b) in enumerate(zip(lp, lr)):
            assert a.dtype == b.dtype and a.shape == b.shape, (kind, li, ai)
            assert a.tobytes() == b.tobytes(), (kind, li, ai)
    if kind == "windows2":   # the windows' rows are spliced into layer 0
        n_win = sum(w.comp.shapes.shape[0] for w in scene.windows)
        assert (port[0][0][7] >= 0).sum() > 0
        assert port[0][0][0].shape[0] >= scene.layers[0].n_shapes + n_win


# ---- the frame --------------------------------------------------------------

def _edge_scene(ui, renderer):
    """The reference's far-edge scene (tests/test_frame_cache.py): a red
    rect with a label in the last 128 px of a 4480 px wide frame."""
    tree = ui.stack(
        ui.row(ui.spacer(),
               ui.rect(ui.text("edge", color=(1, 1, 1, 1)),
                       fill=(0.9, 0.2, 0.2, 1.0), width=128, height=32),
               width="fill", height="fill"),
        width="fill", height="fill", fill=(0.0, 0.0, 0.0, 1.0))
    root = renderer.layout(tree, (EDGE_W, EDGE_H))
    return renderer.compile(root, (EDGE_W, EDGE_H), (0.0, 0.0, 0.0, 1.0))


def test_far_edge_scene_matches_reference(port_renderer):
    """The port's frame of the reference's far-edge scene, each package
    compiling its own, against the reference's frame; and the template's
    own checks: the rect beyond the i16 range is drawn, nothing smeared
    onto the clamp column."""
    import whisper_git_tpu.ui as ref_ui
    import whisper_git_tpu_torch.ui as port_ui
    from whisper_git_tpu.render.renderer import get_renderer

    ref = get_renderer()
    want = _ref_frame(_edge_scene(ref_ui, ref), ref.font_tex_device())
    before = K.render_tiles.launches
    got = P.render_scene_device(_edge_scene(port_ui, port_renderer),
                                port_renderer.font_tex_device()).numpy()
    assert K.render_tiles.launches == before   # the plain version, on CPU
    assert got.shape == (EDGE_H, EDGE_W, 4) and got.dtype == np.uint8
    _assert_within(got, want, "far-edge scene")
    strip = got[:32, EDGE_W - 120:EDGE_W - 8]
    assert strip[..., 0].mean() > 150, "far-edge rect missing (clamped?)"
    col = got[40:, 4090:4100]
    assert col.max() == 0 or col[..., 0].mean() < 10


@pytest.mark.parametrize("kind", ("shapes", "window", "windows2"))
def test_oversized_frame_matches_reference(port_renderer, kind):
    """Synthetic scenes wider than the wire format, two of them with scroll
    windows spliced inline, through both packages' `render_scene_device`."""
    scene = synthetic_scene(kind, 2, port_renderer.regular,
                            port_renderer.regular.texture.shape[0],
                            P.MAX_PACKED_PX + 385, 128)
    font = port_renderer.font_tex_device()
    got = P.render_scene_device(scene, font).numpy()
    want = _ref_frame(_as_reference_scene(scene), font.numpy())
    assert got.shape == (scene.height, scene.width, 4)
    _assert_within(got, want, f"oversized {kind}", glyphs=kind != "shapes")
    # ink reaches past the i16 range
    bg = np.asarray([int(c * 255 + 0.5) for c in scene.background[:3]])
    far = got[:, P.MAX_PACKED_PX + 1:, :3].astype(int)
    assert (np.abs(far - bg) > 8).any(), kind


def test_tall_scene_takes_the_oversized_path(port_renderer):
    """A scene taller than MAX_PACKED_PX, and no wider than one tile, is
    rendered (the oversized test is on either side)."""
    scene = synthetic_scene("shapes", 1, port_renderer.regular,
                            port_renderer.regular.texture.shape[0], 128,
                            P.MAX_PACKED_PX + 65)
    font = port_renderer.font_tex_device()
    got = P.render_scene_device(scene, font).numpy()
    want = _ref_frame(_as_reference_scene(scene), font.numpy())
    assert got.shape == (P.MAX_PACKED_PX + 65, 128, 4)
    _assert_within(got, want, "tall shapes", glyphs=False)

