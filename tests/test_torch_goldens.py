"""The port against the reference's pixel goldens (tests/goldens/*.png),
rendered through the port's `Renderer` on the CPU, at the reference's
±2 u8 gate. The `fallback` scene needs the lazy fallback glyph bank,
which the port does not have yet, so it is not among the cases."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from whisper_git_tpu.tools.goldens import SCENES, SIZE, TOLERANCE, golden_dir
from whisper_git_tpu.ui.theme import DARK
from whisper_git_tpu_torch.render.rasterizer import render_scene
from whisper_git_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

PORTED_SCENES = sorted(name for name in SCENES if name != "fallback")


@pytest.fixture(scope="module")
def port_renderer():
    return Renderer("cpu")


def _load(name: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(os.path.join(golden_dir(), f"{name}.png")))


@pytest.mark.parametrize("name", PORTED_SCENES)
def test_port_matches_golden(port_renderer, name):
    r = port_renderer
    root = r.layout(SCENES[name](), (float(SIZE[0]), float(SIZE[1])))
    scene = r.compile(root, SIZE, DARK.background)
    got = render_scene(scene, r.font_tex_device(), r.image_atlas_device())
    want = _load(name)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= TOLERANCE, (
        f"{name}: max pixel diff {diff.max()} > {TOLERANCE} "
        f"({(diff.max(axis=-1) > TOLERANCE).sum()} px)")
