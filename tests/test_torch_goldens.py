"""The port against the reference's pixel goldens (tests/goldens/*.png),
rendered through the port's `tools/goldens.py` on the CPU, at the
reference's ±2 u8 gate (`TOLERANCE`). The `fallback` scene draws from the
fallback bank pinned to DejaVu, as the reference's goldens were made; the
bank pinned to the stored DejaVu masks (`tools/mask_font.py`, the card's
stand-in for Pillow) draws it byte for byte the same."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from whisper_git_tpu.tools import goldens as ref_goldens
from whisper_git_tpu_torch.render.renderer import decode_png
from whisper_git_tpu_torch.tools.goldens import (SCENES, SIZE, TOLERANCE,
                                                 golden_dir,
                                                 render_scene_image)
from whisper_git_tpu_torch.tools.mask_font import (BANK_MASKS_NPZ,
                                                   pin_mask_bank)

torch.set_num_threads(2)


def _load(name: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(os.path.join(golden_dir(), f"{name}.png")))


def test_the_port_has_the_references_scenes():
    assert list(SCENES) == list(ref_goldens.SCENES)
    assert (SIZE, TOLERANCE) == (ref_goldens.SIZE, ref_goldens.TOLERANCE)
    assert golden_dir() == ref_goldens.golden_dir()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_matches_golden(name):
    got = render_scene_image(name, "cpu")
    want = _load(name)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= TOLERANCE, (
        f"{name}: max pixel diff {diff.max()} > {TOLERANCE} "
        f"({(diff.max(axis=-1) > TOLERANCE).sum()} px)")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_golden_pngs_decode_as_pillow_reads_them(name):
    with open(os.path.join(golden_dir(), f"{name}.png"), "rb") as f:
        got = decode_png(f.read())
    assert got is not None and np.array_equal(got, _load(name))


def test_mask_bank_draws_the_fallback_scene_as_pillow_does():
    """The bank pinned to the stored masks and the bank pinned to DejaVu
    through Pillow render the `fallback` scene byte for byte the same."""
    masks = render_scene_image("fallback", "cpu", pin=pin_mask_bank)
    dejavu = render_scene_image("fallback", "cpu")
    assert np.array_equal(masks, dejavu)


def test_committed_bank_masks_match_a_fresh_export():
    spec = importlib.util.spec_from_file_location(
        "export_bank_masks", os.path.join(os.path.dirname(__file__),
                                          "tools", "export_bank_masks.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)

    fresh = export.build_arrays()
    with np.load(BANK_MASKS_NPZ, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for key, want in fresh.items():
            assert z[key].dtype == want.dtype, key
            assert np.array_equal(z[key], want), key
    # Hebrew, math and box drawing, at both weights.
    assert len(fresh["regular_cps"]) == len(fresh["bold_cps"]) >= 12
