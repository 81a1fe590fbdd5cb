"""The committed atlas npz equals a fresh reference build, and the port's
loader rebuilds the reference's atlases from it."""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import torch

from whisper_git_tpu_torch.render.atlas import (ATLAS_NPZ, font_texture,
                                                 load_atlases)

torch.set_num_threads(2)


def test_committed_atlas_matches_fresh_reference_build():
    spec = importlib.util.spec_from_file_location(
        "export_atlas", os.path.join(os.path.dirname(__file__), "tools",
                                     "export_atlas.py"))
    export_atlas = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export_atlas)

    fresh = export_atlas.build_arrays()
    with np.load(ATLAS_NPZ, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(fresh)
        for key, want in fresh.items():
            got = z[key]
            assert got.dtype == want.dtype, key
            assert got.shape == want.shape, key
            assert np.array_equal(got, want), key
    assert fresh["regular_texture"].shape == (2816, 768)
    assert fresh["bold_texture"].shape == (2816, 768)


def test_loaded_atlases_match_reference_renderer():
    from whisper_git_tpu.render.renderer import get_renderer

    ref = get_renderer()
    regular, bold = load_atlases()
    for got, want in ((regular, ref.regular), (bold, ref.bold)):
        assert np.array_equal(got.texture, want.texture)
        # Glyph is a class of each package: compare field by field.
        assert list(got.glyphs) == list(want.glyphs)
        assert all(dataclasses.asdict(got.glyphs[c])
                   == dataclasses.asdict(want.glyphs[c]) for c in want.glyphs)
        assert (got.ascent, got.descent) == (want.ascent, want.descent)
        assert got.is_bold == want.is_bold
        assert np.array_equal(got.lut, want.lut)
        assert got.fallback is None
    assert np.array_equal(font_texture(regular, bold), ref.font_tex)
