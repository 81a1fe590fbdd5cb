"""The committed atlas npz equals a fresh reference build, and the port's
loader rebuilds the reference's atlases from it."""

from __future__ import annotations

import numpy as np
import torch

from whisper_git_tpu_torch.render.atlas import (ATLAS_NPZ, font_texture,
                                                 load_atlases)

torch.set_num_threads(2)


def test_committed_atlas_matches_fresh_reference_build():
    from whisper_git_tpu_torch.tools.export_atlas import build_arrays

    fresh = build_arrays()
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
        assert got.glyphs == want.glyphs
        assert (got.ascent, got.descent) == (want.ascent, want.descent)
        assert got.is_bold == want.is_bold
        assert np.array_equal(got.lut, want.lut)
        assert got.fallback is None
    assert np.array_equal(font_texture(regular, bold), ref.font_tex)
