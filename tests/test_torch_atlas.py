"""The committed atlas npz equals a fresh reference build, the port's
loader rebuilds the reference's atlases from it, and the port's own build
pipeline (`build_atlas`: Pillow, DejaVu, the torch EDT) rebuilds the npz
byte for byte (texture) and value for value (metrics, ascent, descent)."""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from whisper_git_tpu_torch.render import atlas as port_atlas
from whisper_git_tpu_torch.render.atlas import (ATLAS_NPZ, FACES,
                                                 atlas_arrays, build_atlas,
                                                 font_texture, load_atlases)

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


@pytest.mark.parametrize("face", FACES)
def test_port_build_atlas_rebuilds_the_npz(face):
    atlas = build_atlas(bold=face == "bold", use_cache=False, device="cpu")
    with np.load(ATLAS_NPZ, allow_pickle=False) as z:
        chars = [str(c) for c in z["chars"]]
        assert list(atlas.glyphs) == chars
        for key, got in atlas_arrays(atlas, chars).items():
            want = z[f"{face}_{key}"]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert np.array_equal(got, want), key
    assert atlas.is_bold == (face == "bold") and atlas.fallback is None


def test_build_atlas_cache_round_trips(tmp_path, monkeypatch):
    """A build writes its cache under XDG_CACHE_HOME (no pickled object)
    and the next build reads the same atlas back."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(port_atlas, "_CHARS", list("?aWй∮"))
    built = build_atlas(use_cache=True, device="cpu")
    files = list((tmp_path / "whisper-git-tpu-torch").iterdir())
    assert len(files) == 1
    with np.load(files[0], allow_pickle=False) as z:
        assert z["chars"].dtype.kind == "U"
    cached = build_atlas(use_cache=True, device="cpu")
    assert np.array_equal(cached.texture, built.texture)
    assert list(cached.glyphs) == list(built.glyphs)
    assert all(dataclasses.asdict(cached.glyphs[c])
               == dataclasses.asdict(built.glyphs[c]) for c in built.glyphs)
    assert (cached.ascent, cached.descent) == (built.ascent, built.descent)
