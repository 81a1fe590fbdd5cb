"""The whole slice on the CPU: the history view of a generated repository
at 1280×800, compiled by the reference's scene compiler under each
package's renderer, packed byte-equal, and rendered by the port
(`Renderer` + `render_scene`) against the reference's packed path
(`render_scene` with WGIT_FRAME_CACHE=0)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import whisper_git_tpu.render.rasterizer as R
from whisper_git_tpu.render.renderer import get_renderer
from whisper_git_tpu.ui.theme import DARK
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

VIEWPORT = (1280, 800)
SCROLL_OFFSETS = (0.0, 13.0, 17.0, 63.9, 64.0, 100.3, 111.5, 128.5)


def fresh_compile_caches(*renderers):
    """Empty what layout and scene compile memoize, in both packages. The
    memos are keyed by content alone, so a layout or a scroll window cached
    by an earlier test (under another measurer or viewport) would be served
    to one package's compile and not to the other's, which starts empty."""
    import whisper_git_tpu.ui.layout as ref_layout
    import whisper_git_tpu.ui.memo as ref_memo
    import whisper_git_tpu_torch.ui.layout as port_layout
    import whisper_git_tpu_torch.ui.memo as port_memo

    for layout in (ref_layout, port_layout):
        layout._MEASURE_MEMO.clear()
        layout._SUBTREE_LAYOUT_CACHE.clear()
    for memo in (ref_memo, port_memo):
        memo._EL_MEMO.clear()
    for r in renderers:
        for cache in (r.compiler._text_cache, r.compiler._subtree_cache,
                      r.compiler._window_cache):
            cache.clear()


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    import bench
    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp

    repo = bench.build_history_repo(str(tmp_path_factory.mktemp("hist")), 60)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    ref, port = get_renderer(), Renderer("cpu")
    fresh_compile_caches(ref, port)
    return app, tab, ref, port


def _compile_both(history, off: float):
    app, tab, ref, port = history
    tab.history_scroll = float(off)
    tree = app.build((float(VIEWPORT[0]), float(VIEWPORT[1])))
    return (ref.compile(ref.layout(tree, VIEWPORT), VIEWPORT,
                        DARK.background),
            port.compile(port.layout(tree, VIEWPORT), VIEWPORT,
                         DARK.background))


@pytest.mark.parametrize("off", SCROLL_OFFSETS)
def test_history_pack_byte_equal(history, off):
    ref_scene, port_scene = _compile_both(history, off)
    assert port_scene.windows, "history scroll window was not recorded"
    fa, ma, tya, txa, wa = R.pack_scene(ref_scene)
    fb, mb, tyb, txb, wb = P.pack_scene(port_scene)
    assert fa.tobytes() == fb.tobytes()
    assert ma == mb and (tya, txa) == (tyb, txb) == (13, 10)
    assert [(c, b.tobytes()) for _, c, b in wa] == \
        [(c, b.tobytes()) for _, c, b in wb]


@pytest.mark.parametrize("off", (0.0, 63.9, 111.5))
def test_history_frame_matches_reference(history, off, monkeypatch):
    _, _, ref, port = history
    ref_scene, port_scene = _compile_both(history, off)
    got = P.render_scene(port_scene, port.font_tex_device(),
                         port.image_atlas_device())
    monkeypatch.setenv("WGIT_FRAME_CACHE", "0")
    want = R.render_scene(ref_scene, ref.font_tex_device(),
                          ref.image_atlas_device())
    assert got.shape == want.shape == (800, 1280, 4)
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # Glyph resampling bound (tests/test_pallas_raster.py).
    assert d.max() <= 8
    assert (d > 2).mean() < 0.01
