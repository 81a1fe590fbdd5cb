"""The reference against the port on the CPU: its splice of the windows,
its row model, its avatar atlas and its raster agree with what the
port's plain path does with the same scene."""

import os
import time

import numpy as np
import pytest
import torch

from portbench import harness, reference, repo

SEED = 2**32 + 77


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("refscene"))
    conf = harness.load_json(harness.ROOT, "portbench", "configs",
                             "history1000-1280x800.json")
    old = {k: os.environ.get(k) for k in ("XDG_CACHE_HOME", "WGIT_MESH",
                                          "XDG_STATE_HOME",
                                          "XDG_CONFIG_HOME")}
    harness._pin_env(conf, tmp)
    try:
        from whisper_git_tpu_torch.app.repo_tab import RepoTab
        from whisper_git_tpu_torch.app.ui_app import WhisperApp
        from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
        from whisper_git_tpu_torch.render.renderer import get_renderer

        commits = repo.history(SEED, conf["history"])
        path = repo.build_repo(tmp, commits,
                               repo.tags(conf["history"], commits))
        emails = repo.prime_avatars(os.environ["XDG_CACHE_HOME"], SEED)
        tab = RepoTab.open(path)
        tab.refresh_sync(include_orphans=False)
        app = WhisperApp.with_tabs([tab])
        app.avatar_cache.prefetch_sync(emails)
        r = get_renderer("cpu")
        app.on_scroll(252.0, 540.0, 400.0)
        sc = compile_frame(app, r, 1280, 800, 1.0)
        yield {"scene": sc, "app": app, "tab": tab, "renderer": r,
               "commits": commits}
        tab.stop_workers()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_history_model_matches_the_app(scene):
    from whisper_git_tpu_torch.ops.lanes import compute_row_heights

    tab = scene["tab"]
    hist = reference.History(repo.display_order(scene["commits"]),
                             int(time.time()))
    stamps = [c.timestamp for c in tab.commits]
    assert reference.row_heights(stamps) == compute_row_heights(stamps)
    assert hist.heights == list(tab.graph_layout.row_heights)
    assert hist.total == tab.graph_layout.total_height
    real = [c.summary for c in tab.commits if not c.is_synthetic]
    assert real == [c["subject"] for c in repo.display_order(
        scene["commits"])]


def test_splice_matches_inline_windows(scene):
    sc = scene["scene"]
    flat = harness.capture(sc)
    flat = dict(flat, width=5000)          # past the wire format: no rounding
    mine = reference.splice(flat)
    theirs = sc.inline_windows()
    assert len(mine) == len(theirs.layers)
    for a, lb in zip(mine, theirs.layers):
        for k, n in (("shapes", lb.n_shapes), ("glyphs", lb.n_glyphs),
                     ("images", lb.n_images)):
            assert np.array_equal(a[k], getattr(lb, k)[:n])
        assert np.array_equal(a["glyph_clips"], lb.glyph_clips[:lb.n_glyphs])
        assert np.array_equal(a["shape_clips"], lb.shape_clips[:lb.n_shapes])


def test_rows_and_avatars(scene):
    sc = scene["scene"]
    conf = harness.load_json(harness.ROOT, "portbench", "configs",
                             "history1000-1280x800.json")
    commits = scene["commits"]
    hist = reference.History(repo.display_order(commits), int(time.time()),
                             repo.tags(conf["history"], commits).values())
    layers = reference.splice(harness.capture(sc))
    _, lut = reference.font_atlas(harness.ROOT)
    pane = conf["pane"]
    rows = reference.find_rows(layers, lut, hist, 1.0,
                               0.5 * pane["subject_x_px"])
    assert any(hist.pill[r.index] for r in rows)
    err = reference.scene_errors(rows, layers, hist, 252.0, pane, 14, 1.0)
    assert err is not None and err[0] < 0.2 and err[1] == 0
    # A view 84 px off is told apart, and so is a pane moved 3 px.
    off = reference.scene_errors(rows, layers, hist, 336.0, pane, 14, 1.0)
    assert abs(off[0] - 84.0) < 0.2
    moved = dict(pane, text_y_px=pane["text_y_px"] + 3.0)
    assert reference.scene_errors(rows, layers, hist, 252.0, moved, 14,
                                  1.0)[0] >= 3.0
    # Another subject's text, or another colour, is a text error.
    other = reference.History(repo.display_order(
        repo.history(SEED + 1, conf["history"])), int(time.time()))
    assert reference.scene_errors(rows, layers, other, 252.0, pane, 14,
                                  1.0)[1] > 0
    grey = dict(pane, subject_rgba=[0.5, 0.5, 0.5, 1.0])
    assert reference.scene_errors(rows, layers, hist, 252.0, grey, 14,
                                  1.0)[1] == len(rows)
    avatars = [repo.avatar_image(SEED, a) for a in range(len(repo.AUTHORS))]
    atlas = reference.expected_atlas(layers, rows, hist, avatars, 1.0)
    used = {(int(q[4]), int(q[5])) for lay in layers for q in lay["images"]}
    assert used
    for u, v in used:
        assert np.array_equal(atlas[v:v + 64, u:u + 64],
                              sc.image_atlas[v:v + 64, u:u + 64])


@pytest.mark.parametrize("level", ["packed", "frame_cache", "compose"])
def test_raster_matches_the_ports_plain_path(scene, level, monkeypatch):
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device

    if level == "packed":
        monkeypatch.setenv("WGIT_FRAME_CACHE", "0")
    elif level == "frame_cache":
        monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    sc, r = scene["scene"], scene["renderer"]
    got = render_scene_device(sc, r.font_tex_device(),
                              r.image_atlas_device())
    tex, _ = reference.font_atlas(harness.ROOT)
    layers = reference.splice(harness.capture(sc))
    ref = reference.raster(layers, sc.height, sc.width, sc.background, tex,
                           sc.image_atlas, "cpu")
    gap = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
    assert gap <= (1 if level == "compose" else 0)
    low = reference.raster(layers, sc.height, sc.width, sc.background, tex,
                           sc.image_atlas, "cpu", dtype=torch.bfloat16)
    assert int((low.to(torch.int16) - ref.to(torch.int16)).abs().max()) > 16
