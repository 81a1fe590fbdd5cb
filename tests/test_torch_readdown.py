"""The compose path's rebuilds down a long history, on the CPU: the
benchmark's readdown (84 px wheel clicks straight down) over the history
of `history1000-3840x2160-s2` in a small window (400x250 logical px, the
smallest that shows the history pane), at scale 1 and at scale 2.

Every frame composes at a whole-pixel offset and is held to the
benchmark's plain reference (`portbench/reference.py`, every command
composited in float32) within the configuration's `frame_gap_u8`, and to
the frame cache's frame of the same scene within 1 u8 (the compose path's
own tolerance: layer boundaries re-associate `over`, cached layers round
to 2^-15). The sweep runs far enough that the CPU's quartered caps evict
plans, chrome groups and (at scale 1, where the history is a scroll
window) slabs, and the counters of what a rebuild builds and evicts are
held to what the caches did: `compose.built_px` to the pixels of the
layers K2 built, each `compose.*_evictions` to the entries its cache
dropped. At scale 2 `Scene.scaled` splices the window into the chrome, so
every scroll frame rebuilds its plan and a chrome group."""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from portbench import harness, reference, repo
from whisper_git_tpu_torch import tracing
from whisper_git_tpu_torch.render import compose as PC
from whisper_git_tpu_torch.render import frame as PF
from whisper_git_tpu_torch.render import wire as W
from whisper_git_tpu_torch.render.rasterizer import render_scene_device

torch.set_num_threads(2)

CONF = harness.load_json(harness.ROOT, "portbench", "configs",
                         "history1000-3840x2160-s2.json")
LOGICAL = (400, 250)
POINTER = (300.0, 150.0)     # inside the history pane at this size
CLICKS = 12
STEP = 84.0
SEED = 2**31 + 21


@pytest.fixture(scope="module")
def history_app(tmp_path_factory):
    """The configuration's history as the benchmark builds it (avatars
    primed in a cache of the test's own), the app on it and a renderer on
    the CPU; the port's pulse and caret pinned while the module runs."""
    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.app.views import widgets
    from whisper_git_tpu_torch.render.renderer import Renderer

    tmp = tmp_path_factory.mktemp("readdown")
    mp = pytest.MonkeyPatch()
    for var in ("XDG_CACHE_HOME", "XDG_STATE_HOME", "XDG_CONFIG_HOME"):
        os.makedirs(tmp / var.lower())
        mp.setenv(var, str(tmp / var.lower()))
    mp.setenv("WGIT_MESH", "0")
    mp.delenv("WGIT_FRAME_COMPOSE", raising=False)
    mp.delenv("WGIT_FRAME_CACHE", raising=False)
    pulse, cursor = widgets._PULSE_FREEZE, widgets._CURSOR_FREEZE
    widgets.freeze_pulse(0.0)
    widgets.freeze_cursor(True)
    spec = CONF["history"]
    commits = repo.history(SEED, spec)
    tag_marks = repo.tags(spec, commits)
    path = repo.build_repo(str(tmp), commits, tag_marks)
    emails = repo.prime_avatars(os.environ["XDG_CACHE_HOME"], SEED)
    tab = RepoTab.open(path)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.prefetch_sync(emails, timeout=60.0)
    hist = reference.History(repo.display_order(commits),
                             now=int(time.time()), tagged=tag_marks.values())
    try:
        yield app, tab, Renderer("cpu"), hist
    finally:
        for t in app.tabs:
            t.stop_workers()
        widgets.freeze_pulse(pulse)
        widgets.freeze_cursor(cursor)
        PC.clear_caches()
        PF.clear_caches()
        mp.undo()


class _Evicting(dict):
    """A cache that counts the entries its least-recently-used loop pops
    (`pop(key)`; a hit's re-insert pops with a default)."""

    def __init__(self):
        super().__init__()
        self.evicted = 0

    def pop(self, *args):
        if len(args) == 1:
            self.evicted += 1
        return super().pop(*args)


def _compile(app, renderer, scale):
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame

    w, h = (int(v * scale) for v in LOGICAL)
    return compile_frame(app, renderer, w, h, scale)


def _delta(c0: dict) -> dict:
    c = tracing.counters()
    return {k: c[k] - c0[k] for k in c0 if k.startswith("compose.")}


def _frame_cache(scene, renderer, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("WGIT_FRAME_COMPOSE", "0")
        return render_scene_device(scene, renderer.font_tex_device(),
                                   renderer.image_atlas_device())


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_readdown_rebuilds_and_evicts_within_the_references_limits(
        history_app, monkeypatch, scale):
    app, tab, renderer, hist = history_app
    caches = {name: _Evicting() for name in ("slab", "group", "plan")}
    for name, cache in caches.items():
        monkeypatch.setattr(PC, f"_{name.upper()}_CACHE", cache)
    PC.clear_caches()
    PF.clear_caches()
    built = []
    render_layer = PC._render_layer

    def counted(*args, **kw):
        out = render_layer(*args, **kw)
        if kw.get("layer_i16"):     # a group or slab build, not a tail
            built.append(out.shape[0] * out.shape[1])
        return out
    monkeypatch.setattr(PC, "_render_layer", counted)
    font_tex, lut = reference.font_atlas(harness.ROOT)
    avatars = [repo.avatar_image(SEED, a) for a in range(len(repo.AUTHORS))]
    limit = CONF["limits"]["frame_gap_u8"]
    tab.history_scroll = 0.0
    c0 = tracing.counters()
    gaps, cache_gaps, offsets = [], [], []
    for k in range(CLICKS + 1):
        if k:
            app.on_scroll(STEP, *POINTER)
        scene = _compile(app, renderer, scale)
        offsets.append(tab.history_scroll)
        f0 = tracing.counters()["frames.composed"]
        got = render_scene_device(scene, renderer.font_tex_device(),
                                  renderer.image_atlas_device())
        assert tracing.counters()["frames.composed"] == f0 + 1
        flat = harness.capture(scene)
        layers = reference.splice(flat)
        rows = reference.find_rows(layers, lut, hist, scale,
                                   0.5 * CONF["pane"]["subject_x_px"])
        atlas = reference.expected_atlas(layers, rows, hist, avatars, scale)
        want = reference.raster(layers, flat["height"], flat["width"],
                                flat["background"], font_tex, atlas, "cpu")
        gaps.append(int((got.to(torch.int16)
                         - want.to(torch.int16)).abs().max()))
        cached = _frame_cache(scene, renderer, monkeypatch)
        cache_gaps.append(int((got.to(torch.int16)
                               - cached.to(torch.int16)).abs().max()))
    d = _delta(c0)
    assert offsets == [k * STEP for k in range(CLICKS + 1)]
    assert max(gaps) <= limit, gaps
    assert max(cache_gaps) <= 1, cache_gaps
    assert d["compose.declined_subpixel"] == 0
    assert d["compose.attempted"] == CLICKS + 1
    # Rebuilt, and evicted under the CPU's caps (a quarter of the card's).
    assert d["compose.plan_builds"] >= 4 and d["compose.layer_builds"] >= 4
    assert d["compose.built_px"] == sum(built) > 0
    assert len(built) == d["compose.layer_builds"]
    for name, cache in caches.items():
        assert d[f"compose.{name}_evictions"] == cache.evicted
    assert d["compose.plan_evictions"] > 0
    assert d["compose.group_evictions"] > 0 or scale == 1.0
    if scale == 1.0:
        # The history is a scroll window: slabs, rebuilt as the window's
        # content moves with the layout's 128 px buckets.
        assert d["compose.slab_evictions"] > 0
    else:
        # Scene.scaled splices the window: a plan and a chrome group a
        # scroll frame, no slab.
        assert d["compose.plan_builds"] == CLICKS + 1
        assert d["compose.slab_evictions"] == 0
        assert caches["slab"] == {}


def test_deep_in_the_history_scale_2_quantizes_inside_the_i16_range(
        history_app):
    """At 12,600 px down (the readdown's deepest offset) the scaled scene's
    geometry, which holds the history's rows, quantizes with no
    coordinate at the format's clamp of ±4095.875 px; so does the scroll
    window of the same view at scale 1, its coordinates doubled."""
    app, tab, renderer, _ = history_app
    tab.history_scroll = 12600.0
    geometry = ((0, slice(1, 7)), (2, slice(0, 4)), (5, slice(0, 4)))

    def clamped(src, ns, caps) -> int:
        blob = W.quantize(W.parts(src), ns, caps)
        out, fo = 0, 0
        for j, ((_, cols), c) in enumerate(zip(W.PARTS, W.PART_CLS)):
            part = blob[fo:fo + caps[c] * cols].reshape(caps[c], cols)
            fo += caps[c] * cols
            for pj, sl in geometry:
                if pj == j:
                    out += int((np.abs(part[:ns[c], sl]) >= 32767).sum())
        return out

    scene = _compile(app, renderer, 2.0)
    assert scene.windows == [] and scene.height == 2 * LOGICAL[1]
    n_rows = 0
    for lb in scene.layers:
        ns = (lb.n_shapes, lb.n_glyphs, lb.n_images)
        n_rows += sum(ns)
        assert clamped(lb, ns, ns) == 0
    assert n_rows > 0
    one = _compile(app, renderer, 1.0)
    (w,) = one.windows
    c = w.comp
    doubled = type(c)(
        shapes=np.concatenate([c.shapes[:, :1], c.shapes[:, 1:7] * 2.0,
                               c.shapes[:, 7:]], axis=1),
        shape_clips=c.shape_clips, glyphs=np.concatenate(
            [c.glyphs[:, :4] * 2.0, c.glyphs[:, 4:]], axis=1),
        glyph_colors=c.glyph_colors, glyph_clips=c.glyph_clips,
        images=np.concatenate([c.images[:, :4] * 2.0, c.images[:, 4:]],
                              axis=1),
        image_clips=c.image_clips)
    ns = (c.shapes.shape[0], c.glyphs.shape[0], c.images.shape[0])
    assert min(ns) > 0 and 2.0 * abs(w.dy) < 4095.875
    assert clamped(doubled, ns, ns) == 0
