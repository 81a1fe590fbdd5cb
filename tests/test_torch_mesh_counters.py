"""What the render mesh counts, on the CPU: `mesh.frames` (a frame whose
device work a mesh split), `mesh.shard_launches` (the kernel launches its
shards made), the `moved.*` bytes (`frame.MOVED`, registered with
`tracing`) and the `mesh.replicate` span inside each `shard` span.

The history view at 1280x800 over a mesh of four entries, each the CPU
(`meshstate.CPU_DEVICES = 4`, `WGIT_MESH=4`, as `maybe_auto_mesh` installs
it): a steady composed frame is one mesh frame of four K3 slices, a frame
cache frame one of four K2 slices, both `torch.equal` to one device's
frame; the CPU repeated copies nothing, so `moved.*` stay at zero. Over a
mesh of the CPU and `meta` (a device that holds shapes and no data, the
kernels stubbed) the copies are real, and the registered counters move by
exactly what `frame.MOVED` does. With no mesh nothing is counted."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from whisper_git_tpu_torch import bench, tracing
from whisper_git_tpu_torch.parallel import mesh as PM
from whisper_git_tpu_torch.render import compose as C
from whisper_git_tpu_torch.render import frame as F
from whisper_git_tpu_torch.render import meshstate as MS
from whisper_git_tpu_torch.render import rasterizer as R

torch.set_num_threads(2)

CPU = torch.device("cpu")
META = torch.device("meta")
MESH_KEYS = ("mesh.frames", "mesh.shard_launches")
MOVED_KEYS = tuple(f"moved.{k}" for k in F.MOVED)


@pytest.fixture(scope="module")
def history_view(tmp_path_factory):
    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.app.views import widgets
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render.renderer import Renderer

    # The dirty dot pulses with the clock: pinned, so that two compiles of
    # one offset are one scene.
    prev = widgets._PULSE_FREEZE
    widgets.freeze_pulse(0.0)
    repo = bench.build_history_repo(str(tmp_path_factory.mktemp("mesh")),
                                    60)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    renderer = Renderer("cpu")

    def compile_at(off):
        tab.history_scroll = float(off)
        return compile_frame(app, renderer, 1280, 800)

    yield SimpleNamespace(renderer=renderer, compile_at=compile_at)
    for t in app.tabs:
        t.stop_workers()
    widgets.freeze_pulse(prev)


@pytest.fixture
def mesh4(monkeypatch):
    """The mesh `maybe_auto_mesh` installs with WGIT_MESH=4 over four CPU
    entries; caches cleared before and after, the mesh taken down."""
    monkeypatch.setattr(MS, "CPU_DEVICES", 4)
    monkeypatch.setenv("WGIT_MESH", "4")
    _clear()
    mesh = MS.maybe_auto_mesh("cpu")
    assert mesh is not None and mesh.flat == (CPU,) * 4
    yield mesh
    MS.set_render_mesh(None)
    _clear()


def _clear():
    # The layer caches key without the mesh, and the tails' high-water
    # marks are process state (another file's volatile glyphs would leave
    # an empty glyph tail, pre-rendered by K2, in every later frame).
    C.clear_caches()
    F.clear_caches()
    F._DYN_HW.clear()
    F._WR_HW.clear()


def _render(view, off):
    scene = view.compile_at(off)
    return R.render_scene_device(scene, view.renderer.font_tex_device(),
                                 view.renderer.image_atlas_device())


def _counted(work):
    """work() → (its result, every counter's change over it, `frame.MOVED`'s
    change over it)."""
    c0, m0 = tracing.counters(), dict(F.MOVED)
    out = work()
    c1 = tracing.counters()
    return out, {k: c1[k] - c0[k] for k in c0}, \
        {k: F.MOVED[k] - m0[k] for k in F.MOVED}


def _one_device_frame(view, off):
    """The same frame with no mesh, from empty caches."""
    prev = MS.get_render_mesh()
    MS.set_render_mesh(None)
    _clear()
    try:
        return _render(view, off)
    finally:
        _clear()
        MS.set_render_mesh(prev)


@pytest.mark.parametrize("path", ["compose", "frame_cache"])
def test_a_mesh_frame_counts_once_and_a_launch_a_shard(history_view, mesh4,
                                                       monkeypatch, path):
    """A steady frame (its plan or chrome warm) over four entries: one mesh
    frame, four shard launches (13 tile rows padded to 16: 4, 4, 4 and 1
    rows of the frame), nothing moved, the frame one device's."""
    if path == "frame_cache":
        monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    served = "frames.composed" if path == "compose" else "frames.frame_cache"
    _render(history_view, 0.0)           # plan or chrome built
    frame, d, moved = _counted(lambda: _render(history_view, 28.0))
    assert d[served] == 1
    assert d["mesh.frames"] == 1 and d["mesh.shard_launches"] == 4
    if path == "compose":
        assert d["compose.plan_hits"] == 1 and d["compose.layer_builds"] == 0
    assert all(d[k] == 0 for k in MOVED_KEYS) and not any(moved.values())
    assert torch.equal(frame, _one_device_frame(history_view, 28.0))


@pytest.mark.parametrize("path", ["compose", "frame_cache"])
def test_one_device_counts_nothing(history_view, monkeypatch, path):
    if path == "frame_cache":
        monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    MS.set_render_mesh(None)
    _clear()
    try:
        for off in (0.0, 28.0, 56.0):
            _, d, _ = _counted(lambda: _render(history_view, off))
            assert all(d[k] == 0 for k in MESH_KEYS + MOVED_KEYS), off
    finally:
        _clear()


def test_a_plan_build_counts_its_layer_slices(history_view, mesh4,
                                              monkeypatch):
    """A plan build renders its layers through K2 slices: each slice that
    holds a row counts as a shard launch, beside the frame's own four K3
    slices; the frame is still one mesh frame."""
    calls = {"K2": 0, "K3": 0}

    def counting(name, fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            calls[name] += out.shape[0] > 0
            return out
        return wrapper

    monkeypatch.setattr(F, "render_tiles_blocks",
                        counting("K2", F.render_tiles_blocks))
    monkeypatch.setattr(C, "compose_tiles",
                        counting("K3", C.compose_tiles))
    _, d, _ = _counted(lambda: _render(history_view, 0.0))
    assert d["compose.plan_builds"] == 1 and d["mesh.frames"] == 1
    assert d["compose.layer_builds"] > 0 and calls["K3"] == 4
    assert calls["K2"] >= d["compose.layer_builds"]
    assert d["mesh.shard_launches"] == calls["K2"] + calls["K3"]


def test_moved_counters_are_frame_moved_over_two_devices(history_view,
                                                         monkeypatch):
    """The frame cache over the CPU and `meta`, the blocks kernel stubbed
    (nothing renders on `meta`): every frame the registered `moved.*`
    counters move by what `frame.MOVED` does, the frame's own tables reach
    the second device each frame, and each frame is one mesh frame of two
    shard launches."""
    def stub(layers_blocks, font_tex, image_atlas, background, tiles_y,
             tiles_x, height, width, *, n_tiles, tile0, **kw):
        r0, r1 = tile0 // tiles_x, (tile0 + n_tiles) // tiles_x
        rows = max(0, min(r1 * 64, height) - r0 * 64)
        return torch.zeros((rows, width, 4), dtype=torch.uint8)

    monkeypatch.setattr(F, "render_tiles_blocks", stub)
    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
    _clear()
    for k in F.MOVED:
        F.MOVED[k] = 0
    MS.set_render_mesh(PM.Mesh([[CPU, META]]))
    try:
        for i in range(6):
            _, d, moved = _counted(
                lambda: _render(history_view, (i * 17) % 400))
            assert {k: d[f"moved.{k}"] for k in F.MOVED} == moved, i
            assert moved["replicas"] > 0, i
            assert d["mesh.frames"] == 1 and d["mesh.shard_launches"] == 2
    finally:
        MS.set_render_mesh(None)
        _clear()


def test_replicate_spans_nest_under_shard(history_view, mesh4, monkeypatch):
    """With tracing on, each `shard` span holds one `mesh.replicate`: four
    a composed frame, four a frame cache frame."""
    _render(history_view, 0.0)
    tracing.enable()
    try:
        _render(history_view, 28.0)
        monkeypatch.setenv("WGIT_FRAME_COMPOSE", "0")
        _render(history_view, 28.0)
    finally:
        tracing.disable()
    spans = tracing.collect()["spans"]
    by_id = {s.sid: s for s in spans}
    shards = [s for s in spans if s.name == "shard"]
    reps = [s for s in spans if s.name == "mesh.replicate"]
    assert len(shards) == len(reps) == 8
    for r in reps:
        parent = by_id[r.parent]
        assert parent.name == "shard" and parent.tid == r.tid
        assert parent.t0 <= r.t0 <= r.t1 <= parent.t1
    assert sorted(by_id[r.parent].sid for r in reps) \
        == sorted(s.sid for s in shards)
