"""The port's interactive loop (`host/loop.py`) on the CPU: the wake
deadlines, the caret blinking with no input, the render thread's frame
dump (0 u8 from `render_scene_device` of the same state, within 2 u8 of
the reference loop's dump of the same repository), and a render error
ending the run."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench
from whisper_git_tpu_torch.app.repo_tab import RepoTab
from whisper_git_tpu_torch.app.ui_app import WhisperApp
from whisper_git_tpu_torch.app.views import widgets
from whisper_git_tpu_torch.host.loop import next_wake_timeout, run_loop

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    return bench.build_history_repo(str(tmp_path_factory.mktemp("loop")), 30)


@pytest.fixture
def frozen():
    """The port's pulse and caret pinned, as conftest pins the
    reference's."""
    prev = (widgets._PULSE_FREEZE, widgets._CURSOR_FREEZE)
    widgets.freeze_pulse(0.0)
    widgets.freeze_cursor(True)
    yield
    widgets.freeze_pulse(prev[0])
    widgets.freeze_cursor(prev[1])


def _app(repo: str, size=(480.0, 320.0)) -> WhisperApp:
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    app.config.window_width, app.config.window_height = size
    return app


def test_next_wake_timeout_cases(temp_repo, history):
    tab = RepoTab.open(temp_repo)
    app = WhisperApp.with_tabs([tab])
    try:
        assert next_wake_timeout(app, 0.0) == 1.0
        app.focused_input = "subject"
        assert next_wake_timeout(app, 0.0) == 0.25
        app.focused_input = ""
        app.toasts.append(type("T", (), {"text": "hi", "kind": "info"})())
        assert next_wake_timeout(app, 0.0) == 0.25
    finally:
        tab.stop_workers()
    # The fixture's untracked file: the dirty dot pulses.
    dirty = _app(history)
    try:
        assert next_wake_timeout(dirty, 0.0) == 0.15
    finally:
        for t in dirty.tabs:
            t.stop_workers()


def test_idle_focused_input_blinks_in_loop(temp_repo, monkeypatch):
    """With a focused input and NO input events, consecutive frames see
    both caret phases within ~1.5 s: the wake timer alone drives the
    blink."""
    import time

    prev = widgets._CURSOR_FREEZE
    widgets.freeze_cursor(None)
    monkeypatch.setenv("WGIT_NO_INPUT", "1")
    monkeypatch.delenv("WGIT_FRAME_DUMP", raising=False)
    app = _app(temp_repo)
    app.focused_input = "subject"
    app.focus = "staging"
    phases = []
    orig_build = app.build

    def spy_build(viewport):
        phases.append(widgets.cursor_visible())
        return orig_build(viewport)

    app.build = spy_build
    t0 = time.monotonic()
    try:
        assert run_loop(app, max_frames=7, device="cpu") == 0
    finally:
        widgets.freeze_cursor(prev)
    elapsed = time.monotonic() - t0
    assert len(set(phases)) == 2, (phases, elapsed)
    assert elapsed < 5.0, elapsed


def _read_png(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def test_frame_dump_is_the_frame_and_the_references(history, monkeypatch,
                                                   tmp_path, frozen):
    """run_loop's render thread dumps the last frame: 0 u8 from the port's
    render_scene_device of the app's state after the loop, and within 2
    u8 of the reference loop's dump of the same repository (pulse and
    caret frozen, both packages' compile memos emptied first)."""
    from whisper_git_tpu.app.repo_tab import RepoTab as RefTab
    from whisper_git_tpu.app.ui_app import WhisperApp as RefApp
    from whisper_git_tpu.host.loop import run_loop as ref_run_loop
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import get_renderer

    from test_torch_slice import fresh_compile_caches

    monkeypatch.setenv("WGIT_NO_INPUT", "1")
    renderer = get_renderer("cpu")
    fresh_compile_caches(renderer)
    port_dump = tmp_path / "port.png"
    monkeypatch.setenv("WGIT_FRAME_DUMP", str(port_dump))
    app = _app(history)
    assert run_loop(app, max_frames=3, device="cpu") == 0
    got = _read_png(port_dump)
    assert got.shape == (320, 480, 4) and got.std() > 1.0
    want = render_scene_device(compile_frame(app, renderer, 480, 320),
                               renderer.font_tex_device(),
                               renderer.image_atlas_device()).numpy()
    assert np.array_equal(got, want)

    fresh_compile_caches()
    ref_dump = tmp_path / "ref.png"
    monkeypatch.setenv("WGIT_FRAME_DUMP", str(ref_dump))
    tab = RefTab.open(history)
    tab.refresh_sync(include_orphans=False)
    ref_app = RefApp.with_tabs([tab])
    ref_app.config.window_width, ref_app.config.window_height = 480.0, 320.0
    assert ref_run_loop(ref_app, max_frames=3) == 0
    ref = _read_png(ref_dump)
    d = np.abs(got.astype(int) - ref.astype(int))
    print(f"loop dump vs the reference's: max {d.max()} u8, "
          f">2 u8 on {(d > 2).mean():.6f}")
    assert d.max() <= 2


def test_render_error_raises_from_run_loop(history, monkeypatch, tmp_path):
    from whisper_git_tpu_torch.render.renderer import get_renderer

    monkeypatch.setenv("WGIT_NO_INPUT", "1")
    monkeypatch.setenv("WGIT_FRAME_DUMP", str(tmp_path / "never.png"))

    class Boom(RuntimeError):
        pass

    def bad_compile(*a, **k):
        raise Boom("render worker died")

    monkeypatch.setattr(get_renderer("cpu"), "compile", bad_compile)
    with pytest.raises(Boom):
        run_loop(_app(history), max_frames=50, device="cpu")
    assert not (tmp_path / "never.png").exists()


def test_cuda_without_a_gpu_raises_before_the_loop(history, monkeypatch,
                                                  tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WGIT_NO_INPUT", "1")
    monkeypatch.setenv("WGIT_FRAME_DUMP", str(tmp_path / "never.png"))
    app = _app(history)
    builds = []
    monkeypatch.setattr(app, "before_build", lambda: builds.append(1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_loop(app, max_frames=1)
    assert not builds
    for tab in app.tabs:
        tab.stop_workers()
