"""The port's spans and counters (`whisper_git_tpu_torch/tracing.py`) on
the CPU: nesting, parents, threads and frame numbers; nothing recorded
while off; the buffer's bound; the clock; the collector's spans; the
counters at their sites on scenes that compose, decline and take the
oversized path; the uploads counted against the arrays handed over; the
Chrome trace-event export; and the scanner's counters unchanged."""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

from whisper_git_tpu_torch import tracing
from whisper_git_tpu_torch.gitcore import native
from whisper_git_tpu_torch.render import compose as PC
from whisper_git_tpu_torch.render import frame as PF
from whisper_git_tpu_torch.render import rasterizer as P
from whisper_git_tpu_torch.render import transfer
from whisper_git_tpu_torch.render.renderer import Renderer
from whisper_git_tpu_torch.tools.synthetic import synthetic_scene

torch.set_num_threads(2)


@pytest.fixture
def traced():
    """Tracing on for the test, off after it whatever happens."""
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


@pytest.fixture(scope="module")
def port():
    return Renderer("cpu")


def _names(spans):
    return [s.name for s in spans]


def _delta(before: dict) -> dict:
    now = tracing.counters()
    return {k: now[k] - before[k] for k in before if now[k] != before[k]}


# ---- spans ------------------------------------------------------------------

def test_spans_nest_with_parents_threads_and_frames(traced):
    n = tracing.next_frame()
    with tracing.span("render") as outer:
        with tracing.span("compose.plan", hit=0) as inner:
            inner.set(hit=1)
        with tracing.span("compose.blob"):
            pass
    other = []

    def work():
        tracing.set_frame(n)
        with tracing.span("refresh.state"):
            with tracing.span("diff_stats"):
                other.append(threading.get_ident())

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    spans = {s.name: s for s in tracing.collect()["spans"]}
    assert set(spans) == {"render", "compose.plan", "compose.blob",
                          "refresh.state", "diff_stats"}
    assert spans["render"].parent is None
    assert spans["compose.plan"].parent == spans["render"].sid \
        == spans["compose.blob"].parent == outer.sid
    assert spans["compose.plan"].attrs == {"hit": 1}
    assert spans["refresh.state"].parent is None
    assert spans["diff_stats"].parent == spans["refresh.state"].sid
    main = threading.get_ident()
    assert {spans[k].tid for k in ("render", "compose.plan")} == {main}
    assert {spans[k].tid for k in ("refresh.state", "diff_stats")} \
        == {other[0]} != {main}
    assert {s.frame for s in spans.values()} == {n}
    # Children end before their parent, inside it.
    r, c = spans["render"], spans["compose.blob"]
    assert r.t0 <= c.t0 <= c.t1 <= r.t1


def test_off_records_nothing_and_returns_the_shared_noop():
    tracing.enable()     # an empty buffer
    tracing.disable()
    assert not tracing.enabled()
    a = tracing.span("render")
    b = tracing.span("compose.plan", hit=1)
    assert a is b is tracing.NOOP
    with a as s:
        s.set(hit=0)
        with tracing.span("frame.pack"):
            pass
    assert tracing.collect()["spans"] == []
    # An exception passes through a span, off or on.
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        with pytest.raises(KeyError):
            with tracing.span("render"):
                raise KeyError("through")
    assert _names(tracing.collect()["spans"]) == ["render"]
    # A span open as tracing goes off records nothing.
    tracing.enable()
    with tracing.span("render"):
        tracing.disable()
    assert tracing.collect()["spans"] == []


def test_the_buffer_keeps_the_newest_spans(monkeypatch, traced):
    assert tracing._BUF.maxlen == tracing.MAX_SPANS == 1 << 20
    monkeypatch.setattr(tracing, "_BUF", deque(maxlen=16))
    for i in range(40):
        with tracing.span("layout", i=i):
            pass
    got = tracing.collect()
    assert [s.attrs["i"] for s in got["spans"]] == list(range(24, 40))
    assert got["dropped"] == 24


def test_times_are_perf_counter_ns(traced):
    t_before = time.perf_counter_ns()
    with tracing.span("compile"):
        t_inside = time.perf_counter_ns()
    t_after = time.perf_counter_ns()
    (s,) = tracing.collect()["spans"]
    assert t_before <= s.t0 <= t_inside <= s.t1 <= t_after


def test_collections_are_spans_only_while_on():
    tracing.enable()
    try:
        with tracing.span("compose.plan_build") as outer:
            gc.collect()
        spans = tracing.collect()["spans"]
    finally:
        tracing.disable()
    gcs = [s for s in spans if s.name == "gc"]
    assert gcs and gcs[-1].attrs == {"gen": 2}
    assert gcs[-1].parent == outer.sid
    assert tracing._gc_hook not in gc.callbacks
    gc.collect()
    assert tracing.collect()["spans"] == spans


def test_spans_from_many_threads_keep_their_own_parents(traced):
    """More threads than cores, switching often: each thread's spans keep
    their thread's parents, and none is lost."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads_n, reps = 16, 200

    def work(k):
        for _ in range(reps):
            with tracing.span("shard", card=k):
                with tracing.span("gather", card=k):
                    pass

    try:
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(threads_n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    spans = [s for s in tracing.collect()["spans"] if s.name != "gc"]
    assert len(spans) == 2 * threads_n * reps
    by_id = {s.sid: s for s in spans}
    for s in spans:
        if s.name == "gather":
            p = by_id[s.parent]
            assert p.name == "shard" and p.tid == s.tid \
                and p.attrs == s.attrs


# ---- counters at their sites ------------------------------------------------

@pytest.fixture(scope="module")
def window_scene(port):
    """One scene with a scroll window (its content uid fixed), and that
    scene at a given scroll offset."""
    sc = synthetic_scene("window", 5, port.regular,
                         port.regular.texture.shape[0])

    def at(dy: float):
        return dataclasses.replace(
            sc, windows=[dataclasses.replace(w, dy=dy) for w in sc.windows])
    return at


def _render(scene, port):
    return P.render_scene_device(scene, port.font_tex_device())


def test_a_whole_pixel_scroll_composes_then_hits_its_plan(port,
                                                          window_scene):
    PC.clear_caches()
    scene = window_scene(-40.0)
    c0 = tracing.counters()
    _render(scene, port)
    d = _delta(c0)
    assert d["frames.composed"] == d["compose.attempted"] == 1
    assert d["compose.plan_builds"] == 1 and "compose.plan_hits" not in d
    assert d["compose.layer_builds"] >= 1
    assert "frames.frame_cache" not in d
    c1 = tracing.counters()
    _render(window_scene(-41.0), port)
    d = _delta(c1)
    assert d["frames.composed"] == d["compose.plan_hits"] == 1
    assert "compose.plan_builds" not in d and "compose.layer_builds" not in d


def test_a_fractional_offset_declines_to_the_frame_cache(port, window_scene,
                                                        traced):
    scene = window_scene(-40.375)
    c0 = tracing.counters()
    _render(scene, port)
    d = _delta(c0)
    assert d["compose.attempted"] == d["compose.declined_subpixel"] \
        == d["frames.frame_cache"] == 1
    assert "frames.composed" not in d
    names = _names(tracing.collect()["spans"])
    assert names[-1] == "render"
    assert {"frame.pack", "frame.blocks", "frame.launch"} <= set(names)
    assert not any(n.startswith("compose.") for n in names)


def test_an_oversized_scene_takes_its_path(port, traced):
    scene = synthetic_scene("shapes", 2, port.regular,
                            port.regular.texture.shape[0], width=4224,
                            height=64)
    assert max(scene.width, scene.height) > P.MAX_PACKED_PX
    c0 = tracing.counters()
    _render(scene, port)
    d = _delta(c0)
    assert d["frames.oversized"] == 1 and "compose.attempted" not in d
    spans = tracing.collect()["spans"]
    assert _names(spans) == ["oversized.inline", "oversized.bin",
                             "oversized.upload", "oversized.launch",
                             "render"]
    assert {s.parent for s in spans[:-1]} == {spans[-1].sid}


def test_uploads_count_the_arrays_handed_over(port):
    a = np.arange(12, dtype=np.int16).reshape(3, 4)
    c0 = tracing.counters()
    t = transfer.upload(a, "cpu")
    assert torch.equal(t, torch.from_numpy(a))
    assert _delta(c0) == {"upload.calls": 1, "upload.bytes": a.nbytes}
    # The oversized path hands over the scene's atlas, then per layer its
    # seven tables and three bins.
    scene = synthetic_scene("shapes", 3, port.regular,
                            port.regular.texture.shape[0], width=4224,
                            height=64)
    flat = scene.inline_windows()
    ty, tx = -(-flat.height // P.TILE_H), -(-flat.width // P.TILE_W)
    want = scene.image_atlas.nbytes
    for lb in flat.layers:
        bins = (P._bin_commands(P._shape_boxes(lb.shapes, lb.n_shapes),
                                lb.n_shapes, ty, tx, P.K_SHAPES)[0],
                P._bin_commands(P._quad_boxes(lb.glyphs, lb.n_glyphs),
                                lb.n_glyphs, ty, tx, P.K_GLYPHS)[0],
                P._bin_commands(P._quad_boxes(lb.images, lb.n_images),
                                lb.n_images, ty, tx, P.K_IMAGES)[0])
        want += sum(x.nbytes for x in (lb.shapes, lb.shape_clips, lb.glyphs,
                                       lb.glyph_colors, lb.glyph_clips,
                                       lb.images, lb.image_clips) + bins)
    c1 = tracing.counters()
    _render(scene, port)
    assert _delta(c1) == {"frames.oversized": 1,
                          "upload.calls": 1 + 10 * len(flat.layers),
                          "upload.bytes": want}
    # A readback counts the frame's bytes.
    c2 = tracing.counters()
    img = P.render_scene(scene, port.font_tex_device())
    d = _delta(c2)
    assert d["readback.calls"] == 1 and d["readback.bytes"] == img.nbytes


def test_a_frame_cache_frame_uploads_its_blob_only_when_warm(port,
                                                             window_scene):
    atlas = torch.from_numpy(window_scene(0.0).image_atlas)
    P.render_scene_device(window_scene(-40.625), port.font_tex_device(),
                          atlas)
    c0 = tracing.counters()
    P.render_scene_device(window_scene(-44.625), port.font_tex_device(),
                          atlas)
    d = _delta(c0)
    blob = PF.pack_frame(window_scene(-44.625))[0]
    assert d["upload.calls"] == 1 and d["upload.bytes"] == blob.nbytes


def test_frame_log_gives_the_counters_as_a_frame_began():
    tracing.next_frame()
    t = time.perf_counter_ns()
    before = dict(tracing.COUNTERS)
    n = tracing.next_frame()
    tracing.COUNTERS["upload.calls"] += 3
    assert tracing.FRAME_LOG[-1][1] == n
    assert tracing.counters_at(t) == before
    assert tracing.counters_at(time.perf_counter_ns()) is None


# ---- the way out --------------------------------------------------------------

def test_chrome_export_round_trip(tmp_path, traced):
    n = tracing.next_frame()
    with tracing.span("render"):
        with tracing.span("shard", card=1):
            pass
    path = tmp_path / "trace.json"
    tracing.write_chrome(str(path))
    got = json.loads(path.read_text())
    spans = tracing.collect()["spans"]
    xs = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert [(e["name"], e["tid"], e["args"]["id"]) for e in xs] \
        == [(s.name, s.tid, s.sid) for s in spans]
    for e, s in zip(xs, spans):
        assert e["ts"] == pytest.approx(s.t0 / 1e3)
        assert e["dur"] == pytest.approx((s.t1 - s.t0) / 1e3)
        assert e["args"]["frame"] == n
    shard = next(e for e in xs if e["name"] == "shard")
    assert shard["args"]["card"] == 1 and \
        shard["args"]["parent"] == spans[-1].sid
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M"}
    assert threading.current_thread().name in names
    cs = [e for e in got["traceEvents"] if e["ph"] == "C"]
    assert cs and cs[-1]["args"]["frame"] == n
    assert set(tracing.COUNTERS) <= set(cs[-1]["args"])
    assert got["otherData"]["counters"]["frames.composed"] \
        == tracing.COUNTERS["frames.composed"]


def test_loop_writes_the_trace_it_was_asked_for(temp_repo, monkeypatch,
                                                tmp_path):
    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.host.loop import run_loop

    out = tmp_path / "loop-trace.json"
    monkeypatch.setenv("WGIT_NO_INPUT", "1")
    monkeypatch.setenv("WGIT_FRAME_DUMP", str(tmp_path / "frame.png"))
    monkeypatch.setenv("WGIT_TRACE", str(out))
    tab = RepoTab.open(temp_repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.enabled = False
    app.config.window_width, app.config.window_height = 320.0, 192.0
    assert run_loop(app, max_frames=2, device="cpu") == 0
    assert not tracing.enabled()
    xs = [e for e in json.loads(out.read_text())["traceEvents"]
          if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"build", "layout", "compile", "render"} <= names
    ui = {e["tid"] for e in xs if e["name"] == "layout"}
    render = {e["tid"] for e in xs if e["name"] == "render"}
    assert ui and render and not ui & render
    # The render thread's frames are the UI thread's numbers.
    assert {e["args"]["frame"] for e in xs if e["name"] == "render"} \
        <= {e["args"]["frame"] for e in xs if e["name"] == "layout"}


def test_scan_stats_keep_their_names_and_meaning():
    native.reset_scan_stats()
    native._count_verdict("quick", True)
    native._count_verdict("quick", False)
    native._count_verdict("status", True)
    s = native.scan_stats()
    assert s == {"quick_certain": 1, "quick_fallback": 1,
                 "status_certain": 1, "status_fallback": 0,
                 "quick_fallback_rate": 0.5, "status_fallback_rate": 0.0}
    c = tracing.counters()
    assert {k: c[f"scan.{k}"] for k in native.SCAN_STATS} \
        == dict(native.SCAN_STATS)
    native.reset_scan_stats()
    assert tracing.counters()["scan.quick_certain"] == 0


def _dots_scene(port):
    """Three volatile dots over the background: a tail of shapes alone."""
    from whisper_git_tpu_torch.ui import rect, row, spacer, stack
    from whisper_git_tpu_torch.ui.theme import DARK

    ui = stack(rect(width="fill", height="fill", fill=DARK.background),
               row(spacer(154),
                   *[el for _ in range(3) for el in
                     (rect(width=12, height=12, radius=6,
                           fill=(0.9, 0.6, 0.2, 0.9), volatile=True),
                      spacer(116))],
                   width="fill", height=60),
               width="fill", height="fill")
    return port.compile(port.layout(ui, (512, 128)), (512, 128),
                        DARK.background)


@pytest.mark.parametrize("tail", ("shapes", "glyphs"))
def test_composed_frames_count_their_tails(port, tail):
    """Over N steady composed frames, a tail of shapes alone counts one
    tail decoded by K3 from the blob a frame and none pre-rendered; the
    volatile scene (a tail of shapes and glyphs on its first layer, one of
    shapes on its second) counts two inline and one pre-rendered a
    frame."""
    if tail == "shapes":
        scene, want = _dots_scene(port), (1, 0)
    else:
        scene = synthetic_scene("volatile", 0, port.regular,
                                port.regular.texture.shape[0])
        scene.windows = [dataclasses.replace(w, dy=float(int(w.dy)))
                         for w in scene.windows]
        want = (2, 1)
    atlas = torch.from_numpy(scene.image_atlas)
    PC.clear_caches()
    P.render_scene_device(scene, port.font_tex_device(), atlas)
    n = 5
    c0 = tracing.counters()
    for _ in range(n):
        P.render_scene_device(scene, port.font_tex_device(), atlas)
    d = _delta(c0)
    assert d["frames.composed"] == d["compose.plan_hits"] == n
    assert d.get("compose.tails_inline", 0) == want[0] * n
    assert d.get("compose.tails_prerendered", 0) == want[1] * n
