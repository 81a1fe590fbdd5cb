"""One run of one cell: set-up, warm-up, the measured window, the check.

The window's entry is the app's frame path, one input event at a time,
as the interactive loop's render thread makes a frame: the app's input
handler (`WhisperApp.on_scroll` for a wheel click, `handle_action` on the
scrollbar's drag route), `host/screenshot_mode.py::compile_frame`
(before_build, build, layout, compile, `Scene.scaled`),
`render/rasterizer.py::render_scene_device`, then a wait until the frame
is complete on the device before the next event: a closed loop, one user.
The frame stays on the device. A traced run makes the same calls, with
the renderer's `layout` and `compile` wrapped to stamp the host's clock
as they are entered and return, so that a span covers each step.

Set-up pins the render mesh from the configuration, keeps the app's
configuration, state and avatar cache in the run's temporary directory,
builds the history from the seed, opens it, loads every avatar from the
primed cache, installs the app's interactive GC policy
(`host/gctune.py`, as `host/loop.py` does) and runs the cell's cycle of
events once.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import shutil
import sys
import tempfile
import time

import numpy as np

from . import events, reference, repo

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SAMPLES = 6                    # frames judged to the pixel
SCENES = 24                    # frames whose scene is judged
POINTER = (540.0, 400.0)       # inside the history pane, logical px
MAX_FRAMES = 1 << 20


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> tuple:
    """→ (cell, config entry) of workload `name`."""
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, conf


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that `cell`
    reports: those with no `workloads` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, ctx: dict):
    """The metric's reader, `metrics/<name>.py::read(ctx)`: a number, or
    None where it finds nothing to read."""
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(ctx)


def capture(scene) -> dict:
    """Plain views of the program's compiled scene, for the reference (the
    arrays of a compiled scene are fresh each frame, a window's chunks are
    never written again)."""
    def part(p):
        if p is None:
            return None
        return {"shapes": p.shapes, "shape_clips": p.shape_clips,
                "glyphs": p.glyphs, "glyph_colors": p.glyph_colors,
                "glyph_clips": p.glyph_clips, "images": p.images,
                "image_clips": p.image_clips, "dyn": part(p.dyn)}

    layers = []
    for lb in scene.layers:
        ns, ng, ni = int(lb.n_shapes), int(lb.n_glyphs), int(lb.n_images)
        layers.append({"shapes": lb.shapes[:ns],
                       "shape_clips": lb.shape_clips[:ns],
                       "glyphs": lb.glyphs[:ng],
                       "glyph_colors": lb.glyph_colors[:ng],
                       "glyph_clips": lb.glyph_clips[:ng],
                       "images": lb.images[:ni],
                       "image_clips": lb.image_clips[:ni],
                       "n_shapes": ns, "n_glyphs": ng, "n_images": ni})
    wins = [{"layer": int(w.layer), "dx": float(w.dx), "dy": float(w.dy),
             "clip": tuple(float(c) for c in w.clip),
             "pos": tuple(int(p) for p in w.pos), "comp": part(w.comp)}
            for w in scene.windows]
    return {"width": int(scene.width), "height": int(scene.height),
            "background": tuple(float(c) for c in scene.background),
            "layers": layers, "windows": wins}


class Sampler:
    """Two reservoirs of the window's frames, drawn from the seed: frame i
    takes a slot of a reservoir of k with chance k / (i + 1). SCENES
    frames keep their event's index and their scene; SAMPLES frames keep
    those and a copy of their pixels in pinned host memory. The copy is
    the harness's work, not the program's: it is waited for, and its
    interval on the host's clock is kept in `spans`, so that the device
    trace leaves it out."""

    def __init__(self, torch, seed: int, shape: tuple, pin: bool):
        self.torch = torch
        self.rng = random.Random(f"portbench-sample-{seed}")
        self.scene_rng = random.Random(f"portbench-scene-{seed}")
        self.bufs = [torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
                     for _ in range(SAMPLES)]
        self.kept = [None] * SAMPLES
        self.scenes = [None] * SCENES
        self.spans = []

    @staticmethod
    def _slot(rng, k: int, i: int):
        if i < k:
            return i
        j = rng.randrange(i + 1)
        return j if j < k else None

    def slot(self, i: int):
        return self._slot(self.rng, SAMPLES, i)

    def scene_slot(self, i: int):
        return self._slot(self.scene_rng, SCENES, i)

    def keep(self, j: int, n_event: int, scene, img) -> None:
        t0 = time.perf_counter_ns()
        self.bufs[j].copy_(img, non_blocking=True)
        if img.is_cuda:
            self.torch.cuda.current_stream(img.device).synchronize()
        self.spans.append((t0, time.perf_counter_ns()))
        self.kept[j] = (n_event, capture(scene))


def _pin_env(conf: dict, tmp: str) -> None:
    mesh = conf.get("WGIT_MESH")
    if mesh is None:
        os.environ.pop("WGIT_MESH", None)
    else:
        os.environ["WGIT_MESH"] = str(mesh)
    for var in ("XDG_CACHE_HOME", "XDG_STATE_HOME", "XDG_CONFIG_HOME"):
        os.environ[var] = os.path.join(tmp, var.lower())
        os.makedirs(os.environ[var], exist_ok=True)


def run_cell(cell: dict, conf: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             t_proc: float | None = None, wrap=None, log=sys.stderr,
             control: bool = False) -> dict:
    """Run the cell → {"ctx": what the metrics read, "checks": the numbers
    compared with their limits, "correct", "attempted", "failed"}.
    `wrap(path)` may replace the timed path's steps (the tests' faults);
    `control` adds the control's reading of every sample
    (`check_samples`)."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        _pin_env(conf, tmp)
        return _run(cell, conf, traffic, seed, seconds, trace, device,
                    t_proc, wrap, log, tmp, control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, conf, traffic, seed, seconds, trace, device, t_proc, wrap,
         log, tmp, control) -> dict:
    import torch

    from whisper_git_tpu_torch.app.repo_tab import RepoTab
    from whisper_git_tpu_torch.app.ui_app import WhisperApp
    from whisper_git_tpu_torch.app.views.widgets import (
        freeze_cursor,
        freeze_pulse,
    )
    from whisper_git_tpu_torch.host.gctune import install_interactive_gc
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render import (
        blocks_kernel,
        compose_kernel,
        raster_kernel,
    )
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import (
        get_renderer,
        kernel_libraries,
        start_kernel_builds,
    )

    cuda = device == "cuda"
    marks = [("imports", time.perf_counter())]
    builds = start_kernel_builds() if cuda else []
    W, H = (int(v) for v in conf["viewport"])
    scale = float(conf["scale"])

    # The history, its repository and the primed avatar cache.
    commits = repo.history(seed, conf["history"])
    tag_marks = repo.tags(conf["history"], commits)
    path = repo.build_repo(tmp, commits, tag_marks)
    emails = repo.prime_avatars(os.environ["XDG_CACHE_HOME"], seed)
    marks.append(("repository", time.perf_counter()))
    # The dirty dot's pulse and the caret blink follow the clock: pinned,
    # so that a frame is a function of its event alone.
    freeze_pulse(0.0)
    freeze_cursor(True)
    tab = RepoTab.open(path)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    app.avatar_cache.prefetch_sync(emails, timeout=60.0)
    loaded = sum(1 for e in emails
                 if app.avatar_cache.get(e) is not None)
    marks.append(("app", time.perf_counter()))
    renderer = get_renderer(device)
    marks.append(("renderer", time.perf_counter()))
    mesh = None
    if cuda:
        from whisper_git_tpu_torch.render.meshstate import get_render_mesh

        mesh = get_render_mesh()
    cards = sorted({d.index for d in mesh.flat}) if mesh is not None \
        else ([torch.cuda.current_device()] if cuda else [])
    for t in builds:
        t.join()
    marks.append(("kernel builds", time.perf_counter()))
    if cuda and any(st["lib"] is None for st in kernel_libraries().values()):
        # Built again, and raised, at the first launch.
        print("# a kernel library did not build in the background",
              file=log)
    hist = reference.History(repo.display_order(commits),
                             now=int(time.time()), tagged=tag_marks.values())
    ev = events.cycle(traffic, seed, hist.total)
    L = len(ev["cycle"])
    lead = len(ev["lead_in"])
    print(f"# {len(tab.commits)} rows, commit limit {tab.commit_limit}, "
          f"{loaded} of {len(emails)} avatars loaded, mesh "
          f"{None if mesh is None else [str(d) for d in mesh.flat]}, "
          f"cycle {L} events (+{lead} lead-in)", file=log)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def handle(e):
        kind, dy = e
        if kind == "wheel":
            app.on_scroll(dy, *POINTER)
        else:
            app.handle_action(f"scroll-drag:history:0.00:{dy:.2f}",
                              *POINTER)

    path_ = {"handle": handle,
             "compile": lambda: compile_frame(app, renderer, W, H, scale),
             "render": lambda scene: render_scene_device(
                 scene, renderer.font_tex_device(),
                 renderer.image_atlas_device())}
    if wrap is not None:
        path_ = wrap(path_)

    # The profiler starts before the warm-up, so that the app's 30 s
    # timers (the status safety net, Rewind), which the warm-up's first
    # frame starts, fall after the window.
    tracer = None
    t_prof = time.perf_counter()
    if cuda:
        from .trace import DeviceTrace

        tracer = DeviceTrace(torch, cards)
        tracer.start()
    marks.append(("profiler start", time.perf_counter()))
    profiler_s = marks[-1][1] - t_prof
    # Warm-up: the lead-in and the cycle once; a traced run counts each
    # cycle position's work from its scene here.
    install_interactive_gc()
    per_position = []
    n_event = 0
    for _ in range(lead + L):
        path_["handle"](events.event_at(ev, n_event))
        scene = path_["compile"]()
        path_["render"](scene)
        sync()
        if trace and n_event >= lead:
            from .counts import frame_counts

            layers = reference.splice(capture(scene))
            per_position.append(frame_counts(layers, H, W))
        n_event += 1

    marks.append(("warm-up", time.perf_counter()))
    shape = (H, W, 4)
    sampler = Sampler(torch, seed, shape, pin=cuda)
    lat = np.zeros(MAX_FRAMES, np.int64)
    phase = np.zeros((MAX_FRAMES, 6), np.int64) if trace else None
    kernels = (raster_kernel.render_tiles, blocks_kernel.render_tiles_blocks,
               compose_kernel.compose_tiles)
    launches0 = [k.launches for k in kernels]
    moved0 = sum(F.MOVED.values())
    states0 = len(app.avatar_cache._states)
    limit0 = tab.commit_limit
    refresh_starts = {"state": 0, "status": 0}
    busy_state = tab.state_refresh_rx is not None
    busy_status = tab.status_rx is not None
    bad_frames = 0
    print(f"# set-up {time.perf_counter() - t_proc - profiler_s:.3f} s "
          f"without the profiler's start ({profiler_s:.3f} s): " + ", ".join(
        f"{name} {t - (marks[k - 1][1] if k else t_proc):.3f}"
        for k, (name, t) in enumerate(marks)), file=log)
    perf = time.perf_counter_ns
    # In a traced run the renderer's own steps stamp the frame's row:
    # 1 as layout is entered, 2 as it returns; `compile_frame` returning
    # is 3.
    row = np.zeros(6, np.int64)
    if trace:
        layout0 = renderer.layout

        def layout_stamped(*a, **k):
            if not row[1]:
                row[1] = perf()
            out = layout0(*a, **k)
            row[2] = perf()
            return out

        renderer.layout = layout_stamped
    host0 = host_counters()
    t_start = perf()
    # Process start to the window, less the profiler's start: the
    # benchmark's instrument, not the program's set-up.
    setup_s = t_start / 1e9 - t_proc - profiler_s
    t_end = t_start + int(seconds * 1e9)
    i = 0
    t_done = t_start
    while True:
        t0 = perf()
        if t0 >= t_end or i >= MAX_FRAMES:
            break
        path_["handle"](events.event_at(ev, n_event))
        scene = path_["compile"]()
        t3 = perf()
        img = path_["render"](scene)
        t4 = perf()
        sync()
        t_done = perf()
        if trace:
            row[0], row[3], row[4], row[5] = t0, t3, t4, t_done
            phase[i] = row
            row[1] = 0
        lat[i] = t_done - t0
        if tuple(img.shape) != shape or img.dtype != torch.uint8:
            bad_frames += 1
        j = sampler.slot(i)
        if j is not None:
            sampler.keep(j, n_event, scene, img)
        j = sampler.scene_slot(i)
        if j is not None:
            sampler.scenes[j] = (n_event, capture(scene))
        if (tab.state_refresh_rx is not None) and not busy_state:
            refresh_starts["state"] += 1
        if (tab.status_rx is not None) and not busy_status:
            refresh_starts["status"] += 1
        busy_state = tab.state_refresh_rx is not None
        busy_status = tab.status_rx is not None
        i += 1
        n_event += 1
    n = i
    host1 = host_counters()
    if trace:
        del renderer.layout
    for c in cards:
        torch.cuda.synchronize(c)
    window_s = (t_done - t_start) / 1e9
    peak = 0
    if cuda:
        from .device import memory_peak_bytes

        peak = memory_peak_bytes(torch, cards)
    summary = None
    if tracer is not None:
        tracer.stop()
        summary = tracer.summary(t_start, t_done,
                                 None if phase is None else phase[:n],
                                 int(cell["chips"]), sampler.spans)
    launches = {k: kernels[j].launches - launches0[j]
                for j, k in enumerate(("K1", "K2", "K3"))}
    moved = sum(F.MOVED.values()) - moved0
    fetches = len(app.avatar_cache._states) - states0
    p95 = float(np.percentile(lat[:n], 95)) / 1e6 if n else float("nan")
    print(f"# window {window_s:.3f} s, {n} frames, "
          f"{n / window_s if window_s > 0 else 0.0:.3f} frames/s, p95 "
          f"{p95:.4f} ms; refreshes started in "
          f"the window: state {refresh_starts['state']}, status "
          f"{refresh_starts['status']}; walk cap {limit0} -> "
          f"{tab.commit_limit}; avatar fetches {fetches}; launches "
          f"{launches}", file=log)
    for tb in app.tabs:
        tb.stop_workers()

    ctx = {"frames": n, "window_s": window_s, "lat_ns": lat[:n],
           "setup_s": setup_s, "peak_bytes": peak,
           "chips": int(cell["chips"]), "launches": launches,
           "moved_bytes": moved, "trace": summary,
           "phase_ns": None if phase is None else phase[:n]}
    if trace and n:
        from .counts import sum_least

        positions = (np.arange(n_event - n, n_event) - lead) % L
        ctx["least_s"] = sum_least(per_position, positions)

    print("# host over the window: " + ", ".join(
        f"{k} {host1[k] - host0[k]:.3f}" for k in host0), file=log)
    slow = np.argsort(lat[:n])[-5:][::-1]
    print("# slowest frames (index, ms): "
          + ", ".join(f"{int(k)} {lat[k] / 1e6:.3f}" for k in slow), file=log)
    checks, failed = check_samples(sampler, conf, hist, ev, seed, torch,
                                   device, cards, scale, log, control)
    failed += bad_frames
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values()
                                  if c["limit"] is not None)
    return {"ctx": ctx, "checks": checks, "correct": correct,
            "attempted": n, "failed": failed}


def host_counters() -> dict:
    """The CPU seconds this process has used, user and system."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "sys_s": ru.ru_stime}


def check_samples(sampler, conf, hist, ev, seed, torch, device, cards,
                  scale, log, control=False) -> tuple:
    """Judge the kept frames with the reference → (checks, failed: the
    kept frames that fail a limit). Every kept scene is held to the model
    of the history (`row_err_px`, `text_err_rows`); the frames kept to the
    pixel are rasterized again (`frame_gap_u8`). With `control`, also the
    control's reading: the reference computed in bfloat16 against itself
    in float32 on the same scenes (`control_frame_gap_u8`, no limit of its
    own)."""
    kept = [(k, sampler.bufs[j]) for j, k in enumerate(sampler.kept)
            if k is not None]
    scenes = [k for k in sampler.scenes if k is not None]
    n_max = max([k[0] for k, _ in kept] + [k[0] for k in scenes]) + 1 \
        if kept else 0
    offsets = events.replay_offsets(ev, n_max, hist.total)
    font_tex, lut = reference.font_atlas(ROOT)
    avatars = [repo.avatar_image(seed, a) for a in range(len(repo.AUTHORS))]
    dev = f"cuda:{cards[0]}" if device == "cuda" else "cpu"
    limits, pane = conf["limits"], conf["pane"]
    min_rows = int(conf["min_rows"])

    def judge_scene(n_event, layers):
        rows = reference.find_rows(layers, lut, hist, scale,
                                   0.5 * float(pane["subject_x_px"]))
        e = reference.scene_errors(rows, layers, hist,
                                   float(offsets[n_event]), pane, min_rows,
                                   scale)
        return rows, ((reference.MISSING_ROWS_PX, min_rows) if e is None
                      else e)

    row_errs, text_errs, bad = [], [], 0
    for n_event, flat in scenes:
        _, (r, t) = judge_scene(n_event, reference.splice(flat))
        row_errs.append(r)
        text_errs.append(t)
        bad += r > limits["row_err_px"] or t > limits["text_err_rows"]
    gaps, control_gaps = [], []
    for (n_event, flat), buf in kept:
        layers = reference.splice(flat)
        rows, (r, t) = judge_scene(n_event, layers)
        atlas = reference.expected_atlas(layers, rows, hist, avatars, scale)
        ref = reference.raster(layers, flat["height"], flat["width"],
                               flat["background"], font_tex, atlas, dev)
        got = buf.to(dev)
        gap = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
        gaps.append(gap)
        row_errs.append(r)
        text_errs.append(t)
        bad += gap > limits["frame_gap_u8"] or r > limits["row_err_px"] \
            or t > limits["text_err_rows"]
        if control:
            low = reference.raster(layers, flat["height"], flat["width"],
                                   flat["background"], font_tex, atlas, dev,
                                   dtype=torch.bfloat16)
            control_gaps.append(int((low.to(torch.int16)
                                     - ref.to(torch.int16)).abs().max()))
    checks = {
        "frame_gap_u8": {"value": max(gaps) if gaps else 255,
                         "limit": limits["frame_gap_u8"]},
        "row_err_px": {"value": max(row_errs) if row_errs
                       else reference.MISSING_ROWS_PX,
                       "limit": limits["row_err_px"]},
        "text_err_rows": {"value": max(text_errs) if text_errs
                          else min_rows,
                          "limit": limits["text_err_rows"]},
    }
    if control:
        checks["control_frame_gap_u8"] = {"value": min(control_gaps),
                                          "limit": None}
    print(f"# checked {len(scenes)} sampled scenes and {len(kept)} frames "
          f"to the pixel (events {sorted(k[0] for k, _ in kept)}): gaps "
          f"{gaps}, row errors {[round(r, 6) for r in row_errs]}, text "
          f"errors {text_errs}, model rows total {hist.total}", file=log)
    return checks, bad if kept else 1
