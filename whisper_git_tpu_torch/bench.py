"""Benchmark of the port: end-to-end frame rendering of the git client's
history view.

    python -m whisper_git_tpu_torch.bench [--device cuda|cpu] [--iters N]
        [--batches N]

Counterpart of the reference's `bench.py`, on the port's path: it builds
the same fixture repository (~240 commits with branch/merge topology), runs
the real app pipeline (state → El tree → layout → scene compile →
`render_scene_device` → the u8 frame on the device) at 1280×800, and
prints ONE JSON line whose metric, `history_view_frame_render`, is the
best batch's end-to-end frames/sec (`vs_baseline`: its ratio to 60 fps).
Beside it: the median batch and every batch, the input→frame latency, the
input→presented-grid latency and the sustained presented rate through the
terminal presenter's path (`host/term_display.py`: the downsample on the
device, the copy into pinned memory, its event), the device's own time a
steady composed frame (`torch.profiler`) with its busy share, each card's
apart, the
plan-rebuild frames of a compose scroll against the 16.7 ms limit, the
5120×2880 frame, the kernels' nvcc builds, the set-up time, the card
(`nvidia-smi`), or "cpu", the cards visible (`device_count`) and the
render mesh the frames ran under (`mesh`: its devices, or null).

On a machine with several cards the renderer installs a mesh over all of
them unless WGIT_MESH says otherwise (`render/meshstate.py`), and a
frame's work spreads over the cards. The device figures are then a card's
each (`device_ms_per_frame_by_card`, `device_busy_share_by_card`: its own
device time a frame, and that over the frames' wall time, never above
1); `device_ms_per_frame` and `device_busy_share` are the busiest card's,
the one that bounds the device's rate.

Each batch of `--iters` frames ends in a `torch.cuda.synchronize()`, on
the current card alone. Under a mesh that covers every card's work of the
batch: a frame's shards end in the gather onto the first card (the
renderer's), and each copy of the gather makes that card's stream wait for
the shard's, so the first card finishes last. On
the CPU (`--device cpu`) the frames run the kernels' plain versions and
the device figures are null; the sample counts of the latency and
presented phases are capped at the batches' frame count, so a short run
stays short. Asking for cuda where there is none is an error. Progress
goes to stderr, prefixed "#".
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

VIEWPORT = (1280, 800)
OVERSIZED = (5120, 2880)
TARGET_FPS = 60.0
WARMUP = 3
ITERS = 80      # frames a batch (the reference's)
BATCHES = 12    # best of N (the reference's)
LATENCY_FRAMES = 40
PRESENTED_FRAMES = 120
PROFILED_FRAMES = 40
REBUILD_SCROLL_FRAMES = 50
GRID = (78, 120)   # a 120×39-cell terminal's half-block grid


def build_history_repo(base: str, n_commits: int = 240) -> str:
    """The bench's fixture repository (the reference's bench.py
    `build_history_repo`): ~240 empty commits with feature branches merged
    every 17 commits, a tag and an untracked file, on pinned dates."""
    path = os.path.join(base, "bench-repo")
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0")

    def git(*args):
        subprocess.run(["git", "-C", path, *args], check=True,
                       capture_output=True, env=env)

    os.makedirs(path, exist_ok=True)
    subprocess.run(["git", "init", "-q", "-b", "main", path], check=True,
                   capture_output=True, env=env)
    git("config", "user.email", "bench@example.com")
    git("config", "user.name", "Bench Author")
    git("commit", "--allow-empty", "-m", "initial commit")
    ts = 1_700_000_000
    i = 0
    while i < n_commits:
        env["GIT_AUTHOR_DATE"] = env["GIT_COMMITTER_DATE"] = str(ts + i * 3600)
        if i % 17 == 13:
            git("checkout", "-q", "-b", f"feature/{i}")
            git("commit", "--allow-empty", "-m",
                f"feature work {i}: adjust widget layout and colors")
            i += 1
            git("checkout", "-q", "main")
            env["GIT_AUTHOR_DATE"] = env["GIT_COMMITTER_DATE"] = str(
                ts + i * 3600)
            git("merge", "--no-ff", "-m", f"merge feature/{i - 1}",
                f"feature/{i - 1}")
        else:
            git("commit", "--allow-empty", "-m",
                f"commit {i}: fix rendering of lane {i % 6} and tidy up the "
                "status pills")
        i += 1
    git("tag", "v1.0")
    with open(os.path.join(path, "dirty.txt"), "w") as f:
        f.write("uncommitted\n")
    return path


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0].strip()


def _median(xs):
    return statistics.median(xs) if xs else None


def parse_args(argv):
    p = argparse.ArgumentParser(prog="whisper_git_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--iters", type=int, default=ITERS,
                   help=f"frames a batch (default {ITERS})")
    p.add_argument("--batches", type=int, default=BATCHES,
                   help=f"batches, the best reported (default {BATCHES})")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    t_proc = time.time()  # "process start" for the first-present metric
    args = parse_args(argv if argv is not None else sys.argv[1:])
    import torch

    from .render.renderer import resolve_device, start_kernel_builds

    device = resolve_device(args.device)
    builds = start_kernel_builds() if device.type == "cuda" else []
    t_setup = time.time()
    tmp = tempfile.mkdtemp(prefix="wgit-bench-")
    try:
        return _run(args, torch, device, builds, t_proc, t_setup, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, torch, device, builds, t_proc, t_setup, tmp) -> int:
    from .app.repo_tab import RepoTab
    from .app.ui_app import WhisperApp
    from .host.screenshot_mode import compile_frame
    from .host.term_display import TermDisplay, _downsample
    from .render import compose as C
    from .render.meshstate import get_render_mesh
    from .render.rasterizer import render_scene_device
    from .render.renderer import get_renderer, kernel_libraries
    from .ui.theme import DARK

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    repo_path = build_history_repo(tmp)
    tab = RepoTab.open(repo_path)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    renderer = get_renderer(device)
    card = card_name(device)
    mesh = get_render_mesh()
    cards = [str(d) for d in mesh.flat] if mesh is not None else None
    t_setup_done = time.time()
    print(f"# setup {t_setup_done - t_setup:.1f}s | device {card} | "
          f"mesh {cards} | {len(tab.commits)} commits", file=sys.stderr)

    W, H = VIEWPORT

    def frame():
        """One full frame: state → El tree → layout → scene compile →
        device rasterization to the presented u8 framebuffer, which stays
        on the device (as a swapchain's would)."""
        tree = app.build((float(W), float(H)))
        root = renderer.layout(tree, VIEWPORT)
        scene = renderer.compile(root, VIEWPORT, DARK.background)
        return render_scene_device(scene, renderer.font_tex_device(),
                                   renderer.image_atlas_device())

    def check(img):
        if tuple(img.shape) != (H, W, 4) or img.dtype != torch.uint8 \
                or img.device.type != device.type \
                or not bool((img[..., 3] == 255).all()):
            raise SystemExit(f"bench: bad frame {tuple(img.shape)} "
                             f"{img.dtype} on {img.device}")

    # First presented frame: one frame, through the presenter's path to a
    # host grid. On a cold `_build/` it waits for the kernels' builds.
    presenter = TermDisplay(VIEWPORT, out=io.StringIO())
    img = frame()
    check(img)
    grid = presenter.readback(_downsample(img, *GRID))
    first_frame_present_s = time.time() - t_proc
    if grid.shape != GRID + (3,):
        raise SystemExit(f"bench: bad grid {grid.shape}")
    for t in builds:
        t.join()
    libs = kernel_libraries()
    if cuda and any(st["lib"] is None for st in libs.values()):
        raise SystemExit("bench: a kernel library did not build")
    kernel_build_s = max(st["seconds"] for st in libs.values())
    kernels_built = sum(1 for st in libs.values() if st["built"])
    print(f"# first frame presented at +{first_frame_present_s:.1f}s "
          f"({kernels_built} kernels built, the longest nvcc "
          f"{kernel_build_s:.1f}s)", file=sys.stderr)

    # Warm over the whole scroll range the batches will touch.
    for off in range(0, 400, 40):
        tab.history_scroll = float(off)
        frame()
        sync()
    for _ in range(WARMUP):
        frame()
        sync()
    # Free-running throughput: frame N+1's host work overlaps frame N's
    # device work; each batch ends in a synchronize.
    batch_fps = []
    for batch in range(args.batches):
        t0 = time.perf_counter()
        for i in range(args.iters):
            # Scroll every frame so the scene changes.
            tab.history_scroll = ((batch * args.iters + i) * 17) % 400
            img = frame()
        sync()
        elapsed = time.perf_counter() - t0
        batch_fps.append(args.iters / elapsed)
        print(f"# batch {batch}: {args.iters / elapsed:.1f} fps",
              file=sys.stderr)
    check(img)
    batch_fps.sort()
    fps = batch_fps[-1]
    median_fps = batch_fps[len(batch_fps) // 2]
    n_samples = args.iters * args.batches

    # The device's own time a steady composed frame: every device event
    # of N frames over offsets of one compose plan (warm), from the
    # profiler, over N, a card's each; the busy share against the same
    # frames' wall.
    device_ms = busy_share = card_ms = card_busy = None
    if cuda:
        card_ms, card_busy = _device_time(
            torch, tab, frame,
            cards or [str(renderer.font_tex_device().device)])
        device_ms, busy_share = max(card_ms.values()), max(card_busy.values())
        print(f"# device time a steady composed frame, ms by card "
              f"{card_ms}, busy share of the wall by card {card_busy}",
              file=sys.stderr)

    # Input→frame latency: one scroll-state change through build, layout,
    # compile and render to a device-complete frame, each frame drained.
    lat_ms = []
    for i in range(min(LATENCY_FRAMES, n_samples)):
        tab.history_scroll = float((i * 29) % 400)
        t0 = time.perf_counter()
        frame()
        sync()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
    latency = _median(lat_ms)

    # Presented latency: the same, through the presenter's path — the
    # downsample on the device, the copy into pinned memory, its event —
    # to the cell grid on the host.
    plat_ms = []
    for i in range(min(LATENCY_FRAMES, n_samples)):
        tab.history_scroll = float((i * 31) % 400)
        t0 = time.perf_counter()
        presenter.readback(_downsample(frame(), *GRID))
        plat_ms.append((time.perf_counter() - t0) * 1e3)
    present_latency = _median(plat_ms)

    # Sustained presented rate: that path frame after frame; at the
    # device's rate a mailbox presenter presents this many and drops the
    # rest.
    n_pres = min(PRESENTED_FRAMES, n_samples)
    t0 = time.perf_counter()
    for i in range(n_pres):
        tab.history_scroll = float((i * 13) % 400)
        presenter.readback(_downsample(frame(), *GRID))
    presented_fps = n_pres / (time.perf_counter() - t0)
    present_drop_rate = max(0.0, 1.0 - presented_fps / fps)

    # Plan-rebuild frames: a compose scroll over 0-400 px from empty
    # layer caches, each frame to a synchronize; a frame that builds a
    # compose plan is a rebuild frame (the first frame apart).
    from .render import frame as F

    F.clear_caches()
    C.clear_caches()
    n_scroll = min(REBUILD_SCROLL_FRAMES, n_samples)
    rebuild_ms = []
    plans = set()
    for i in range(n_scroll):
        tab.history_scroll = float(int(i * 400 / n_scroll))
        t0 = time.perf_counter()
        frame()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        new = {id(p) for p in C._PLAN_CACHE.values()} - plans
        plans |= new
        if new and i > 0:
            rebuild_ms.append(ms)
    # The oversized frame: a 5K screenshot of the same view, from the
    # compiled scene to a synchronize (median of three after one). The
    # plain tile rasterizer over its 1800 tiles takes minutes on the CPU,
    # so only the card runs it.
    oversized_ms = None
    if cuda:
        tab.history_scroll = 0.0
        big = compile_frame(app, renderer, *OVERSIZED)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            out = render_scene_device(big, renderer.font_tex_device(),
                                      renderer.image_atlas_device())
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        if tuple(out.shape) != (OVERSIZED[1], OVERSIZED[0], 4):
            raise SystemExit(f"bench: bad oversized frame {out.shape}")
        oversized_ms = _median(times[1:])

    for tb in app.tabs:
        tb.stop_workers()
    setup_s = t_setup_done - t_setup
    print(f"# frame throughput best {fps:.1f} fps ({1000.0 / fps:.2f} "
          f"ms/frame) | median {median_fps:.1f} fps | latency p50 "
          f"{latency:.2f} ms | presented p50 {present_latency:.2f} ms | "
          f"{len(rebuild_ms)} plan-rebuild frames | setup {setup_s:.1f}s",
          file=sys.stderr)
    print(json.dumps({
        "metric": "history_view_frame_render",
        "value": fps,
        "unit": "frames/sec (1280x800, end-to-end)",
        "vs_baseline": fps / TARGET_FPS,
        "median_fps": median_fps,
        "latency_p50_ms": latency,
        "present_latency_p50_ms": present_latency,
        "first_frame_present_s": first_frame_present_s,
        "device_ms_per_frame": device_ms,
        "device_fps": None if device_ms is None else 1000.0 / device_ms,
        "device_busy_share": busy_share,
        "device_ms_per_frame_by_card": card_ms,
        "device_busy_share_by_card": card_busy,
        "presented_fps": presented_fps,
        "present_drop_rate": present_drop_rate,
        "rebuild_ms_p50": _median(rebuild_ms),
        "rebuild_ms_max": max(rebuild_ms) if rebuild_ms else None,
        "rebuild_frames": len(rebuild_ms),
        "oversized_ms": oversized_ms,
        "kernel_build_s": kernel_build_s,
        "kernels_built": kernels_built,
        "setup_s": setup_s,
        "iters_per_batch": args.iters,
        "batches_fps": batch_fps,
        "device": card,
        "device_count": torch.cuda.device_count(),
        "mesh": cards,
    }))
    return 0


def card_device_us(events, cards) -> dict:
    """Device time in µs on each of `cards` ("cuda:<i>" names), from a
    profiler's events: the time of every event it recorded on a CUDA
    device, summed under that device."""
    out = {c: 0.0 for c in cards}
    for e in events:
        if getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            name = f"cuda:{e.device_index}"
            out[name] = out.get(name, 0.0) + e.self_device_time_total
    return out


def _device_time(torch, tab, frame, cards) -> tuple[dict, dict]:
    """({card: device ms a frame}, {card: busy share}): the profiler's
    device events over PROFILED_FRAMES steady composed frames at offsets
    0-120 (one compose plan, warmed first), summed on each of `cards`
    (`card_device_us`) and divided by the frames; and each card's sum over
    the frames' wall time."""
    from torch.profiler import ProfilerActivity, profile

    offsets = [float(8 * (i % 16)) for i in range(PROFILED_FRAMES)]
    for off in offsets[:16]:
        tab.history_scroll = off
        frame()
    torch.cuda.synchronize()
    for _ in range(3):   # a fresh profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for off in offsets:
                tab.history_scroll = off
                frame()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev_us = card_device_us(prof.events(), cards)
        if sum(dev_us.values()) > 0:
            return ({c: us / len(offsets) / 1e3 for c, us in dev_us.items()},
                    {c: us / wall_us for c, us in dev_us.items()})
    raise SystemExit("bench: the profiler recorded no device time")


if __name__ == "__main__":
    sys.exit(main())
