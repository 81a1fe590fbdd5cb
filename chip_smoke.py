#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. JAX, Pillow, matplotlib and the JAX package
(`whisper_git_tpu`) are not needed, and must not be imported. Phases,
each fatal on failure:

  1. device   CUDA present; the card's name and power limit (nvidia-smi)
  2. build    the tile kernel K1 and the blocks kernel K2 from
              whisper_git_tpu_torch/csrc, one nvcc each, started together
              (timed; ptxas' registers and spills logged)
  3. kernel   K1 and K2 each against its plain PyTorch version on the
              card, on seeded synthetic scenes of every kind
              (tools/synthetic.py: window scenes give window blocks, one
              has a volatile tail, one cuts chrome into three segments);
              K2 in both output modes (u8 frame, f32 transparent layer)
  4. slice    the history view of a generated repository at 1280x800
              through `render_scene_device`, at the reference's scroll
              offsets and a 0-400 px sweep, once through the packed path
              (WGIT_FRAME_CACHE=0, K1) and once through the frame cache
              (the default, K2): frame shape, each kernel's launch count
              equal to its path's frames and untouched by the other path,
              the two paths' frames equal bit for bit at every reference
              offset, the chrome cache hit on every frame after the first,
              each kernel against its plain version on a few offsets
  5. cli      `python -m whisper_git_tpu_torch --screenshot` writes a
              1280x800 PNG
  6. timings  each kernel and its plain version at the history view (CUDA
              events, median, taken in turns) beside its bound; both
              paths' end-to-end frame time (host clock to a synchronize,
              median) and each stage of a frame alone; the frame cache's
              upload per frame; the device's busy share over 20 frames
              (torch.profiler)

Tolerances (the reference's own): shape-only scenes within 1 u8; scenes
with glyphs or images at most 8 u8 with more than 2 u8 on under 1 % of
values; the empty scene within 1 u8 of the background; an f32 layer the
same in units of 1/255.

A kernel's bound is the larger of two times: the bytes it must move (its
command tables, bins and bounds, the atlas cells its bins reference and
the frame it writes, each once) over 3.35 TB/s, and the arithmetic of
this run's bin entries (entries x 8192 pixels x operations per pixel of
the entry's class) over 67 TFLOP/s, the H100's f32 rate outside the
tensor cores.

Prints the card's line, a JSON line of kernel results, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, on any
failure.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

VIEWPORT = (1280, 800)
SCROLL_OFFSETS = (0.0, 13.0, 17.0, 63.9, 64.0, 100.3, 111.5, 128.5)
SWEEP = tuple(round(0.0 + 8.3 * i, 1) for i in range(49))  # 0 .. 398.4
COMPARE_OFFSETS = (0.0, 63.9, 100.3, 128.5)
TIMED_KERNEL_RUNS = 50
TIMED_PLAIN_RUNS = 5
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def build_history_repo(base: str, n_commits: int = 240) -> str:
    """The bench's fixture repository (bench.py `build_history_repo`):
    ~240 empty commits with feature branches merged every 17 commits, a
    tag and an untracked file, on pinned dates."""
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


def diff_stats(a, b) -> tuple[float, float]:
    """(max |a − b|, share of values differing by more than 2), in u8
    units: an f32 layer is scaled by 255."""
    if a.dtype.is_floating_point:
        d = (a - b).abs() * 255.0
    else:
        d = (a.int() - b.int()).abs().float()
    if not d.numel():
        return 0.0, 0.0
    return float(d.max().item()), float((d > 2).float().mean().item())


def within(kind: str, mx: float, share: float) -> bool:
    if kind in ("shapes", "empty"):
        return mx <= 1
    return mx <= 8 and share < 0.01


# The bound's constants: the H100's memory rate and its f32 rate outside
# the tensor cores, and the arithmetic one bin entry costs on one pixel,
# counted from the step functions in csrc/raster_steps.cuh (a shape: SDF
# 12, two coverages 8, clip 4, two blends 26; a glyph: sample coordinate
# and taps 16, bilinear sum 9, coverage 8, clip 4, blend 13; an image: 16,
# four channels of bilinear sum and scale 32, clip 4, blend 13).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FLOPS_PER_PIXEL = (50, 50, 65)          # shapes, glyphs, images
TILE_PIXELS = 64 * 128
CELL_BYTES = (0, 64 * 64, 64 * 64 * 4)  # atlas cell of a glyph, an image


def kernel_bound(torch, runs, out) -> tuple[float, str, dict]:
    """The least time the card could take for one launch. `runs` lists
    what the launch walks: (class, tables, bins, lo, hi), lo and hi None
    where the whole row counts. → (bound ms, "bytes" | "operations",
    {"entries": per class, "bytes": moved, "busiest_tile_ms",
    "busiest_share"})."""
    entries = [0, 0, 0]
    tile_flops = 0   # per tile: the arithmetic its own bins rows cost
    seen, n_bytes = set(), out.numel() * out.element_size()

    def once(t):
        nonlocal n_bytes
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n_bytes += t.numel() * t.element_size()

    for ci, tables, bins, lo, hi in runs:
        k = torch.arange(bins.shape[1], device=bins.device)[None, :]
        live = bins >= 0
        if lo is not None:
            live &= k >= lo[:, None]
        if hi is not None:
            live &= k < hi[:, None]
        entries[ci] += int(live.sum().item())
        tile_flops = tile_flops + live.sum(dim=1) * (
            TILE_PIXELS * FLOPS_PER_PIXEL[ci])
        for t in (*tables, bins, lo, hi):
            once(t)
        if ci and bool(live.any()):
            uv = tables[0][bins[live].long()][:, 4:6]
            n_bytes += int(torch.unique(uv, dim=0).shape[0]) * CELL_BYTES[ci]
    flops = sum(n * TILE_PIXELS * f for n, f in zip(entries,
                                                    FLOPS_PER_PIXEL))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    # One CTA rasterizes a tile on one of the card's 132 SMs, so a launch
    # cannot end before its busiest tile has, at one SM's share of the peak.
    busiest = (int(tile_flops.max().item())
               if torch.is_tensor(tile_flops) else 0)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations",
            {"entries": tuple(entries), "bytes": n_bytes,
             "busiest_tile_ms": busiest / (PEAK_F32_FLOPS / 132) * 1e3,
             "busiest_share": busiest / flops if flops else 0.0})


def main() -> int:
    import torch

    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    work = tempfile.mkdtemp(prefix="wgit-chip-smoke-")
    for var in ("XDG_STATE_HOME", "XDG_CACHE_HOME", "XDG_CONFIG_HOME"):
        os.environ[var] = os.path.join(work, var.lower())
    os.environ["WGIT_SKIP_AVATARS"] = "1"
    for var in ("JAX_PLATFORMS", "WGIT_DEVICE", "WGIT_FRAME_CACHE"):
        os.environ.pop(var, None)
    try:
        kernels = run_phases(torch, card, kind, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for mod in sorted(sys.modules):
        if mod.partition(".")[0] in ("jax", "jaxlib", "PIL", "matplotlib",
                                     "whisper_git_tpu"):
            fail(f"{mod} was imported")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(torch, card: str, kind: str, work: str) -> list:
    from concurrent.futures import ThreadPoolExecutor

    from whisper_git_tpu_torch.app.views.widgets import freeze_pulse
    from whisper_git_tpu_torch.host.main import open_app
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render import rasterizer as P
    from whisper_git_tpu_torch.render.rasterizer import (
        pack_scene, render_scene_device, unpack_layers)
    from whisper_git_tpu_torch.render.renderer import Renderer
    from whisper_git_tpu_torch.tools.synthetic import KINDS, synthetic_scene

    dev = torch.device("cuda")
    max_err = {"K1": 0.0, "K2": 0.0}

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # one nvcc each, side by side
        infos = [f.result() for f in (pool.submit(K.build),
                                      pool.submit(B.build))]
    build_s = time.perf_counter() - t0
    for name, info in zip(("K1", "K2"), infos):
        log(f"build: {name} {os.path.relpath(info['path'], ROOT)} compiled="
            f"{info['built']} nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: both kernels built and loaded in {build_s:.2f} s")

    renderer = Renderer(dev)
    bold_v = renderer.regular.texture.shape[0]
    font = renderer.font_tex_device()

    def background(scene):
        return tuple(float(c) for c in scene.background[:3])

    def k1_inputs(scene, atlas):
        fused, meta, ty, tx, win_list = pack_scene(scene)
        wins = tuple(torch.from_numpy(b).to(dev) for _, _, b in win_list)
        layer_data, sig = unpack_layers(torch.from_numpy(fused).to(dev),
                                        wins, meta, ty * tx)
        return (layer_data, font, atlas, background(scene), ty, tx, sig,
                scene.height, scene.width)

    def k2_inputs(scene, atlas, bg="scene"):
        blob, chrome_args, win_args, meta = F.pack_frame(scene, dev)
        blocks = F.build_blocks(torch.from_numpy(blob).to(dev), chrome_args,
                                win_args, meta)
        return (blocks, font, atlas,
                background(scene) if bg == "scene" else bg, meta[0],
                meta[1], scene.height, scene.width)

    def both(kernel, plain, args):
        k = kernel(*args)
        torch.cuda.synchronize()
        p = plain(*args)
        torch.cuda.synchronize()
        return k, p

    def compare(name, label, kind_s, k, p, shape, dtype):
        if tuple(k.shape) != shape or k.dtype != dtype \
                or k.device.type != "cuda":
            fail(f"{name} {label}: kernel output {tuple(k.shape)} "
                 f"{k.dtype} on {k.device}")
        mx, share = diff_stats(k, p)
        max_err[name] = max(max_err[name], mx)
        ok = within(kind_s, mx, share)
        log(f"{name} vs plain: {label}: max {mx:.4g} u8, >2 u8 on "
            f"{share:.6f} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fail(f"{name} disagrees with its plain version on {label}")

    # ---- 3. each kernel against its plain version ----------------------------
    for kind_s in KINDS:
        for seed in (0, 1):
            scene = synthetic_scene(kind_s, seed, renderer.regular, bold_v)
            atlas = torch.from_numpy(scene.image_atlas).to(dev)
            shape = (scene.height, scene.width, 4)
            label = f"{kind_s:8s} seed {seed} {scene.width}x{scene.height}"
            k, p = both(K.render_tiles, K.render_tiles_plain,
                        k1_inputs(scene, atlas))
            compare("K1", label, kind_s, k, p, shape, torch.uint8)
            k2, p2 = both(B.render_tiles_blocks,
                          B.render_tiles_blocks_plain,
                          k2_inputs(scene, atlas))
            compare("K2", label + " u8 frame", kind_s, k2, p2, shape,
                    torch.uint8)
            if not torch.equal(k, k2):
                fail(f"{label}: K2's frame differs from K1's")
            if kind_s == "empty":
                bg = torch.tensor([int(c * 255.0 + 0.5) for c in
                                   scene.background[:3]] + [255],
                                  dtype=torch.int32, device=dev)
                for out in (k, k2):
                    if int((out.int() - bg).abs().max().item()) > 1:
                        fail(f"{label}: not the background")
            k3, p3 = both(B.render_tiles_blocks,
                          B.render_tiles_blocks_plain,
                          k2_inputs(scene, atlas, bg=None))
            compare("K2", label + " f32 layer", kind_s, k3, p3, shape,
                    torch.float32)
            if kind_s != "empty" and not (
                    bool((k3[..., 3] == 0).any())
                    and bool((k3[..., 3] > 0).any())):
                fail(f"{label}: the f32 layer is not a transparent canvas "
                     "with ink on it")
    scene = synthetic_scene("windows2", 0, renderer.regular, bold_v)
    blocks = k2_inputs(scene, torch.from_numpy(scene.image_atlas).to(dev))[0]
    if [lo is None for _, _, lo, _ in blocks[0][0]] != \
            [False, True, False, True, False, True]:
        fail("windows2 did not cut its chrome shapes into three segments "
             "around two windows, with a volatile tail")

    # ---- 4. the slice end to end, both paths ---------------------------------
    repo = build_history_repo(work)
    # The dirty dot pulses with the clock; pinned, two passes over the same
    # offsets compile the same scenes and their frames can be held equal.
    freeze_pulse(1.0)
    app = open_app([repo])
    tab = app.current()
    if tab is None or len(tab.commits) < 200:
        fail("history fixture did not open")
    W, H = VIEWPORT
    offsets = SCROLL_OFFSETS + SWEEP
    image_atlas = renderer.image_atlas_device()

    def drive(path: str):
        """One pass over `offsets` through render_scene_device. → frames
        at the reference offsets, scenes at the compare offsets, the
        sweep's scenes, stage times, chrome entries after each frame, and
        both kernels' launch counts over the pass."""
        if path == "packed":
            os.environ["WGIT_FRAME_CACHE"] = "0"
        else:
            os.environ.pop("WGIT_FRAME_CACHE", None)
        F.clear_caches()
        frames, scenes, all_scenes, entries = {}, {}, [], []
        stage = {"compile": [], "enqueue": [], "sync": [], "total": []}
        K.render_tiles.launches = 0
        B.render_tiles_blocks.launches = 0
        for off in offsets:
            t0 = time.perf_counter()
            tab.history_scroll = float(off)
            scene = compile_frame(app, renderer, W, H)
            t1 = time.perf_counter()
            img = render_scene_device(scene, font, image_atlas)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for key, v in (("compile", t1 - t0), ("enqueue", t2 - t1),
                           ("sync", t3 - t2), ("total", t3 - t0)):
                stage[key].append(v * 1e3)
            if tuple(img.shape) != (H, W, 4) or img.dtype != torch.uint8 \
                    or img.device.type != "cuda":
                fail(f"{path} offset {off}: frame {tuple(img.shape)} "
                     f"{img.dtype} on {img.device}")
            if off in SCROLL_OFFSETS and off not in frames:
                frames[off] = img
                if off in COMPARE_OFFSETS:
                    scenes[off] = scene
            all_scenes.append(scene)
            entries.append(len(F._CHROME_CACHE))
        launches = (K.render_tiles.launches, B.render_tiles_blocks.launches)
        os.environ.pop("WGIT_FRAME_CACHE", None)
        return frames, scenes, all_scenes, stage, entries, launches

    packed = drive("packed")
    cached = drive("cache")
    n = len(offsets)
    log(f"slice: {n} frames at {W}x{H} a path; packed path launched (K1, "
        f"K2) {packed[5]}, frame cache {cached[5]}")
    if packed[5] != (n, 0):
        fail(f"packed path: (K1, K2) launches {packed[5]} for {n} frames")
    if cached[5] != (0, n):
        fail(f"frame cache: (K1, K2) launches {cached[5]} for {n} frames")
    for off in SCROLL_OFFSETS:
        if not torch.equal(cached[0][off], packed[0][off]):
            mx, _ = diff_stats(cached[0][off], packed[0][off])
            fail(f"offset {off}: the frame cache's frame (K2) differs from "
                 f"the packed path's (K1), max {mx} u8")
    log(f"slice: K2's frame torch.equal to K1's at offsets "
        f"{', '.join(str(o) for o in SCROLL_OFFSETS)}")
    if cached[4][0] == 0 or len(set(cached[4])) != 1:
        fail(f"chrome cache entries over the scroll: {cached[4]} (a pure "
             "scroll must add none after the first frame)")
    log(f"slice: chrome cache {cached[4][0]} entries after the first frame, "
        f"{cached[4][-1]} after the last of {n} (every later frame hit)")
    frames = cached[0]
    if not all(bool((f[..., 3] == 255).all()) for f in frames.values()):
        fail("history frame is not opaque")
    if torch.equal(frames[0.0], frames[128.5]):
        fail("scrolling did not change the frame")
    for off, scene in cached[1].items():
        for name, kernel, plain, args in (
                ("K1", K.render_tiles, K.render_tiles_plain,
                 k1_inputs(scene, image_atlas)),
                ("K2", B.render_tiles_blocks, B.render_tiles_blocks_plain,
                 k2_inputs(scene, image_atlas))):
            k, p = both(kernel, plain, args)
            if not torch.equal(k, frames[off]):
                fail(f"offset {off}: {name} is not deterministic")
            compare(name, f"history view at offset {off}", "history", k, p,
                    (H, W, 4), torch.uint8)
    slice_launches = {"K1": packed[5][0], "K2": cached[5][1]}

    # ---- 5. the CLI --------------------------------------------------------
    png = os.path.join(work, "shot.png")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "whisper_git_tpu_torch", "--screenshot", png,
         "--size", f"{W}x{H}", "--repo", repo],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"CLI exited {res.returncode}: {res.stderr[-2000:]}")
    with open(png, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR" \
            or struct.unpack(">II", head[16:24]) != (W, H):
        fail(f"CLI wrote no {W}x{H} PNG")
    log(f"cli: {W}x{H} PNG, {os.path.getsize(png)} bytes, "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 6. timings --------------------------------------------------------
    scene0 = cached[1][0.0]
    args1 = k1_inputs(scene0, image_atlas)
    args2 = k2_inputs(scene0, image_atlas)

    def event_ms(fn, runs: int) -> float:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    timed = (("K1 plain", lambda: K.render_tiles_plain(*args1),
              TIMED_PLAIN_RUNS),
             ("K1", lambda: K.render_tiles(*args1), TIMED_KERNEL_RUNS),
             ("K2 plain", lambda: B.render_tiles_blocks_plain(*args2),
              TIMED_PLAIN_RUNS),
             ("K2", lambda: B.render_tiles_blocks(*args2),
              TIMED_KERNEL_RUNS))
    ms = {name: [] for name, _, _ in timed}
    for _ in range(2):                       # in turns, twice round
        for name, fn, runs in timed:
            ms[name].append(event_ms(fn, runs))
    out1, out2 = K.render_tiles(*args1), B.render_tiles_blocks(*args2)
    bound1 = kernel_bound(torch, [
        (ci, tuple(layer[j] for j in F._CLS_TABLES[ci]), layer[7 + ci],
         None, None)
        for layer, sig in zip(args1[0], args1[6])
        for ci in B.Z_ORDER if sig[ci]], out1)
    bound2 = kernel_bound(torch, [
        (ci, *block) for cls_lists in args2[0] for ci in B.Z_ORDER
        for block in cls_lists[ci]], out2)
    log(f"timing [{card}]: history view {W}x{H} at offset 0; K1 walks "
        f"(shape, glyph, image) bin entries {bound1[2]['entries']} and "
        f"moves {bound1[2]['bytes']} B, K2 {bound2[2]['entries']} and "
        f"{bound2[2]['bytes']} B in "
        f"{sum(len(c) for cl in args2[0] for c in cl)} blocks")
    for name, bound in (("K1", bound1), ("K2", bound2)):
        log(f"timing [{card}]: {name} {ms[name][0]:.4f} / {ms[name][1]:.4f} "
            f"ms, plain {ms[name + ' plain'][0]:.4f} / "
            f"{ms[name + ' plain'][1]:.4f} ms (CUDA events, median of "
            f"{TIMED_KERNEL_RUNS} and {TIMED_PLAIN_RUNS}, in turns); bound "
            f"{bound[0]:.6f} ms by {bound[1]} (its busiest tile alone, "
            f"{bound[2]['busiest_share']:.4f} of the arithmetic, needs "
            f"{bound[2]['busiest_tile_ms']:.6f} ms of one SM); no PyTorch "
            "call computes this function")

    for path, run in (("packed path", packed), ("frame cache", cached)):
        steady = {k: v[1:] for k, v in run[3].items()}  # first: warm-up
        med = {k: statistics.median(v) for k, v in steady.items()}
        log(f"timing [{card}]: {path} end to end {med['total']:.3f} "
            f"ms/frame median over {len(steady['total'])} frames "
            f"(build+layout+compile {med['compile']:.3f}, host half + "
            f"device half + launch {med['enqueue']:.3f}, wait for device "
            f"{med['sync']:.3f}); first frame {run[3]['total'][0]:.1f} ms")

    # Where a steady frame's time goes: each stage on its own, host clock
    # to a synchronize, over the last frames of the sweep.
    def stages_alone(steps, scenes_):
        parts = {name: [] for name, _ in steps}
        for scene in scenes_:
            state = scene
            for name, fn in steps:
                t0 = time.perf_counter()
                state = fn(scene, state)
                torch.cuda.synchronize()
                parts[name].append((time.perf_counter() - t0) * 1e3)
        return ", ".join(f"{k} {statistics.median(v):.3f} ms"
                         for k, v in parts.items())

    def unpack_step(scene, packed_):
        fused, meta, ty, tx, win_list = packed_
        wins = tuple(P._device_window_blob(uid, caps, blob, dev)
                     for uid, caps, blob in win_list)
        return unpack_layers(torch.from_numpy(fused).to(dev), wins, meta,
                             ty * tx) + (ty, tx)

    log(f"timing [{card}]: packed path, stages alone, median of 20 sweep "
        "frames: " + stages_alone((
            ("pack_scene", lambda scene, _: pack_scene(scene)),
            ("upload+unpack", unpack_step),
            ("K1", lambda scene, st: K.render_tiles(
                st[0], font, image_atlas, background(scene), st[2], st[3],
                st[1], scene.height, scene.width))), packed[2][-20:]))
    log(f"timing [{card}]: frame cache, stages alone, median of 20 sweep "
        "frames: " + stages_alone((
            ("pack_frame", lambda scene, _: F.pack_frame(scene, dev)),
            ("upload+build_blocks", lambda scene, st: (F.build_blocks(
                torch.from_numpy(st[0]).to(dev), st[1], st[2], st[3]),
                st[3])),
            ("K2", lambda scene, st: B.render_tiles_blocks(
                st[0], font, image_atlas, background(scene), st[1][0],
                st[1][1], scene.height, scene.width))), cached[2][-20:]))
    last = cached[2][-1]
    n_blocks = sum(len(c) for cl in k2_inputs(last, image_atlas)[0]
                   for c in cl)
    log(f"timing [{card}]: frame cache upload per steady frame: frame blob "
        f"{F.pack_frame(last, dev)[0].nbytes} B + {n_blocks} block "
        f"descriptors {n_blocks * B._BLOCK_DESC.itemsize} B; the packed "
        f"path's blob {pack_scene(last)[0].nbytes} B")

    # Device busy share over 20 end-to-end frames (torch.profiler), the
    # default path.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for off in SWEEP[:20]:
            tab.history_scroll = float(off)
            render_scene_device(compile_frame(app, renderer, W, H), font,
                                image_atlas)
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)]
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in dev_events)
    if dev_us > 0:
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:5]
        log(f"profile [{card}]: frame cache, 20 frames, device busy "
            f"{dev_us / wall_us:.4f} of {wall_us / 1e3:.2f} ms wall, "
            f"{sum(e.count for e in dev_events)} device events; top "
            "kernels (us total): "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f}"
                        f" x{e.count}" for e in top))
    else:
        log(f"profile [{card}]: no device time in the trace (not measured)")

    def row(name, stem, line, bound):
        return {"name": stem, "route": "cuda",
                "source": f"whisper_git_tpu_torch/csrc/{stem}.cu",
                "replaces": f"whisper_git_tpu/render/pallas_raster.py:{line}",
                "launches": slice_launches[name],
                "max_abs_err": max_err[name],
                "ms": round(min(ms[name]), 6),
                "plain_ms": round(min(ms[name + " plain"]), 6),
                "bound_ms": round(bound[0], 6), "bound_by": bound[1],
                "library_ms": None}

    return [row("K1", "raster_tiles", 321, bound1),
            row("K2", "raster_blocks", 505, bound2)]


if __name__ == "__main__":
    sys.exit(main())
