#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. JAX, Pillow and matplotlib are not needed (and
must not be imported). Phases, each fatal on failure:

  1. device   CUDA present; the card's name and power limit (nvidia-smi)
  2. build    the tile kernel K1 from whisper_git_tpu_torch/csrc (timed)
  3. kernel   K1 against its plain PyTorch version on the card, on seeded
              synthetic scenes of every kind (tools/synthetic.py)
  4. slice    the history view of a generated repository at 1280x800
              through the port's renderer at the reference's scroll
              offsets and a 0-400 px sweep: frame shape, K1's launch
              count equal to the frames rendered, K1 against the plain
              version on a few offsets
  5. cli      `python -m whisper_git_tpu_torch --screenshot` writes a
              1280x800 PNG
  6. timings  K1 and the plain version at the history view (CUDA events,
              median), the end-to-end frame time (host clock to a
              synchronize, median), each stage of a frame alone, and the
              device's busy share over 20 frames (torch.profiler)

Tolerances (the reference's own): shape-only scenes within 1 u8; scenes
with glyphs or images at most 8 u8 with more than 2 u8 on under 1 % of
values; the empty scene within 1 u8 of the background.

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


def diff_stats(a, b) -> tuple[int, float]:
    """(max |a − b| in u8, share of values differing by more than 2)."""
    d = (a.int() - b.int()).abs()
    return int(d.max().item()) if d.numel() else 0, \
        float((d > 2).float().mean().item()) if d.numel() else 0.0


def within(kind: str, mx: int, share: float) -> bool:
    if kind in ("shapes", "empty"):
        return mx <= 1
    return mx <= 8 and share < 0.01


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
    for var in ("JAX_PLATFORMS", "WGIT_DEVICE"):
        os.environ.pop(var, None)
    try:
        kernels = run_phases(torch, card, kind, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for mod in ("jax", "jaxlib", "PIL", "matplotlib"):
        if mod in sys.modules:
            fail(f"{mod} was imported")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(torch, card: str, kind: str, work: str) -> list:
    from whisper_git_tpu_torch.host.main import open_app
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render import rasterizer as P
    from whisper_git_tpu_torch.render.rasterizer import (
        pack_scene, render_scene_device, unpack_layers)
    from whisper_git_tpu_torch.render.renderer import Renderer
    from whisper_git_tpu_torch.tools.synthetic import KINDS, synthetic_scene

    dev = torch.device("cuda")
    max_err = 0

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    info = K.build()
    build_s = time.perf_counter() - t0
    log(f"build: {os.path.relpath(info['path'], ROOT)} compiled="
        f"{info['built']} nvcc {info['seconds']:.2f} s, build+load "
        f"{build_s:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"ptxas: {line.strip()}")

    renderer = Renderer(dev)
    bold_v = renderer.regular.texture.shape[0]
    font = renderer.font_tex_device()

    def device_inputs(scene, atlas):
        fused, meta, ty, tx, win_list = pack_scene(scene)
        wins = tuple(torch.from_numpy(b).to(dev) for _, _, b in win_list)
        layer_data, sig = unpack_layers(torch.from_numpy(fused).to(dev),
                                        wins, meta, ty * tx)
        bg = tuple(float(c) for c in scene.background[:3])
        return (layer_data, font, atlas, bg, ty, tx, sig, scene.height,
                scene.width)

    def both(args):
        k = K.render_tiles(*args)
        torch.cuda.synchronize()
        p = K.render_tiles_plain(*args)
        torch.cuda.synchronize()
        return k, p

    # ---- 3. kernel against its plain version --------------------------------
    for kind_s in KINDS:
        for seed in (0, 1):
            scene = synthetic_scene(kind_s, seed, renderer.regular, bold_v)
            atlas = torch.from_numpy(scene.image_atlas).to(dev)
            args = device_inputs(scene, atlas)
            k, p = both(args)
            if k.shape != (scene.height, scene.width, 4) or k.dtype != \
                    torch.uint8 or k.device.type != "cuda":
                fail(f"{kind_s}/{seed}: kernel output {tuple(k.shape)} "
                     f"{k.dtype} on {k.device}")
            mx, share = diff_stats(k, p)
            if kind_s == "empty":
                bg = torch.tensor([int(c * 255.0 + 0.5) for c in
                                   scene.background[:3]] + [255],
                                  dtype=torch.int32, device=dev)
                mx = max(mx, int((k.int() - bg).abs().max().item()))
            max_err = max(max_err, mx)
            ok = within(kind_s, mx, share)
            log(f"kernel vs plain: {kind_s:6s} seed {seed} "
                f"{scene.width}x{scene.height}: max {mx} u8, >2 u8 on "
                f"{share:.6f} {'ok' if ok else 'OUT OF TOLERANCE'}")
            if not ok:
                fail(f"K1 disagrees with the plain version on {kind_s}/{seed}")

    # ---- 4. the slice end to end -------------------------------------------
    repo = build_history_repo(work)
    app = open_app([repo])
    tab = app.current()
    if tab is None or len(tab.commits) < 200:
        fail("history fixture did not open")
    W, H = VIEWPORT
    offsets = SCROLL_OFFSETS + SWEEP
    scenes = {}
    stage_ms = {"compile": [], "enqueue": [], "sync": [], "total": []}
    frames = {}
    sweep_scenes = []
    K.render_tiles.launches = 0
    for off in offsets:
        t0 = time.perf_counter()
        tab.history_scroll = float(off)
        scene = compile_frame(app, renderer, W, H)
        t1 = time.perf_counter()
        img = render_scene_device(scene, font, renderer.image_atlas_device())
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, v in (("compile", t1 - t0), ("enqueue", t2 - t1),
                       ("sync", t3 - t2), ("total", t3 - t0)):
            stage_ms[key].append(v * 1e3)
        if tuple(img.shape) != (H, W, 4) or img.dtype != torch.uint8 \
                or img.device.type != "cuda":
            fail(f"offset {off}: frame {tuple(img.shape)} {img.dtype} "
                 f"on {img.device}")
        if off in COMPARE_OFFSETS and off not in scenes:
            scenes[off] = scene
            frames[off] = img
        sweep_scenes.append(scene)
    launches = K.render_tiles.launches
    log(f"slice: {len(offsets)} frames at {W}x{H}, K1 launches {launches}")
    if launches != len(offsets):
        fail(f"K1 launched {launches} times for {len(offsets)} frames")
    if not all(bool((f[..., 3] == 255).all()) for f in frames.values()):
        fail("history frame is not opaque")
    if torch.equal(frames[0.0], frames[128.5]):
        fail("scrolling did not change the frame")
    image_atlas = renderer.image_atlas_device()
    for off, scene in scenes.items():
        k, p = both(device_inputs(scene, image_atlas))
        if not torch.equal(k, frames[off]):
            fail(f"offset {off}: K1 is not deterministic")
        mx, share = diff_stats(k, p)
        max_err = max(max_err, mx)
        ok = within("history", mx, share)
        log(f"slice vs plain at offset {off}: max {mx} u8, >2 u8 on "
            f"{share:.6f} {'ok' if ok else 'OUT OF TOLERANCE'}")
        if not ok:
            fail(f"K1 disagrees with the plain version at offset {off}")

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
    args = device_inputs(scenes[0.0], image_atlas)

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

    plain_ms = event_ms(lambda: K.render_tiles_plain(*args), TIMED_PLAIN_RUNS)
    k_ms = event_ms(lambda: K.render_tiles(*args), TIMED_KERNEL_RUNS)
    plain_ms2 = event_ms(lambda: K.render_tiles_plain(*args),
                         TIMED_PLAIN_RUNS)
    k_ms2 = event_ms(lambda: K.render_tiles(*args), TIMED_KERNEL_RUNS)
    sig = args[6]
    occ = [tuple(int((t >= 0).sum().item()) for t in layer[7:10])
           for layer in args[0]]
    log(f"timing [{card}]: history view {W}x{H} at offset 0, "
        f"(shape, glyph, image) bin entries per layer {occ}, sig {sig}")
    log(f"timing [{card}]: K1 {k_ms:.4f} / {k_ms2:.4f} ms, plain "
        f"{plain_ms:.4f} / {plain_ms2:.4f} ms (CUDA events, median of "
        f"{TIMED_KERNEL_RUNS} and {TIMED_PLAIN_RUNS}; plain, K1, plain, K1)")
    steady = {k: v[1:] for k, v in stage_ms.items()}  # first frame: warm-up
    med = {k: statistics.median(v) for k, v in steady.items()}
    log(f"timing [{card}]: end to end {med['total']:.3f} ms/frame median "
        f"over {len(steady['total'])} frames (build+layout+compile "
        f"{med['compile']:.3f}, pack+H2D+unpack+launch "
        f"{med['enqueue']:.3f}, wait for device {med['sync']:.3f}); first "
        f"frame {stage_ms['total'][0]:.1f} ms")
    # Where a steady frame's time goes: each stage on its own, host clock
    # to a synchronize, over the last frames of the sweep.
    parts = {"pack": [], "upload+unpack": [], "K1": []}
    for scene in sweep_scenes[-20:]:
        t0 = time.perf_counter()
        fused, meta, ty, tx, win_list = pack_scene(scene)
        t1 = time.perf_counter()
        wins = tuple(P._device_window_blob(uid, caps, blob, font.device)
                     for uid, caps, blob in win_list)
        layer_data, sig = unpack_layers(torch.from_numpy(fused).to(dev),
                                        wins, meta, ty * tx)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        K.render_tiles(layer_data, font, image_atlas,
                       tuple(float(c) for c in scene.background[:3]), ty, tx,
                       sig, scene.height, scene.width)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, v in (("pack", t1 - t0), ("upload+unpack", t2 - t1),
                       ("K1", t3 - t2)):
            parts[key].append(v * 1e3)
    log(f"timing [{card}]: stages alone, median of 20 sweep frames: "
        + ", ".join(f"{k} {statistics.median(v):.3f} ms"
                    for k, v in parts.items()))

    # Device busy share over 20 end-to-end frames (torch.profiler).
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
        log(f"profile [{card}]: 20 frames, device busy "
            f"{dev_us / wall_us:.4f} of {wall_us / 1e3:.2f} ms wall; "
            "top kernels (us total): "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f}"
                        f" x{e.count}" for e in top))
    else:
        log(f"profile [{card}]: no device time in the trace (not measured)")

    return [{"name": "raster_tiles", "route": "cuda",
             "source": "whisper_git_tpu_torch/csrc/raster_tiles.cu",
             "replaces": "whisper_git_tpu/render/pallas_raster.py:321",
             "launches": launches, "max_abs_err": max_err,
             "ms": round(min(k_ms, k_ms2), 6),
             "plain_ms": round(min(plain_ms, plain_ms2), 6)}]


if __name__ == "__main__":
    sys.exit(main())
