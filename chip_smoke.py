#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA. JAX, Pillow, matplotlib and the JAX package
(`whisper_git_tpu`) are not needed, and must not be imported. Phases,
each fatal on failure:

  1. device   CUDA present; the card's name and power limit (nvidia-smi)
  2. build    the tile kernel K1, the blocks kernel K2 and the compose
              kernel K3 from whisper_git_tpu_torch/csrc, one nvcc each,
              started together (timed; ptxas' registers and spills logged)
  3. kernel   K1 and K2 each against its plain PyTorch version on the
              card, on seeded synthetic scenes of every kind
              (tools/synthetic.py: window scenes give window blocks, one
              has a volatile tail, one cuts chrome into three segments);
              K2 in both output modes (u8 frame, f32 transparent layer);
              K3 against its plain version on seeded op lists that hold
              every op kind (a layer rect off the origin ending on the
              ragged last tile row, slabs started on and off a tile
              boundary and at slab_h - height, y clips that cut tiles, an
              inline and a pre-rendered tail at tile columns >= 1, no op
              at all, no slab); a synthetic scene with a glyph tail through
              compose (K2 pre-renders the tail for K3) within 1 u8 of K1's
              frame
  4. slice    the history view of a generated repository at 1280x800
              through `render_scene_device`: at the reference's scroll
              offsets and a 0-400 px sweep through the packed path
              (WGIT_FRAME_CACHE=0, K1) and through the frame cache
              (WGIT_FRAME_COMPOSE=0, K2), and at integer offsets (compose
              declines a fractional one) through compose, the default
              (K3, with K2 for the layers it caches). Frame shape; each
              kernel's launch count equal to its path's frames and
              untouched by the other paths; the packed and frame-cache
              frames equal bit for bit; the chrome cache hit on every
              frame after the first; one K3 launch a composed frame, K2
              launched only for a new chrome group, a new slab or a
              pre-rendered tail and never on a plan hit, K1 never; a
              fractional offset under the default equal to the frame
              cache's frame with no K3 launch; composed frames within 1 u8
              of the packed path's, under 2 % of values differing; the
              layer caches untouched between two offsets of one scroll
              bucket; each kernel against its plain version on a few
              offsets
  5. cli      `python -m whisper_git_tpu_torch --screenshot` writes a
              1280x800 PNG (through compose)
  6. timings  each kernel and its plain version at the history view (CUDA
              events, median, taken in turns) beside its bound; the three
              paths' end-to-end frame time over the same integer offsets
              (host clock to a synchronize, median; first and plan-rebuild
              frames apart) and each stage of a frame alone; each path's
              upload per frame; device events a frame and the device's
              busy share over 20 frames of compose and of the frame cache
              (torch.profiler)

Tolerances (the reference's own): shape-only scenes within 1 u8; scenes
with glyphs or images at most 8 u8 with more than 2 u8 on under 1 % of
values; the empty scene within 1 u8 of the background; an f32 layer the
same in units of 1/255; the compose kernel within 1 u8 of its plain
version (0 expected: the same f32 arithmetic, no multiply-add contracted).

A kernel's bound is the larger of two times: the bytes it must move (its
command tables, bins and bounds, the atlas cells its bins reference and
the frame it writes, each once) over 3.35 TB/s, and the arithmetic of
this run's bin entries (entries x 8192 pixels x operations per pixel of
the entry's class) over 67 TFLOP/s, the H100's f32 rate outside the
tensor cores. The compose kernel's bytes are the frame written, 8 B a pixel
of every chrome layer and of every slab's visible rows, 16 B a pixel of a
pre-rendered tail, the inline tails' tables and bins, the starts and the
descriptors; its arithmetic 11 operations a pixel a blended i16 layer, 7
an f32 one, and the inline tails' bin entries as above.

Prints the card's line, a JSON line of kernel results, and last
{"ok": true, "device": {...}}. Exits non-zero, printing no result, on any
failure.
"""

from __future__ import annotations

import dataclasses
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
# Compose takes integer offsets only: the reference's integer offsets, then
# the bench's own scroll pattern (bench.py: (i * 17) % 400).
COMPOSE_OFFSETS = (0.0, 13.0, 17.0, 64.0) + tuple(
    float((i * 17) % 400) for i in range(1, 54))
COMPOSE_COMPARE = (0.0, 13.0, 17.0, 64.0, 119.0, 238.0, 391.0)
COMPOSE_PLAIN_OFFSETS = (0.0, 64.0, 238.0)
COMPOSE_SYNTH_SIZE = (640, 400)   # 5 x 7 tiles, the last tile row ragged
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


BLEND_FLOPS_I16 = 11   # 4 scales, 1 - a, three multiply-adds
BLEND_FLOPS_F32 = 7


def compose_bound(torch, starts, images, slabs, dyns, ops, out,
                  desc_bytes: int) -> tuple[float, str, dict]:
    """The least time the card could take for one compose launch on these
    inputs. → (bound ms, "bytes" | "operations", {"bytes", "layer_px":
    pixels blended from chrome layers, slab rows inside their y clip and
    pre-rendered tails, "entries": inline shape bin entries})."""
    height, width = out.shape[0], out.shape[1]
    n_bytes = (out.numel() + starts.numel() * starts.element_size()
               + desc_bytes)
    px_i16 = px_f32 = entries = 0
    ys = torch.arange(height, dtype=torch.float32) + 0.5
    for op in ops:
        if op[0] == "img":
            t = images[op[1]]
            px_i16 += t.shape[0] * t.shape[1]
        elif op[0] == "slab":
            slab, start = slabs[op[1]], int(starts[op[1]].item())
            sy = ys - 0.5 + start
            rows = ((ys >= op[2][1]) & (ys <= op[2][3]) & (sy >= 0)
                    & (sy < slab.shape[0]))
            px_i16 += int(rows.sum().item()) * min(slab.shape[1], width)
        elif op[0] == "dyni":
            tables = dyns.get((op[1], op[2]))
            if tables is None:
                continue
            _, _, bins, counts = tables
            n_bytes += sum(t.numel() * t.element_size() for t in tables)
            k = torch.arange(bins.shape[1], device=bins.device)[None, :]
            entries += int(((bins >= 0) & (k < counts[:, None])).sum().item())
        else:
            t = dyns.get((op[1], op[2]))
            if t is not None:
                px_f32 += t.shape[0] * t.shape[1]
    n_bytes += 8 * px_i16 + 16 * px_f32
    flops = (BLEND_FLOPS_I16 * px_i16 + BLEND_FLOPS_F32 * px_f32
             + entries * TILE_PIXELS * FLOPS_PER_PIXEL[0])
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", {"bytes": n_bytes, "layer_px": px_i16 + px_f32,
                           "entries": entries})


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
    for var in ("JAX_PLATFORMS", "WGIT_DEVICE", "WGIT_FRAME_CACHE",
                "WGIT_FRAME_COMPOSE"):
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
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render import rasterizer as P
    from whisper_git_tpu_torch.render.rasterizer import (
        pack_scene, render_scene_device, unpack_layers)
    from whisper_git_tpu_torch.render.renderer import Renderer
    from whisper_git_tpu_torch.tools.synthetic import (
        COMPOSE_CASES, KINDS, compose_args_to, synthetic_compose,
        synthetic_scene)

    dev = torch.device("cuda")
    max_err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:   # one nvcc each, side by side
        infos = [f.result() for f in (pool.submit(K.build),
                                      pool.submit(B.build),
                                      pool.submit(CK.build))]
    build_s = time.perf_counter() - t0
    for name, info in zip(("K1", "K2", "K3"), infos):
        log(f"build: {name} {os.path.relpath(info['path'], ROOT)} compiled="
            f"{info['built']} nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: three kernels built and loaded in {build_s:.2f} s")

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

    # K3 against its plain version on seeded op lists of every op kind.
    def k3_both(pos, kw):
        return both(lambda *a: CK.compose_tiles(*a, **kw),
                    lambda *a: CK.compose_tiles_plain(*a, **kw), pos)

    def compare_k3(label, k, p, shape):
        above = int((k.int() - p.int()).abs().gt(0).sum().item()) \
            if k.shape == p.shape else -1
        compare("K3", f"{label} ({above} values above 0)", "shapes", k, p,
                shape, torch.uint8)
        if not bool((k[..., 3] == 255).all()):
            fail(f"K3 {label}: the frame is not opaque")

    cw, ch = COMPOSE_SYNTH_SIZE
    kinds_seen = set()
    for case in COMPOSE_CASES:
        for seed in (0, 1):
            a = compose_args_to(synthetic_compose(case, seed, cw, ch), dev)
            pos = tuple(a.pop(k) for k in ("starts", "images", "slabs",
                                           "dyns"))
            kinds_seen |= {op[0] for op in a["ops"]}
            k, p = k3_both(pos, a)
            compare_k3(f"{case:10s} seed {seed} {cw}x{ch}, "
                       f"{len(a['ops'])} ops", k, p, (ch, cw, 4))
            if case == "empty":
                bg = torch.tensor([int(c * 255.0 + 0.5) for c in
                                   a["background"][:3]] + [255],
                                  dtype=torch.int32, device=dev)
                if not bool((k.int() == bg).all()):
                    fail("K3 with no op: not the background")
    if kinds_seen != {"img", "slab", "dyni", "dyn"}:
        fail(f"the compose cases hold only the op kinds {kinds_seen}")
    # A scene whose volatile tail holds glyphs, through compose itself: K2
    # pre-renders that tail over its sub-grid of tile columns for K3.
    scene = synthetic_scene("volatile", 0, renderer.regular, bold_v)
    scene.windows = [dataclasses.replace(w, dy=float(int(w.dy)))
                     for w in scene.windows]
    atlas = torch.from_numpy(scene.image_atlas).to(dev)
    args, st = C.prepare_compose_dispatch(scene, font, atlas)
    kops = C.frame_tails(args[0], font, atlas, st["height"], st["width"],
                         st["tiles_y"], st["tiles_x"], st["meta"])[2]
    if not {"dyn", "dyni", "slab", "img"} <= {op[0] for op in kops}:
        fail(f"the volatile scene composes only {[op[0] for op in kops]}")
    got = C.render_frame_composed(scene, font, atlas)
    want = K.render_tiles(*k1_inputs(scene, atlas))
    mx, _ = diff_stats(got, want)
    log(f"compose vs packed: volatile scene with a pre-rendered glyph tail "
        f"({', '.join(op[0] for op in kops)}): max {mx:g} u8")
    if mx > 1:
        fail("the composed volatile scene is more than 1 u8 from the packed "
             "path's")
    C.clear_caches()

    # ---- 4. the slice end to end, three paths --------------------------------
    repo = build_history_repo(work)
    # The dirty dot pulses with the clock; pinned, two passes over the same
    # offsets compile the same scenes and their frames can be held equal.
    freeze_pulse(1.0)
    # The tails' bucket high-water marks are process state: the synthetic
    # scenes above left glyph and image tails behind, which every later
    # frame would carry empty (and compose would pre-render, one K2 launch
    # a frame). A fresh process on this view starts without them.
    F._DYN_HW.clear()
    F._WR_HW.clear()
    app = open_app([repo])
    tab = app.current()
    if tab is None or len(tab.commits) < 200:
        fail("history fixture did not open")
    W, H = VIEWPORT
    offsets = SCROLL_OFFSETS + SWEEP
    image_atlas = renderer.image_atlas_device()
    path_env = {"packed": {"WGIT_FRAME_CACHE": "0"},
                "cache": {"WGIT_FRAME_COMPOSE": "0"},
                "compose": {}}

    def take_path(path: str):
        for var in ("WGIT_FRAME_CACHE", "WGIT_FRAME_COMPOSE"):
            os.environ.pop(var, None)
        os.environ.update(path_env[path])

    def counts():
        return (K.render_tiles.launches, B.render_tiles_blocks.launches,
                CK.compose_tiles.launches)

    def layer_caches():
        return ({k: v[0].data_ptr() for k, v in C._GROUP_CACHE.items()},
                {k: (v["y0s"], v["img"].data_ptr())
                 for k, v in C._SLAB_CACHE.items()})

    def rendered(before: dict, after: dict) -> int:
        return sum(1 for k, v in after.items() if before.get(k) != v)

    def compile_at(off: float):
        tab.history_scroll = float(off)
        return compile_frame(app, renderer, W, H)

    def drive(path: str, offs, keep_frames=(), keep_scenes=()):
        """One pass over `offs` through render_scene_device from empty
        caches. → frames and scenes at the offsets asked for, every scene,
        stage times, chrome entries after each frame, the three kernels'
        launch counts over the pass, and a row a frame: (K1, K2, K3
        launches, plans built, chrome groups rendered, slabs rendered,
        glyph and image tails the frame carries)."""
        take_path(path)
        F.clear_caches()
        C.clear_caches()
        frames, scenes, all_scenes, entries, rows = {}, {}, [], [], []
        stage = {"compile": [], "enqueue": [], "sync": [], "total": []}
        plans = {}   # id -> plan, held so that no id comes twice
        K.render_tiles.launches = 0
        B.render_tiles_blocks.launches = 0
        CK.compose_tiles.launches = 0
        for off in offs:
            n0, caches0 = counts(), layer_caches()
            t0 = time.perf_counter()
            scene = compile_at(off)
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
            if off in keep_frames and off not in frames:
                frames[off] = img
            if off in keep_scenes and off not in scenes:
                scenes[off] = scene
            all_scenes.append(scene)
            entries.append(len(F._CHROME_CACHE))
            built = [p for p in C._PLAN_CACHE.values() if id(p) not in plans]
            plans.update((id(p), p) for p in built)
            caches1 = layer_caches()
            rows.append(tuple(b - a for a, b in zip(n0, counts()))
                        + (len(built), rendered(caches0[0], caches1[0]),
                           rendered(caches0[1], caches1[1]),
                           sum(1 for li in range(len(scene.layers))
                               for ci in (1, 2) if F._DYN_HW.get((li, ci)))))
        take_path("compose")
        return {"frames": frames, "scenes": scenes, "all_scenes": all_scenes,
                "stage": stage, "entries": entries, "launches": counts(),
                "rows": rows}

    packed = drive("packed", offsets)
    cached = drive("cache", offsets, SCROLL_OFFSETS, SCROLL_OFFSETS)
    n = len(offsets)
    log(f"slice: {n} frames at {W}x{H} a path; packed path launched (K1, "
        f"K2, K3) {packed['launches']}, frame cache {cached['launches']}")
    if packed["launches"] != (n, 0, 0):
        fail(f"packed path: (K1, K2, K3) launches {packed['launches']} for "
             f"{n} frames")
    if cached["launches"] != (0, n, 0):
        fail(f"frame cache: (K1, K2, K3) launches {cached['launches']} for "
             f"{n} frames")
    # Held against the packed path's frame of the same compiled scene: the
    # app's background refreshes may change a scene between two passes.
    take_path("packed")
    for off in SCROLL_OFFSETS:
        want = render_scene_device(cached["scenes"][off], font, image_atlas)
        if not torch.equal(cached["frames"][off], want):
            mx, _ = diff_stats(cached["frames"][off], want)
            fail(f"offset {off}: the frame cache's frame (K2) differs from "
                 f"the packed path's (K1), max {mx} u8")
    take_path("compose")
    log(f"slice: K2's frame torch.equal to K1's at offsets "
        f"{', '.join(str(o) for o in SCROLL_OFFSETS)}")
    if cached["entries"][0] == 0 or len(set(cached["entries"])) != 1:
        fail(f"chrome cache entries over the scroll: {cached['entries']} (a "
             "pure scroll must add none after the first frame)")
    log(f"slice: chrome cache {cached['entries'][0]} entries after the first "
        f"frame, {cached['entries'][-1]} after the last of {n} (every later "
        "frame hit)")
    frames = cached["frames"]
    if not all(bool((f[..., 3] == 255).all()) for f in frames.values()):
        fail("history frame is not opaque")
    if torch.equal(frames[0.0], frames[128.5]):
        fail("scrolling did not change the frame")
    for off in COMPARE_OFFSETS:
        scene = cached["scenes"][off]
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

    # Compose, the default: integer offsets, in turns with the other two
    # paths over the same offsets (their frames are the yardstick, their
    # times stand beside compose's). The first compose pass is the counted
    # one.
    rounds = []
    for _ in range(2):
        rounds.append({path: drive(path, COMPOSE_OFFSETS, COMPOSE_COMPARE,
                                   COMPOSE_COMPARE)
                       for path in ("packed", "cache", "compose")})
    composed = rounds[0]["compose"]
    n_c = len(COMPOSE_OFFSETS)
    builds = [(off, r) for off, r in zip(COMPOSE_OFFSETS, composed["rows"])
              if r[3]]
    hits = n_c - len(builds)
    for off, (k1, k2, k3, built, groups, slabs, tails) in zip(
            COMPOSE_OFFSETS, composed["rows"]):
        if k1 != 0 or k3 != 1:
            fail(f"compose offset {off}: {k3} K3 and {k1} K1 launches in one "
                 "composed frame")
        if k2 != groups + slabs + tails:
            fail(f"compose offset {off}: {k2} K2 launches for {groups} new "
                 f"chrome groups, {slabs} new slabs and {tails} pre-rendered "
                 "tails")
        if not built and (k2 or groups or slabs):
            fail(f"compose offset {off}: a plan hit launched K2 {k2} times "
                 f"and rendered {groups} groups and {slabs} slabs")
    if composed["rows"][0][3] != 1 or hits < n_c // 2:
        fail(f"compose: {len(builds)} plan builds over {n_c} frames")
    log(f"slice: compose, {n_c} frames at integer offsets: (K1, K2, K3) "
        f"launches {composed['launches']}; one K3 launch a frame; "
        f"{len(builds)} plan builds, {hits} plan hits with no K2 launch and "
        "the layer caches untouched; K2 launches a build (offset: groups + "
        "slabs): " + ", ".join(f"{off:g}: {r[4]} + {r[5]}"
                               for off, r in builds))
    for path in ("packed", "cache"):
        want = {"packed": (n_c, 0, 0), "cache": (0, n_c, 0)}[path]
        if rounds[0][path]["launches"] != want:
            fail(f"{path} over the integer offsets: launches "
                 f"{rounds[0][path]['launches']}")
    # Each composed frame against the packed path's frame of the same
    # compiled scene.
    worst, share = 0.0, 0.0
    take_path("packed")
    for rnd in rounds:
        for off in COMPOSE_COMPARE:
            got = rnd["compose"]["frames"][off]
            want = render_scene_device(rnd["compose"]["scenes"][off], font,
                                       image_atlas)
            d = (got.int() - want.int()).abs()
            mx, differing = int(d.max().item()), float(d.gt(0).float().mean())
            worst, share = max(worst, mx), max(share, differing)
            if mx > 1 or differing >= 0.02 \
                    or not bool((got[..., 3] == 255).all()):
                fail(f"offset {off}: composed frame max {mx} u8 from the "
                     f"packed path's, {differing:.4%} of values differing")
    take_path("compose")
    log(f"slice: composed frames within {worst:g} u8 of the packed path's at "
        f"offsets {', '.join(f'{o:g}' for o in COMPOSE_COMPARE)}; at most "
        f"{share:.4%} of values differ")
    if torch.equal(composed["frames"][0.0], composed["frames"][238.0]):
        fail("scrolling did not change the composed frame")

    # A fractional offset under the default: compose declines, the frame is
    # the frame cache's.
    scene = compile_at(63.9)
    n0 = counts()
    img = render_scene_device(scene, font, image_atlas)
    torch.cuda.synchronize()
    delta = tuple(b - a for a, b in zip(n0, counts()))
    if delta != (0, 1, 0):
        fail(f"fractional offset under the default: (K1, K2, K3) launches "
             f"{delta}")
    take_path("cache")
    want = render_scene_device(scene, font, image_atlas)
    take_path("compose")
    if not torch.equal(img, want):
        fail("fractional offset under the default: not the frame cache's "
             "frame")
    log("slice: offset 63.9 under the default: compose declined, the frame "
        "is torch.equal to the frame cache's, no K3 launch")

    def k3_inputs(scene):
        """→ (starts, images, slabs, dyns), keywords, blob bytes."""
        args, st = C.prepare_compose_dispatch(scene, font, image_atlas)
        starts, dyns, kops = C.frame_tails(
            args[0], font, image_atlas, st["height"], st["width"],
            st["tiles_y"], st["tiles_x"], st["meta"])
        kw = dict(ops=kops, tiles_y=st["tiles_y"], tiles_x=st["tiles_x"],
                  background=st["background"], height=st["height"],
                  width=st["width"])
        return ((starts, tuple(args[1]), tuple(args[2]), dyns), kw,
                args[0].numel() * args[0].element_size())

    for off in COMPOSE_PLAIN_OFFSETS:
        scene = composed["scenes"][off]
        pos, kw, _ = k3_inputs(scene)
        k, p = k3_both(pos, kw)
        if off in composed["frames"] \
                and not torch.equal(k, composed["frames"][off]):
            fail(f"offset {off}: K3 is not deterministic")
        compare_k3(f"history view at offset {off:g}, {len(kw['ops'])} ops "
                   f"({', '.join(op[0] for op in kw['ops'])})", k, p,
                   (H, W, 4))
    slice_launches = {"K1": packed["launches"][0],
                      "K2": cached["launches"][1],
                      "K3": composed["launches"][2]}

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
    scene0 = cached["scenes"][0.0]
    args1 = k1_inputs(scene0, image_atlas)
    args2 = k2_inputs(scene0, image_atlas)
    pos3, kw3, blob_bytes = k3_inputs(composed["scenes"][0.0])

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
              TIMED_KERNEL_RUNS),
             ("K3 plain", lambda: CK.compose_tiles_plain(*pos3, **kw3),
              TIMED_PLAIN_RUNS),
             ("K3", lambda: CK.compose_tiles(*pos3, **kw3),
              TIMED_KERNEL_RUNS))
    ms = {name: [] for name, _, _ in timed}
    for _ in range(2):                       # in turns, twice round
        for name, fn, runs in timed:
            ms[name].append(event_ms(fn, runs))
    out1, out2 = K.render_tiles(*args1), B.render_tiles_blocks(*args2)
    out3 = CK.compose_tiles(*pos3, **kw3)
    bound1 = kernel_bound(torch, [
        (ci, tuple(layer[j] for j in F._CLS_TABLES[ci]), layer[7 + ci],
         None, None)
        for layer, sig in zip(args1[0], args1[6])
        for ci in B.Z_ORDER if sig[ci]], out1)
    bound2 = kernel_bound(torch, [
        (ci, *block) for cls_lists in args2[0] for ci in B.Z_ORDER
        for block in cls_lists[ci]], out2)
    desc3 = CK.op_descriptors(pos3[1], pos3[2], pos3[3], kw3["ops"],
                              kw3["tiles_y"], pos3[0].device)[0]
    bound3 = compose_bound(torch, *pos3, kw3["ops"], out3, desc3.nbytes)
    log(f"timing [{card}]: history view {W}x{H} at offset 0; K1 walks "
        f"(shape, glyph, image) bin entries {bound1[2]['entries']} and "
        f"moves {bound1[2]['bytes']} B, K2 {bound2[2]['entries']} and "
        f"{bound2[2]['bytes']} B in "
        f"{sum(len(c) for cl in args2[0] for c in cl)} blocks; K3 blends "
        f"{len(kw3['ops'])} ops ({', '.join(op[0] for op in kw3['ops'])}), "
        f"{bound3[2]['layer_px']} layer pixels and {bound3[2]['entries']} "
        f"inline shape entries, and moves {bound3[2]['bytes']} B")
    for name, bound in (("K1", bound1), ("K2", bound2)):
        log(f"timing [{card}]: {name} {ms[name][0]:.4f} / {ms[name][1]:.4f} "
            f"ms, plain {ms[name + ' plain'][0]:.4f} / "
            f"{ms[name + ' plain'][1]:.4f} ms (CUDA events, median of "
            f"{TIMED_KERNEL_RUNS} and {TIMED_PLAIN_RUNS}, in turns); bound "
            f"{bound[0]:.6f} ms by {bound[1]} (its busiest tile alone, "
            f"{bound[2]['busiest_share']:.4f} of the arithmetic, needs "
            f"{bound[2]['busiest_tile_ms']:.6f} ms of one SM); no PyTorch "
            "call computes this function")
    log(f"timing [{card}]: K3 {ms['K3'][0]:.4f} / {ms['K3'][1]:.4f} ms, "
        f"plain {ms['K3 plain'][0]:.4f} / {ms['K3 plain'][1]:.4f} ms (CUDA "
        f"events around the wrapper, its descriptor upload included, median "
        f"of {TIMED_KERNEL_RUNS} and {TIMED_PLAIN_RUNS}, in turns); bound "
        f"{bound3[0]:.6f} ms by {bound3[1]}; no single PyTorch call "
        "computes this function")

    def med(xs):
        return statistics.median(xs) if xs else float("nan")

    for ri, rnd in enumerate(rounds):
        for path, label in (("packed", "packed path"),
                            ("cache", "frame cache"),
                            ("compose", "compose")):
            run = rnd[path]
            st = run["stage"]
            # Steady frames: not the first, and for compose no plan build.
            steady = [i for i in range(1, n_c) if not run["rows"][i][3]]
            rebuilt = [st["total"][i] for i in range(1, n_c)
                       if run["rows"][i][3]]
            m = {k: med([v[i] for i in steady]) for k, v in st.items()}
            log(f"timing [{card}]: round {ri + 1}: {label} end to end "
                f"{m['total']:.3f} ms/frame median over {len(steady)} steady "
                f"frames at the {n_c} integer offsets (build+layout+compile "
                f"{m['compile']:.3f}, host half + device half + launch "
                f"{m['enqueue']:.3f}, wait for device {m['sync']:.3f}); "
                f"first frame {st['total'][0]:.1f} ms"
                + (f"; {len(rebuilt)} plan-rebuild frames, median "
                   f"{med(rebuilt):.3f} ms, worst {max(rebuilt):.3f} ms"
                   if rebuilt else ""))
    for path, run in (("packed path", packed), ("frame cache", cached)):
        steady = {k: v[1:] for k, v in run["stage"].items()}
        m = {k: statistics.median(v) for k, v in steady.items()}
        log(f"timing [{card}]: {path} over the fractional sweep, end to end "
            f"{m['total']:.3f} ms/frame median over {len(steady['total'])} "
            f"frames (build+layout+compile {m['compile']:.3f}, host half + "
            f"device half + launch {m['enqueue']:.3f}, wait for device "
            f"{m['sync']:.3f}); first frame {run['stage']['total'][0]:.1f} "
            "ms")

    # Where a steady frame's time goes: each stage on its own, host clock
    # to a synchronize, over the last frames of a sweep.
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
                st[1], scene.height, scene.width))),
            packed["all_scenes"][-20:]))
    log(f"timing [{card}]: frame cache, stages alone, median of 20 sweep "
        "frames: " + stages_alone((
            ("pack_frame", lambda scene, _: F.pack_frame(scene, dev)),
            ("upload+build_blocks", lambda scene, st: (F.build_blocks(
                torch.from_numpy(st[0]).to(dev), st[1], st[2], st[3]),
                st[3])),
            ("K2", lambda scene, st: B.render_tiles_blocks(
                st[0], font, image_atlas, background(scene), st[1][0],
                st[1][1], scene.height, scene.width))),
            cached["all_scenes"][-20:]))
    last = cached["all_scenes"][-1]
    n_blocks = sum(len(c) for cl in k2_inputs(last, image_atlas)[0]
                   for c in cl)
    log(f"timing [{card}]: frame cache upload per steady frame: frame blob "
        f"{F.pack_frame(last, dev)[0].nbytes} B + {n_blocks} block "
        f"descriptors {n_blocks * B._BLOCK_DESC.itemsize} B; the packed "
        f"path's blob {pack_scene(last)[0].nbytes} B")

    # Compose's stages over the last 20 scenes of its pass, warm: the
    # plans, layers and device blobs of these scenes are in the caches, so
    # the first stage is plan validation and the blob pack alone; the
    # second uploads a host copy of the blob again.
    steady_scenes = composed["all_scenes"][-20:]
    blob_host = {id(scene): C.prepare_compose_dispatch(
        scene, font, image_atlas)[0][0].cpu().numpy()
        for scene in steady_scenes}

    def tails_step(scene, state):
        args, st = state
        starts, dyns, kops = C.frame_tails(
            torch.from_numpy(blob_host[id(scene)]).to(dev), font,
            image_atlas, st["height"], st["width"], st["tiles_y"],
            st["tiles_x"], st["meta"])
        return (starts, tuple(args[1]), tuple(args[2]), dyns), dict(
            ops=kops, tiles_y=st["tiles_y"], tiles_x=st["tiles_x"],
            background=st["background"], height=st["height"],
            width=st["width"])

    n0 = counts()
    log(f"timing [{card}]: compose, stages alone, median of 20 steady "
        "frames: " + stages_alone((
            ("plan validation+pack_frame_blob",
             lambda scene, _: C.prepare_compose_dispatch(scene, font,
                                                         image_atlas)),
            ("upload+tail de-quantize", tails_step),
            ("K3", lambda scene, st: CK.compose_tiles(*st[0], **st[1]))),
            steady_scenes))
    if tuple(b - a for a, b in zip(n0, counts())) != (0, 0, 20):
        fail("compose's stages on warm caches launched K1 or K2")
    log(f"timing [{card}]: compose upload per steady frame: frame blob "
        f"{blob_bytes} B + {len(desc3)} op descriptors {desc3.nbytes} B "
        "(a frame state seen before uploads no blob)")

    # Device events and busy share over 20 end-to-end steady frames
    # (torch.profiler): compose, then the frame cache, the same offsets.
    from torch.profiler import ProfilerActivity, profile

    def profile_path(path: str, label: str):
        take_path(path)
        offs = COMPOSE_OFFSETS[-20:]
        for off in offs:                      # warm: plans, slabs, chrome
            render_scene_device(compile_at(off), font, image_atlas)
        C._BLOB_DEV_CACHE.clear()             # a first visit uploads its blob
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for off in offs:
                render_scene_device(compile_at(off), font, image_atlas)
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        take_path("compose")
        dev_events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) is not None
                      and "CUDA" in str(e.device_type)]
        dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                     for e in dev_events)
        if dev_us <= 0:
            log(f"profile [{card}]: {label}: no device time in the trace "
                "(not measured)")
            return
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:5]
        n_ev = sum(e.count for e in dev_events)
        log(f"profile [{card}]: {label}, 20 frames, device busy "
            f"{dev_us / wall_us:.4f} of {wall_us / 1e3:.2f} ms wall, "
            f"{n_ev} device events ({n_ev / 20:.1f} a frame); top kernels "
            "(us total): "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f}"
                        f" x{e.count}" for e in top))

    profile_path("compose", "compose")
    profile_path("cache", "frame cache")

    def row(name, stem, replaces, bound):
        return {"name": stem, "route": "cuda",
                "source": f"whisper_git_tpu_torch/csrc/{stem}.cu",
                "replaces": f"whisper_git_tpu/render/{replaces}",
                "launches": slice_launches[name],
                "max_abs_err": max_err[name],
                "ms": round(min(ms[name]), 6),
                "plain_ms": round(min(ms[name + " plain"]), 6),
                "bound_ms": round(bound[0], 6), "bound_by": bound[1],
                "library_ms": None}

    return [row("K1", "raster_tiles", "pallas_raster.py:321", bound1),
            row("K2", "raster_blocks", "pallas_raster.py:505", bound2),
            row("K3", "compose_tiles", "pallas_compose.py:348", bound3)]


if __name__ == "__main__":
    sys.exit(main())
