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
              K2 in every output mode (u8 frame, f32 and i16 transparent
              layer, each also cut to a tile rect; the i16 layers 0 values
              from the plain version's);
              K3 against its plain version on seeded op lists that hold
              every op kind (a layer rect off the origin ending on the
              ragged last tile row, slabs started on and off a tile
              boundary and at slab_h - height, y clips that cut tiles, odd
              widths that put no pixel pair on a 16-byte address, an
              inline and a pre-rendered tail at tile columns >= 1, no op
              at all, no slab), and on an op list over the cap of the
              descriptors that ride in the launch (the device-array route);
              a synthetic scene with a glyph tail through
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
              offsets; every cached layer of a plan build (the slabs at
              1216x1280, the chrome groups over their ink's tile rects) as
              K2 writes it, i16, 0 values from the plain version's
  5. cli      `python -m whisper_git_tpu_torch --screenshot` writes a
              1280x800 PNG (through compose)
  6. timings  each kernel and its plain version at the history view (CUDA
              events around the wrapper, median, taken in turns, and the
              kernel alone from the profiler) beside its bound; K2 at the
              slab's size beside the former route (f32 layer, then the
              quantize in torch ops); K2's column split and K3's row split
              by measurement; K3 after a flush of the L2 and with an op
              list over the cap; the three
              paths' end-to-end frame time over the same integer offsets
              (host clock to a synchronize, median; first and plan-rebuild
              frames apart) and each stage of a frame alone; each path's
              upload per frame; device events and host-to-device copies a
              frame and the device's busy share over 20 frames of compose
              and of the frame cache, and the device events of one plan
              build (torch.profiler): a steady composed frame copies at
              most its blob, and no quantize pass follows a layer build

Tolerances (the reference's own): shape-only scenes within 1 u8; scenes
with glyphs or images at most 8 u8 with more than 2 u8 on under 1 % of
values; the empty scene within 1 u8 of the background; an f32 layer the
same in units of 1/255; an i16 layer bit for bit the quantized values of
the kernel's own f32 layer, and from the plain version's 0 counts on shapes
and at most 1 count where glyphs or images are resampled; the compose
kernel within 1 u8 of its plain version (0 expected: the same f32
arithmetic, no multiply-add contracted).

A kernel's bound is the larger of two times: the bytes it must move (its
command tables, bins and bounds, the atlas cells its bins reference and
the frame it writes, each once) over 3.35 TB/s, and the arithmetic of
this run's bin entries (for each entry the pixels of its command's extent
inside its tile and the frame, `raster_kernel.command_extents`, x
operations per pixel of the entry's class) over 67 TFLOP/s, the H100's f32
rate outside the tensor cores. Outside its extent a command's coverage is
exactly 0, so no implementation has to compute there; the former count
(8192 pixels an entry) is logged beside the new one. The compose kernel's
bytes are the frame written, 8 B a pixel of every chrome layer and of every
slab's visible rows, 16 B a pixel of a pre-rendered tail, the inline tails'
tables and bins, the starts and the descriptors; its arithmetic 11
operations a pixel a blended i16 layer, 7 an f32 one, and the inline tails'
bin entries as above. The script fails if a kernel reads faster than its
bound.

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
# Odd widths: layers whose pixel pairs lie on no 16-byte addresses, and a
# frame whose last pair is half a pair.
COMPOSE_SYNTH_ODD = (421, 301)
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


def entry_pixels(torch, K, ci, tables, bins, live, tiles_x, height, width):
    """For the live slots of a (T, k) bins table: → (tile index (M,), pixels
    of each entry's extent inside its tile and the frame (M,) i64)."""
    t_idx, k_idx = torch.nonzero(live, as_tuple=True)
    ext = K.command_extents(ci, tables)[bins[t_idx, k_idx].long()]
    return t_idx, K.extent_tile_pixels(ext, t_idx, tiles_x, height, width)


def kernel_bound(torch, K, runs, out, tiles_x) -> tuple[float, str, dict]:
    """The least time the card could take for one launch. `runs` lists
    what the launch walks: (class, tables, bins, lo, hi), lo and hi None
    where the whole row counts. → (bound ms, "bytes" | "operations",
    {"entries": per class, "pixels": of their extents per class, "bytes":
    moved, "old_ms": the bound at 8192 pixels an entry, "busiest_tile_ms",
    "busiest_share"})."""
    entries, pixels = [0, 0, 0], [0, 0, 0]
    tile_flops = None   # per tile: the arithmetic its own bins rows cost
    seen, n_bytes = set(), out.numel() * out.element_size()
    height, width = out.shape[0], out.shape[1]

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
        t_idx, n_px = entry_pixels(torch, K, ci, tables, bins, live, tiles_x,
                                   height, width)
        entries[ci] += int(t_idx.numel())
        pixels[ci] += int(n_px.sum().item())
        if tile_flops is None:
            tile_flops = torch.zeros(bins.shape[0], dtype=torch.int64,
                                     device=bins.device)
        tile_flops.index_add_(0, t_idx, n_px * FLOPS_PER_PIXEL[ci])
        for t in (*tables, bins, lo, hi):
            once(t)
        if ci and bool(live.any()):
            uv = tables[0][bins[live].long()][:, 4:6]
            n_bytes += int(torch.unique(uv, dim=0).shape[0]) * CELL_BYTES[ci]
    flops = sum(n * f for n, f in zip(pixels, FLOPS_PER_PIXEL))
    old_flops = sum(n * TILE_PIXELS * f for n, f in zip(entries,
                                                        FLOPS_PER_PIXEL))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    # A tile's strips run on at most four of the card's 132 SMs.
    busiest = int(tile_flops.max().item()) if tile_flops is not None else 0
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations",
            {"entries": tuple(entries), "pixels": tuple(pixels),
             "bytes": n_bytes,
             "old_ms": max(t_bytes, old_flops / PEAK_F32_FLOPS * 1e3),
             "busiest_tile_ms": busiest / (PEAK_F32_FLOPS / 132) * 1e3,
             "busiest_share": busiest / flops if flops else 0.0})


BLEND_FLOPS_I16 = 11   # 4 scales, 1 - a, three multiply-adds
BLEND_FLOPS_F32 = 7


def compose_bound(torch, K, starts, images, slabs, dyns, ops, out,
                  desc_bytes: int) -> tuple[float, str, dict]:
    """The least time the card could take for one compose launch on these
    inputs. → (bound ms, "bytes" | "operations", {"bytes", "layer_px":
    pixels blended from chrome layers, slab rows inside their y clip and
    pre-rendered tails, "entries": inline shape bin entries, "pixels": of
    their extents, "old_ms": the bound at 8192 pixels an entry})."""
    height, width = out.shape[0], out.shape[1]
    n_bytes = (out.numel() + starts.numel() * starts.element_size()
               + desc_bytes)
    px_i16 = px_f32 = entries = pixels = 0
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
            shapes, clips, bins, counts = tables
            n_bytes += sum(t.numel() * t.element_size() for t in tables)
            k = torch.arange(bins.shape[1], device=bins.device)[None, :]
            # The tail's tables and bins live in its sub-grid of tile
            # columns [c0, c0 + ts), and so do the extents.
            t_idx, n_px = entry_pixels(
                torch, K, 0, (shapes, clips), bins,
                (bins >= 0) & (k < counts[:, None]), op[4], height,
                width - op[3] * 128)
            entries += int(t_idx.numel())
            pixels += int(n_px.sum().item())
        else:
            t = dyns.get((op[1], op[2]))
            if t is not None:
                px_f32 += t.shape[0] * t.shape[1]
    n_bytes += 8 * px_i16 + 16 * px_f32
    blend = BLEND_FLOPS_I16 * px_i16 + BLEND_FLOPS_F32 * px_f32
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (blend + pixels * FLOPS_PER_PIXEL[0]) / PEAK_F32_FLOPS * 1e3
    t_old = (blend + entries * TILE_PIXELS * FLOPS_PER_PIXEL[0]) \
        / PEAK_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", {"bytes": n_bytes, "layer_px": px_i16 + px_f32,
                           "entries": entries, "pixels": pixels,
                           "old_ms": max(t_bytes, t_old)})


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

    def compare_i16(label, kind_s, k, p, k_f32, shape):
        """K2's i16 layer: the quantized values of its own f32 layer, bit
        for bit; against the plain version's i16 layer 0 values apart on
        shapes, and where glyphs or images are resampled at most one count
        (the plain version's matrix products contract multiply-adds on the
        card, the kernel does not: its f32 layers differ in the last
        place, which can move a value across a rounding boundary)."""
        if tuple(k.shape) != shape or k.dtype != torch.int16 \
                or not k.is_contiguous():
            fail(f"K2 {label}: kernel output {tuple(k.shape)} {k.dtype}")
        if not torch.equal(k, B.quantize_i16(k_f32)):
            fail(f"K2 {label}: not quantize_i16 of the kernel's f32 layer")
        d = (k.int() - p.int()).abs()
        apart, mx = int(d.gt(0).sum().item()), int(d.max().item())
        max_err["K2"] = max(max_err["K2"], mx * 255.0 / 32767.0)
        i16_apart.append(apart)
        log(f"K2 vs plain: {label}: {apart} of {d.numel()} i16 values "
            f"apart, max {mx} count(s)")
        if mx > (0 if kind_s in ("shapes", "empty") else 1):
            fail(f"K2 disagrees with its plain version on {label}")

    # ---- 3. each kernel against its plain version ----------------------------
    n_modes, i16_apart = 0, []
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
            layer_args = k2_inputs(scene, atlas, bg=None)
            ki, pi = both(
                lambda *a: B.render_tiles_blocks(*a, layer_i16=True),
                lambda *a: B.render_tiles_blocks_plain(*a, layer_i16=True),
                layer_args)
            compare_i16(label + " i16 layer", kind_s, ki, pi, k3, shape)
            # A tile rect off the origin that ends on the frame's ragged
            # edge, and one at the origin: the full output cut to it.
            ty, tx = layer_args[4], layer_args[5]
            for rect in ((ty // 2, tx // 2, ty, tx),
                         (0, 0, max(1, ty // 2), max(1, tx - 1))):
                ys = slice(rect[0] * 64, rect[2] * 64)
                xs = slice(rect[1] * 128, rect[3] * 128)
                for what, full, args_m, kw_m in (
                        ("u8 frame", k2, k2_inputs(scene, atlas), {}),
                        ("f32 layer", k3, layer_args, {}),
                        ("i16 layer", ki, layer_args, {"layer_i16": True})):
                    got = B.render_tiles_blocks(*args_m, tile_rect=rect,
                                                **kw_m)
                    if not got.is_contiguous() \
                            or not torch.equal(got, full[ys, xs]):
                        fail(f"K2 {label} {what}: tile rect {rect} is not "
                             "the full output cut to it")
            n_modes += 7
    log(f"K2: {n_modes} launches in the i16 and tile-rect modes on the "
        f"synthetic scenes; i16 layers {sum(i16_apart)} values from the plain "
        f"version's over {len(i16_apart)} scenes; every tile rect "
        "torch.equal to the full output cut to it")
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

    kinds_seen = set()
    for cw, ch in (COMPOSE_SYNTH_SIZE, COMPOSE_SYNTH_ODD):
        for case in COMPOSE_CASES:
            for seed in (0, 1):
                a = compose_args_to(synthetic_compose(case, seed, cw, ch),
                                    dev)
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
    cw, ch = COMPOSE_SYNTH_SIZE
    # An op list over the cap of the descriptors that ride in the launch:
    # the same layers blended again and again, through the device array.
    for case in ("layers", "tails"):
        a = compose_args_to(synthetic_compose(case, 0, cw, ch), dev)
        pos = tuple(a.pop(k) for k in ("starts", "images", "slabs", "dyns"))
        a["ops"] = a["ops"] * (CK.MAX_INLINE_OPS // len(a["ops"]) + 1)
        if len(a["ops"]) <= CK.MAX_INLINE_OPS:
            fail("the long op list is under the cap")
        k, p = k3_both(pos, a)
        compare_k3(f"{case:10s} over the cap, {len(a['ops'])} ops through "
                   "the device array", k, p, (ch, cw, 4))
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
        """→ (starts, images, slabs, dyns), keywords, blob bytes, the
        plan's descriptor rows."""
        args, st = C.prepare_compose_dispatch(scene, font, image_atlas)
        starts, dyns, kops = C.frame_tails(
            args[0], font, image_atlas, st["height"], st["width"],
            st["tiles_y"], st["tiles_x"], st["meta"])
        kw = dict(ops=kops, tiles_y=st["tiles_y"], tiles_x=st["tiles_x"],
                  background=st["background"], height=st["height"],
                  width=st["width"])
        return ((starts, tuple(args[1]), tuple(args[2]), dyns), kw,
                args[0].numel() * args[0].element_size(), st["rows"])

    for off in COMPOSE_PLAIN_OFFSETS:
        scene = composed["scenes"][off]
        pos, kw, _, _ = k3_inputs(scene)
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

    # Every cached layer of a plan build, as K2 writes it: the slabs whole,
    # the chrome groups over the tile rects of their ink, i16.
    F.clear_caches()
    C.clear_caches()
    layer_builds = []
    real_blocks = C.render_tiles_blocks

    def recording(*a, **k):
        out = real_blocks(*a, **k)
        if k.get("layer_i16"):
            layer_builds.append((a, k, out))
        return out

    C.render_tiles_blocks = recording
    try:
        render_scene_device(compile_at(0.0), font, image_atlas)
    finally:
        C.render_tiles_blocks = real_blocks
    torch.cuda.synchronize()
    slab_builds = [r for r in layer_builds if "tile_rect" not in r[1]]
    group_builds = [r for r in layer_builds if "tile_rect" in r[1]]
    if len(slab_builds) < 2 or not group_builds:
        fail(f"a plan build at offset 0 rendered {len(slab_builds)} slabs and "
             f"{len(group_builds)} chrome groups")
    cached_ptrs = ({v[0].data_ptr() for v in C._GROUP_CACHE.values()}
                   | {v["img"].data_ptr() for v in C._SLAB_CACHE.values()})
    if {out.data_ptr() for _, _, out in layer_builds} != cached_ptrs:
        fail("a cached layer is not the tensor K2 wrote: a pass followed it")
    for a, k, out in layer_builds:
        rect = k.get("tile_rect")
        what = (f"chrome group over tiles {rect} of {a[4]}x{a[5]}" if rect
                else f"slab, class {[len(c) for c in a[0][0]].index(1)}")
        plain = B.render_tiles_blocks_plain(*a, **k)
        own_f32 = B.render_tiles_blocks(*a, tile_rect=rect)
        compare_i16(f"plan build: {what}, {out.shape[1]}x{out.shape[0]}",
                    "history", out, plain, own_f32, tuple(plain.shape))
    n_cut = sum(1 for a, k, _ in group_builds
                if (k["tile_rect"][2] - k["tile_rect"][0])
                * (k["tile_rect"][3] - k["tile_rect"][1]) < a[4] * a[5])
    log(f"slice: a plan build wrote {len(slab_builds)} slabs and "
        f"{len(group_builds)} chrome groups ({n_cut} over fewer tiles than "
        "the frame's) as i16 straight from K2; the caches hold those very "
        "tensors")

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
    pos3, kw3, blob_bytes, rows3 = k3_inputs(composed["scenes"][0.0])
    from torch.profiler import ProfilerActivity, profile

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

    def device_events(prof) -> list:
        return [e for e in prof.key_averages()
                if getattr(e, "device_type", None) is not None
                and "CUDA" in str(e.device_type)]

    flush_buf = torch.empty(192 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn, runs: int = 20, flush: bool = False):
        """→ (this repository's kernels alone, every device event of `fn`),
        ms a call, from the profiler's device times over `runs` calls; with
        `flush` the 50 MB L2 is overwritten before each call (not
        counted)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                if flush:
                    flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        own = every = 0.0
        for e in device_events(prof):
            if "raster::" in e.key:
                own += e.self_device_time_total
            if not flush or "raster::" in e.key:
                every += e.self_device_time_total
        if own <= 0:
            fail("the profiler shows no device time for the kernel")
        return own / runs / 1e3, every / runs / 1e3

    def host_us(fn, runs: int = 200) -> float:
        """The host's time to enqueue one call, in microseconds: what a
        short kernel's wrapper costs before the device has anything to do."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / runs * 1e6

    timed = (("K1 plain", lambda: K.render_tiles_plain(*args1),
              TIMED_PLAIN_RUNS),
             ("K1", lambda: K.render_tiles(*args1), TIMED_KERNEL_RUNS),
             ("K2 plain", lambda: B.render_tiles_blocks_plain(*args2),
              TIMED_PLAIN_RUNS),
             ("K2", lambda: B.render_tiles_blocks(*args2),
              TIMED_KERNEL_RUNS),
             ("K3 plain", lambda: CK.compose_tiles_plain(*pos3, **kw3),
              TIMED_PLAIN_RUNS),
             ("K3", lambda: CK.compose_tiles(*pos3, **kw3, rows=rows3),
              TIMED_KERNEL_RUNS),
             ("K3 rows afresh", lambda: CK.compose_tiles(*pos3, **kw3),
              TIMED_KERNEL_RUNS))
    ms = {name: [] for name, _, _ in timed}
    alone, host = {}, {}
    for _ in range(2):                       # in turns, twice round
        for name, fn, runs in timed:
            ms[name].append(event_ms(fn, runs))
            if "plain" not in name:
                host.setdefault(name, []).append(host_us(fn))
                if "afresh" not in name:
                    alone.setdefault(name, []).append(device_ms(fn)[0])
    log(f"timing [{card}]: the wrappers' host time to enqueue one call "
        "(host clock over 200 calls, no synchronize between): "
        + "; ".join(f"{name} {v[0]:.1f} / {v[1]:.1f} us"
                    for name, v in host.items()))
    out1, out2 = K.render_tiles(*args1), B.render_tiles_blocks(*args2)
    out3 = CK.compose_tiles(*pos3, **kw3, rows=rows3)

    def blocks_runs(layers_blocks):
        return [(ci, *block) for cls_lists in layers_blocks
                for ci in B.Z_ORDER for block in cls_lists[ci]]

    bound1 = kernel_bound(torch, K, [
        (ci, tuple(layer[j] for j in F._CLS_TABLES[ci]), layer[7 + ci],
         None, None)
        for layer, sig in zip(args1[0], args1[6])
        for ci in B.Z_ORDER if sig[ci]], out1, args1[5])
    bound2 = kernel_bound(torch, K, blocks_runs(args2[0]), out2, args2[5])
    desc3 = CK.op_descriptors(pos3[1], pos3[2], pos3[3], kw3["ops"],
                              kw3["tiles_y"], pos3[0].device, rows3)[0]
    bound3 = compose_bound(torch, K, *pos3, kw3["ops"], out3, desc3.nbytes)
    log(f"timing [{card}]: history view {W}x{H} at offset 0; K1 walks "
        f"(shape, glyph, image) bin entries {bound1[2]['entries']} whose "
        f"extents hold {bound1[2]['pixels']} pixels and moves "
        f"{bound1[2]['bytes']} B, K2 {bound2[2]['entries']} with "
        f"{bound2[2]['pixels']} pixels and {bound2[2]['bytes']} B in "
        f"{sum(len(c) for cl in args2[0] for c in cl)} blocks; K3 blends "
        f"{len(kw3['ops'])} ops ({', '.join(op[0] for op in kw3['ops'])}), "
        f"{bound3[2]['layer_px']} layer pixels and {bound3[2]['entries']} "
        f"inline shape entries with {bound3[2]['pixels']} pixels, and moves "
        f"{bound3[2]['bytes']} B")
    log(f"timing [{card}]: the bound counts the pixels of each entry's extent "
        "inside its tile; at 8192 pixels an entry, the former count, it was "
        + ", ".join(f"{name} {b[2]['old_ms']:.6f} ms (now {b[0]:.6f})"
                    for name, b in (("K1", bound1), ("K2", bound2),
                                    ("K3", bound3))))
    for name, bound in (("K1", bound1), ("K2", bound2)):
        log(f"timing [{card}]: {name} {ms[name][0]:.4f} / {ms[name][1]:.4f} "
            f"ms by CUDA events around the wrapper, {alone[name][0]:.4f} / "
            f"{alone[name][1]:.4f} ms the kernel alone (profiler), plain "
            f"{ms[name + ' plain'][0]:.4f} / "
            f"{ms[name + ' plain'][1]:.4f} ms (median of "
            f"{TIMED_KERNEL_RUNS} and {TIMED_PLAIN_RUNS}, in turns); bound "
            f"{bound[0]:.6f} ms by {bound[1]} (its busiest tile alone, "
            f"{bound[2]['busiest_share']:.4f} of the arithmetic, needs "
            f"{bound[2]['busiest_tile_ms']:.6f} ms of one SM); no PyTorch "
            "call computes this function")
    log(f"timing [{card}]: K3 {ms['K3'][0]:.4f} / {ms['K3'][1]:.4f} ms by "
        "CUDA events around the wrapper with the plan's rows, as a frame "
        f"calls it ({ms['K3 rows afresh'][0]:.4f} / "
        f"{ms['K3 rows afresh'][1]:.4f} ms with every row built and checked "
        f"afresh), {alone['K3'][0]:.4f} / {alone['K3'][1]:.4f} ms the kernel "
        f"alone (profiler), plain {ms['K3 plain'][0]:.4f} / "
        f"{ms['K3 plain'][1]:.4f} ms (median of {TIMED_KERNEL_RUNS} and "
        f"{TIMED_PLAIN_RUNS}, in turns); bound {bound3[0]:.6f} ms by "
        f"{bound3[1]}; no single PyTorch call computes this function")

    # K2 at the slab's size, i16 out, beside the former route: the f32
    # layer, then the quantize in torch ops (`quantize_i16`).
    slab_ms = {}
    for a, k, out in slab_builds:
        ci = [len(c) for c in a[0][0]].index(1)
        bound = kernel_bound(torch, K, blocks_runs(a[0]), out, a[5])

        def new_route(a=a):
            return B.render_tiles_blocks(*a, layer_i16=True)

        def old_route(a=a):
            return B.quantize_i16(B.render_tiles_blocks(*a))

        ev = [event_ms(fn, 20) for fn in (old_route, new_route, new_route,
                                          old_route)]
        dv = [device_ms(fn) for fn in (old_route, new_route, new_route,
                                       old_route)]
        slab_ms[ci] = (min(ev[1], ev[2]), min(dv[1][0], dv[2][0]))
        log(f"timing [{card}]: K2 at the slab's size, class {ci}, "
            f"{out.shape[1]}x{out.shape[0]} i16 layer over {a[4] * a[5]} "
            f"tiles, {bound[2]['entries'][ci]} entries with "
            f"{bound[2]['pixels'][ci]} pixels: {ev[1]:.4f} / {ev[2]:.4f} ms "
            f"by events, {dv[1][0]:.4f} / {dv[2][0]:.4f} ms the kernel "
            f"alone; the former route (f32 layer + quantize_i16 in torch "
            f"ops) {ev[0]:.4f} / {ev[3]:.4f} ms by events, its device "
            f"events {dv[0][1]:.4f} / {dv[3][1]:.4f} ms of which K2 "
            f"{dv[0][0]:.4f} / {dv[3][0]:.4f}; bound {bound[0]:.6f} ms by "
            f"{bound[1]} ({bound[2]['old_ms']:.6f} at 8192 pixels an entry)")
        if min(ev[1], ev[2]) < bound[0]:
            fail("K2 at the slab's size reads faster than its bound")

    # The splits, by measurement: the unit of a tile a K2 CTA owns (at the
    # history view and at the slab of glyphs), the rows a K3 thread owns.
    glyph_slab = [a for a, _, _ in slab_builds
                  if [len(c) for c in a[0][0]].index(1) == 1]
    chosen = (B.STRIP_W, B.ROWS_PER_THREAD)
    parts = []
    for strip, rows_pt in ((32, 4), (64, 4), (32, 8), (32, 16), (128, 16)):
        B.STRIP_W, B.ROWS_PER_THREAD = strip, rows_pt
        t_hist = device_ms(lambda: B.render_tiles_blocks(*args2))[0]
        t_slab = (device_ms(lambda: B.render_tiles_blocks(
            *glyph_slab[0], layer_i16=True))[0] if glyph_slab
            else float("nan"))
        parts.append(f"{strip}x{4 * rows_pt} {t_hist:.4f} ms at the history "
                     f"view, {t_slab:.4f} ms at the slab of glyphs")
    B.STRIP_W, B.ROWS_PER_THREAD = chosen
    log(f"timing [{card}]: K2's unit of a tile (columns x rows a CTA), the "
        f"kernel alone (the port launches {chosen[0]}x{4 * chosen[1]}): "
        + "; ".join(parts))
    chosen = CK.ROWS_PER_THREAD
    parts = []
    for rows_pt in (2, 4, 8):
        CK.ROWS_PER_THREAD = rows_pt

        def k3_call():
            return CK.compose_tiles(*pos3, **kw3, rows=rows3)

        parts.append(f"{2 * rows_pt} rows a CTA {device_ms(k3_call)[0]:.4f} "
                     f"ms, after a flush of the L2 "
                     f"{device_ms(k3_call, flush=True)[0]:.4f} ms")
    CK.ROWS_PER_THREAD = chosen
    log(f"timing [{card}]: K3's row split, the kernel alone, back to back "
        f"on one frame's layers (the port launches {2 * chosen} rows a "
        "CTA): " + "; ".join(parts))

    # K3 with an op list over the cap, through the device array: the
    # smallest chrome layer blended again until the list is one too long.
    small = min((op for op in kw3["ops"] if op[0] == "img"),
                key=lambda op: pos3[1][op[1]].numel())
    long_kw = dict(kw3, ops=kw3["ops"] + (small,) * (
        CK.MAX_INLINE_OPS + 1 - len(kw3["ops"])))
    k, p_ = k3_both(pos3, long_kw)
    compare_k3(f"history view, {len(long_kw['ops'])} ops through the device "
               "array", k, p_, (H, W, 4))
    inline_kw = dict(long_kw, ops=long_kw["ops"][:-1])
    ev = [event_ms(lambda kw=kw: CK.compose_tiles(*pos3, **kw, rows=rows3),
                   TIMED_KERNEL_RUNS) for kw in (inline_kw, long_kw)]
    log(f"timing [{card}]: K3 with {len(inline_kw['ops'])} ops riding in the "
        f"launch {ev[0]:.4f} ms, with {len(long_kw['ops'])} through an "
        f"uploaded device array {ev[1]:.4f} ms (CUDA events around the "
        f"wrapper, median of {TIMED_KERNEL_RUNS})")

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

    # Device events, host-to-device copies and busy share over 20
    # end-to-end steady frames (torch.profiler): compose, then the frame
    # cache, the same offsets.
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
        dev_events = device_events(prof)
        dev_us = sum(e.self_device_time_total for e in dev_events)
        if dev_us <= 0:
            fail(f"profile: {label}: no device time in the trace")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:5]
        n_ev = sum(e.count for e in dev_events)
        copies = sum(e.count for e in dev_events if "memcpy" in e.key.lower())
        log(f"profile [{card}]: {label}, 20 frames, device busy "
            f"{dev_us / wall_us:.4f} of {wall_us / 1e3:.2f} ms wall, "
            f"{n_ev} device events ({n_ev / 20:.1f} a frame), {copies} of "
            f"them copies ({copies / 20:.1f} a frame); top kernels "
            "(us total): "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total:.1f}"
                        f" x{e.count}" for e in top))
        return n_ev / 20, copies / 20

    events_c, copies_c = profile_path("compose", "compose")
    if copies_c > 1.0:
        fail(f"a steady composed frame makes {copies_c} copies: more than "
             "its blob's")
    if events_c >= 10.0:
        fail(f"a steady composed frame has {events_c} device events, no "
             "fewer than before the descriptors rode in the launch (10.0)")
    profile_path("cache", "frame cache")

    # One plan build under the profiler: the layers come out of K2 as i16,
    # and no rounding pass follows a slab or a group.
    F.clear_caches()
    C.clear_caches()
    scene = compile_at(0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_scene_device(scene, font, image_atlas)
        torch.cuda.synchronize()
    dev_events = device_events(prof)
    rounding = [e.key for e in dev_events if "round" in e.key.lower()]
    own = {e.key[:48]: (e.count, e.self_device_time_total)
           for e in dev_events if "raster::" in e.key}
    log(f"profile [{card}]: one plan build at offset 0 (4 groups, 2 slabs): "
        f"{sum(e.count for e in dev_events)} device events, "
        f"{sum(e.self_device_time_total for e in dev_events) / 1e3:.4f} ms of "
        f"device time; this repository's kernels (count, us): {own}; "
        f"{len(rounding)} rounding kernels")
    if rounding:
        fail(f"a plan build ran a quantize pass in torch ops: {rounding}")

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

    kernels = [row("K1", "raster_tiles", "pallas_raster.py:321", bound1),
               row("K2", "raster_blocks", "pallas_raster.py:505", bound2),
               row("K3", "compose_tiles", "pallas_compose.py:348", bound3)]
    for r, name in zip(kernels, ("K1", "K2", "K3")):
        if min(r["ms"], min(alone[name])) < r["bound_ms"]:
            fail(f"{r['name']} reads faster than its bound: {r}")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
