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
  5. oversized  the history view at 5120x2880, over the i16 wire
              format's 4095 px, through `render_scene_device`: the f32
              path, one K1 launch and no K2 or K3 launch; K1's frame
              against its plain version and `torch.equal` to K2's over the
              same tables and bins; K1 timed by events, alone, against its
              bound, and the frame end to end
  6. cli      `python -m whisper_git_tpu_torch --screenshot` writes a
              1280x800 PNG (through compose) and a 5120x2880 one (through
              the oversized path); `--dump-bundles DIR` writes the .svg,
              .tree.txt and .lint.txt of every scene `tools/dump_bundles.py`
              builds, the names read from its code
  7. timings  each kernel and its plain version at the history view (CUDA
              events around the wrapper, median, taken in turns, and the
              kernel alone from the profiler) beside its bound, and K1
              alone over K2 alone; K2 at the
              slab's size beside the former route (f32 layer, then the
              quantize in torch ops); K1's and K2's unit of a tile and K3's
              row split by measurement; K3 after a flush of the L2 and with
              an op list over the cap; the three
              paths' end-to-end frame time over the same integer offsets
              (host clock to a synchronize, median; first and plan-rebuild
              frames apart) and each stage of a frame alone; each path's
              upload per frame; device events and host-to-device copies a
              frame and the device's busy share over 20 frames of compose
              and of the frame cache, and the device events of one plan
              build (torch.profiler): a steady composed frame copies at
              most its blob, and with its blob on the card is one K3
              launch and no other device event; no quantize pass follows
              a layer build
  8. present  the presenter's `_downsample` on the card within 1 u8 of the
              CPU's (the history view and seeded frames, at terminal, sixel
              and 1:1 sizes); `TermDisplay` fed CUDA frames through its
              pinned ring and present thread, two grid sizes: every
              presented grid its frame's downsample, in order, the last
              frame presented
  9. loop     the port's CLI on a pty on the card (`python -m
              whisper_git_tpu_torch <repo>`): alt screen, first half-block
              frame, a repaint after a click and after typing a search, the
              Escape ladder quits with rc 0 and the terminal restored (each
              timed); then in this process `run_loop(app, max_frames=5)`
              under WGIT_FRAME_DUMP: K3 launched once for each composed
              frame, K1 never, and the dump `torch.equal` to
              `render_scene_device` of the same state
  10. bench   `python -m whisper_git_tpu_torch.bench` at the reference's
              counts (80 frames a batch, 12 batches): its JSON line logged;
              fails on a missing field or a non-positive rate
  11. diffword  the word diff's ranges on the card equal to the CPU's and
              to the scalar `intra_line_highlight` on seeded pairs
  12. edt     the exact EDT (`ops/sdf.py`) through `encode_sdf_cells` on the
              card: 16 seeded coverages and the cells of the stored DejaVu
              masks (`data/bank_masks.npz`) byte-equal to the CPU's u8 cells
              (the f32 distances torch.equal); a padded bank batch (16
              cells) timed on the card (host clock and CUDA events) and on
              the CPU
  13. goldens the nine golden scenes (`tools/goldens.py`, 360x240) through
              `render_scene_device` under the default level, each within
              the reference's TOLERANCE (2 u8) of its PNG (read with the
              port's decoder); `fallback` with the bank pinned to the
              stored masks (`tools/mask_font.py`: rasterize, the EDT on the
              card, texture rows, re-upload), also through the frame cache
              and the packed path (equal bit for bit, compose within 1 u8);
              K1 and K2 against their plain versions on its bank glyphs;
              each frame's launches those of its level; the font texture
              grown by the bank's rows once and uploaded again once for
              each bank version
  14. avatars the history view of a repository by 8 authors at 1280x800
              with the avatar cache under XDG_CACHE_HOME primed (six 64x64
              PNGs, one 96x96, one corrupt) and WGIT_SKIP_AVATARS unset:
              7 LOADED, 1 FAILED; packed ≡ frame cache bit for bit, compose
              within 1 u8, K2 rendering a slab of image quads on the plan
              build, each kernel against its plain version on the frame,
              the image atlas uploaded once for each atlas version; a
              steady composed frame with avatars and without, host clock
              and device time
  15. mesh    the mesh paths on one card, the counterpart of the
              reference's `dryrun_multichip`: meshes of 4 x cuda:0 (1 x 4)
              and 8 x cuda:0 (2 x 4); three steady scroll frames of
              `tools/fixtures.py::steady_window_tree` and of the history
              view at 1280x800 (13 tile rows: not a multiple of 4 or 8)
              through compose and through the frame cache, and of a
              320 px scene with a pre-rendered volatile tail (5 rows over
              8 shards) through compose, each pass from empty caches and
              every frame torch.equal to the single-device frame; K3
              launched once a shard that holds a frame row a frame, K2 once
              a shard a layer build or frame; each kernel on every slice
              (pad rows among them) against its plain version, and the
              slices put together torch.equal to the whole launch;
              `render_batch_sharded` with B = 4 on the 2 x 4 mesh against
              one K1 launch a frame; each sliced launch timed by events
              and alone after a flush of the L2 beside the whole one, and
              its bound over its own entries and bytes (it fails if one
              reads faster); the steady composed frame on one device and
              under both meshes
  16. tools   `tools/vector_smoke.py` on the card (both seams within 2 u8),
              `tools/kernel_times.py compose` (K3 by op kind), and
              `tools/soak.py --secs 15`, the CLI on a pty, which must pass
              its gates
  17. cards   the render mesh over the machine's real cards, as a user's
              process takes it (WGIT_MESH unset); on one card logged as
              "not run (1 card)". Each kernel on a slice of the history
              view on each card against its plain version there, the slices
              put together torch.equal to one card's frame, and each
              kernel's first launch on each card timed (its module load);
              `Renderer("cuda")` installs the (1, n) mesh over cuda:0 ..
              cuda:n-1, `Renderer("cuda:1")` the same cards from cuda:1,
              WGIT_MESH=2 (where n >= 4) two cards; under the auto mesh,
              from empty caches, every frame torch.equal to one card's: the
              history view at 1280x800 through compose over phase 4's 57
              integer offsets (K3 once a frame on each card that holds a
              frame row, K2 only on plan builds, on the cards that hold the
              built layer's rows) and through the frame cache over those
              and the fractional sweep (K2 once a frame a card), the
              512x320 volatile image of phase 15, and the packed and the
              5120x2880 oversized frames, one K1 launch on cuda:0 and none
              elsewhere; `render_batch_sharded` over 1 x n and 2 x n/2
              meshes of the cards against one K1 launch a frame; the bytes
              a frame copies between cards (replicas, layer commits,
              gather) from empty caches and steady, where it fails if a
              steady composed or frame-cache frame copies an atlas, a
              cached layer or a cached chrome table; the profiler over
              every card (device time a frame by card, K3 launches that
              overlap another card's); the steady composed and frame-cache
              frames and the worst plan-rebuild frame on one card, under
              the auto mesh and on 2 cards, in two turns, each frame's
              synchronize of cuda:0 leaving no work on another card; and
              `--screenshot` with WGIT_MESH unset byte-equal to
              WGIT_MESH=0's, the app on a pty to its first frame and a
              clean exit, and the bench, whose line must name the mesh and
              every card's device time and busy share (none over 1)

Phases 1-16 run on one card on any machine: `main` sets WGIT_MESH=0 before
the first Renderer, and the CLI, bench and soak processes inherit it.
`python3 chip_smoke.py --only cards` runs the build, the history fixture
and phase 17 alone (no kernels line): the quick way to look at a machine
with several cards.

The process refuses every connection to another host (`refuse_network`):
with avatars on, a fetch fails as it would with no network. It refuses
every import of JAX, the JAX package, Pillow, fontTools and matplotlib
(`refuse_imports`; it logs which of the last three are installed), so it
runs as on a machine without them: the fallback bank loads no chain font
and the avatar decode has no Pillow to fall back on.

Tolerances: K1 and K2 0 u8 from their plain versions (an f32 layer in
units of 1/255) where only shapes are drawn (elementwise f32 on both
sides, no multiply-add contracted);
where glyphs or images are resampled, the reference's own: at most 8 u8
with more than 2 u8 on under 1 % of values (the plain versions resample
with the reference's matrix products, which cuBLAS runs with fused
multiply-adds, and PyTorch divides a CUDA tensor by a Python number as a
product with its reciprocal; the kernels round each step). An i16 layer
bit for bit the quantized values of the kernel's own f32 layer, and from
the plain version's 0 counts on shapes, at most 1 where glyphs or images
are resampled; the empty scene within 1 u8 of the background; the compose
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
i16 tables and bins rows and the i16 starts it reads from the frame blob,
and the descriptors; its arithmetic 11
operations a pixel a blended i16 layer, 7 an f32 one, and the inline tails'
bin entries as above. The script fails if a kernel reads faster than its
bound.

Prints each card's launches on the main paths (phases 1-16 on cuda:0,
phase 17's mesh paths on every card) as a JSON line, the card's line, a
JSON line of kernel results, and last {"ok": true, "device": {...}}. Exits non-zero, printing no result, on any
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
from types import SimpleNamespace

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
OVERSIZED = (5120, 2880)   # a 5K screenshot: 40 x 45 tiles
ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def build_history_repo(base: str, n_commits: int = 240) -> str:
    """The bench's fixture repository (the port's bench
    `whisper_git_tpu_torch/bench.py::build_history_repo`, a copy of the
    reference's): ~240 empty commits with feature branches merged every 17
    commits, a tag and an untracked file, on pinned dates."""
    from whisper_git_tpu_torch.bench import build_history_repo as build

    return build(base, n_commits)


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
        return mx == 0
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


def entry_pixels(torch, K, ci, tables, bins, live, tiles_x, height, width,
                 tile0=0):
    """For the live slots of a (T, k) bins table whose row t is tile tile0 +
    t: → (row index (M,), pixels of each entry's extent inside its tile and
    the frame (M,) i64)."""
    t_idx, k_idx = torch.nonzero(live, as_tuple=True)
    ext = K.command_extents(ci, tables)[bins[t_idx, k_idx].long()]
    return t_idx, K.extent_tile_pixels(ext, t_idx + tile0, tiles_x, height,
                                       width)


def kernel_bound(torch, K, runs, out, tiles_x, tile0=0,
                 frame_hw=None) -> tuple[float, str, dict]:
    """The least time the card could take for one launch. `runs` lists
    what the launch walks: (class, tables, bins, lo, hi), lo and hi None
    where the whole row counts. A slice passes its own rows of bins, lo
    and hi, whose first is tile `tile0`, and the frame's (height, width)
    as `frame_hw`. → (bound ms, "bytes" | "operations", {"entries": per
    class, "pixels": of their extents per class, "bytes": moved, "old_ms":
    the bound at 8192 pixels an entry, "busiest_tile_ms",
    "busiest_share"})."""
    entries, pixels = [0, 0, 0], [0, 0, 0]
    tile_flops = None   # per tile: the arithmetic its own bins rows cost
    seen, n_bytes = set(), out.numel() * out.element_size()
    height, width = frame_hw or (out.shape[0], out.shape[1])

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
                                   height, width, tile0)
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


def compose_bound(torch, K, blob, images, slabs, dyns, ops, out,
                  desc_bytes: int, row0: int = 0,
                  frame_h: int | None = None, *,
                  starts: slice) -> tuple[float, str, dict]:
    """The least time the card could take for one compose launch on these
    inputs (the frame blob, `starts` its slice of slab starts); of a slice
    from tile row `row0` (`out` its rows of a frame `frame_h` tall), for
    the rows it blends. → (bound ms, "bytes" | "operations", {"bytes",
    "layer_px": pixels blended from chrome layers, slab rows inside their
    y clip and pre-rendered tails, "entries": inline shape bin entries,
    "pixels": of their extents, "old_ms": the bound at 8192 pixels an
    entry})."""
    from whisper_git_tpu_torch.render import compose_kernel as CK

    width = out.shape[1]
    y0 = row0 * 64
    y1 = y0 + out.shape[0]
    height = frame_h or out.shape[0]
    starts_i = blob[starts]
    n_bytes = (out.numel() + starts_i.numel() * blob.element_size()
               + desc_bytes)
    px_i16 = px_f32 = entries = pixels = 0
    ys = torch.arange(y0, y1, dtype=torch.float32) + 0.5

    def rows_in(a, h):   # rows of [a, a + h) inside the slice
        return max(0, min(a + h, y1) - max(a, y0))

    for op in ops:
        if op[0] == "img":
            t = images[op[1]]
            px_i16 += rows_in(op[2] * 64, t.shape[0]) * t.shape[1]
        elif op[0] == "slab":
            slab, start = slabs[op[1]], int(starts_i[op[1]].item())
            sy = ys - 0.5 + start
            rows = ((ys >= op[2][1]) & (ys <= op[2][3]) & (sy >= 0)
                    & (sy < slab.shape[0]))
            px_i16 += int(rows.sum().item()) * min(slab.shape[1], width)
        elif op[0] == "dyni":
            tail = dyns.get((op[1], op[2]))
            if tail is None:
                continue
            # The kernel reads the tail's i16 tables and its slice's rows
            # of i16 bins from the blob.
            shapes, clips, bins, counts = CK.decode_tail(
                blob, tail, op[3], op[4], -(-height // 64))
            ts = op[4]
            rows = slice(row0 * ts, -(-y1 // 64) * ts)
            bins, counts = bins[rows], counts[rows]
            n_bytes += (shapes.numel() + clips.numel() + bins.numel()) \
                * blob.element_size()
            k = torch.arange(bins.shape[1], device=bins.device)[None, :]
            # The tail's tables and bins live in its sub-grid of tile
            # columns [c0, c0 + ts), and so do the extents.
            t_idx, n_px = entry_pixels(
                torch, K, 0, (shapes, clips), bins,
                (bins >= 0) & (k < counts[:, None]), ts, height,
                width - op[3] * 128, row0 * ts)
            entries += int(t_idx.numel())
            pixels += int(n_px.sum().item())
        else:
            t = dyns.get((op[1], op[2]))
            if t is not None:
                px_f32 += rows_in(0, t.shape[0]) * t.shape[1]
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


# Timing on the card, shared with whisper_git_tpu_torch/tools/kernel_times.py.

def event_ms(fn, runs: int) -> float:
    """Median of `runs` CUDA-event times around `fn`, after two calls."""
    import torch

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


def device_ms(fn, runs: int = 20, flush=None) -> tuple[float, float, float]:
    """→ (this repository's kernels alone, every device event of `fn`) ms a
    call, from the profiler's device times over `runs` calls, and the device
    events a call; with `flush`, a device buffer the size of several L2s,
    the L2 is overwritten before each call (not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a fresh profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        own = every = 0.0
        count = 0
        for e in device_events(prof):
            if "raster::" in e.key:
                own += e.self_device_time_total
            if flush is None or "raster::" in e.key:
                every += e.self_device_time_total
                count += e.count
        if own > 0:
            return own / runs / 1e3, every / runs / 1e3, count / runs
    fail("the profiler shows no device time for the kernel")


def host_us(fn, runs: int = 200, batches: int = 1) -> float:
    """The host's time to enqueue one call, in microseconds, the least of
    `batches` batches of `runs` calls with no synchronize between: what a
    short kernel's wrapper costs before the device has anything to do."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / runs * 1e6


def main(argv: list[str]) -> int:
    import torch

    only = None
    if argv:
        if argv != ["--only", "cards"]:
            fail(f"usage: chip_smoke.py [--only cards], not {argv}")
        only = "cards"

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
    installed = refuse_imports()
    log(f"device: {kind} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | python {sys.version.split()[0]} | "
        f"installed here, refused in this process: "
        f"{', '.join(installed) or 'none'} of "
        f"{', '.join(OPTIONAL_LIBRARIES)}")
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
    # Phases 1-16 on one card whatever the machine holds: without this the
    # first Renderer would install a mesh over every card (the auto mesh),
    # and so would the CLI, bench and soak processes, which inherit it.
    # Phase 17 unsets it where it drives the auto mesh.
    os.environ["WGIT_MESH"] = "0"
    refuse_network()
    try:
        kernels, by_card = run_phases(torch, card, kind, work, only)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for mod in sorted(sys.modules):
        if mod.partition(".")[0] in REFUSED:
            fail(f"{mod} was imported")
    print(json.dumps({"launches_by_card": by_card}), flush=True)
    print(card, flush=True)
    if only is not None:
        print(json.dumps({"ok": True, "only": only}), flush=True)
        return 0
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(torch, card: str, kind: str, work: str,
               only: str | None = None) -> tuple[list, dict]:
    """Phases 2-17 → the kernels line's rows and each card's launches
    ({card: {kernel: launches}}). With `only` "cards": the build, the
    history fixture and phase 17 alone (no kernels line)."""
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

    def k1_inputs(scene, atlas, font_tex=None):
        fused, meta, ty, tx, win_list = pack_scene(scene)
        wins = tuple(torch.from_numpy(b).to(dev) for _, _, b in win_list)
        layer_data, sig = unpack_layers(torch.from_numpy(fused).to(dev),
                                        wins, meta, ty * tx)
        return (layer_data, font if font_tex is None else font_tex, atlas,
                background(scene), ty, tx, sig, scene.height, scene.width)

    def k2_inputs(scene, atlas, bg="scene", font_tex=None):
        blob, chrome_args, win_args, meta = F.pack_frame(scene, dev)
        blocks = F.build_blocks(torch.from_numpy(blob).to(dev), chrome_args,
                                win_args, meta)
        return (blocks, font if font_tex is None else font_tex, atlas,
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
        ok = mx <= 1 if name == "K3" else within(kind_s, mx, share)
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

    # The history view's fixture (phases 4-17): the bench's repository
    # opened in the app, and the helpers that compile and take a path.
    repo = build_history_repo(work)
    app = open_app([repo])
    tab = app.current()
    if tab is None or len(tab.commits) < 200:
        fail("history fixture did not open")
    W, H = VIEWPORT
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

    def compile_at(off: float, size=VIEWPORT):
        tab.history_scroll = float(off)
        return compile_frame(app, renderer, *size)

    def k3_inputs(scene, atlas=None):
        """→ (blob, images, slabs, dyns), keywords (the starts' slice of
        the blob among them), blob bytes, the plan's descriptor rows."""
        atlas = image_atlas if atlas is None else atlas
        args, st = C.prepare_compose_dispatch(scene, font, atlas)
        starts, dyns, kops = C.frame_tails(
            args[0], font, atlas, st["height"], st["width"],
            st["tiles_y"], st["tiles_x"], st["meta"])
        kw = dict(starts=starts, ops=kops, tiles_y=st["tiles_y"],
                  tiles_x=st["tiles_x"], background=st["background"],
                  height=st["height"], width=st["width"])
        return ((args[0], tuple(args[1]), tuple(args[2]), dyns), kw,
                args[0].numel() * args[0].element_size(), st["rows"])

    helpers = SimpleNamespace(
        k1_inputs=k1_inputs, k2_inputs=k2_inputs, k3_inputs=k3_inputs,
        both=both, compare=compare, compare_k3=compare_k3, k3_both=k3_both,
        take_path=take_path, counts=counts, compile_at=compile_at)
    if only == "cards":
        freeze_pulse(1.0)
        launched, by_card = run_cards_phase(torch, card, work, repo,
                                            renderer, helpers)
        return [], by_card

    log(f"phase 3 starts at {time.perf_counter() - T_START:.1f} s")
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
    if [type(b).__name__ for b in blocks[0][0]] != \
            ["tuple", "WindowBlock", "tuple", "WindowBlock", "tuple",
             "TailBlock"]:
        fail("windows2 did not cut its chrome shapes into three segments "
             "around two windows, with a volatile tail")

    # K3 against its plain version on seeded op lists of every op kind.
    kinds_seen = set()
    for cw, ch in (COMPOSE_SYNTH_SIZE, COMPOSE_SYNTH_ODD):
        for case in COMPOSE_CASES:
            for seed in (0, 1):
                a = compose_args_to(synthetic_compose(case, seed, cw, ch),
                                    dev)
                pos = tuple(a.pop(k) for k in ("blob", "images", "slabs",
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
        pos = tuple(a.pop(k) for k in ("blob", "images", "slabs", "dyns"))
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

    log(f"phase 4 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 4. the slice end to end, three paths --------------------------------
    # The dirty dot pulses with the clock; pinned, two passes over the same
    # offsets compile the same scenes and their frames can be held equal.
    freeze_pulse(1.0)
    # The tails' bucket high-water marks are process state: the synthetic
    # scenes above left glyph and image tails behind, which every later
    # frame would carry empty (and compose would pre-render, one K2 launch
    # a frame). A fresh process on this view starts without them.
    F._DYN_HW.clear()
    F._WR_HW.clear()
    offsets = SCROLL_OFFSETS + SWEEP

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

    log(f"phase 5 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 5. the oversized path -------------------------------------------
    def k1_as_blocks(args):
        """K1's layer tables and bins as K2's blocks: a block a class the
        layer draws, every slot of its rows."""
        n_tiles = args[4] * args[5]
        layers = []
        for layer, sig in zip(args[0], args[6]):
            layers.append(tuple(
                [(tuple(layer[j] for j in F._CLS_TABLES[ci]), layer[7 + ci],
                  None, torch.full((n_tiles,), layer[7 + ci].shape[1],
                                   dtype=torch.int32, device=dev))]
                if sig[ci] else [] for ci in range(3)))
        return tuple(layers)

    OW, OH = OVERSIZED
    tab.history_scroll = 0.0
    big_scene = compile_frame(app, renderer, OW, OH)
    k1_calls = []
    real_tiles = P.render_tiles
    P.render_tiles = lambda *a: k1_calls.append(a) or real_tiles(*a)
    K.render_tiles.launches = 0
    B.render_tiles_blocks.launches = 0
    CK.compose_tiles.launches = 0
    try:
        big = render_scene_device(big_scene, font, image_atlas)
        torch.cuda.synchronize()
    finally:
        P.render_tiles = real_tiles
    big_launches = counts()
    if big_launches != (1, 0, 0) or len(k1_calls) != 1:
        fail(f"oversized frame: (K1, K2, K3) launches {big_launches}")
    slice_launches["K1"] += big_launches[0]   # K1's paths: packed, oversized
    if tuple(big.shape) != (OH, OW, 4) or big.dtype != torch.uint8 \
            or not bool((big[..., 3] == 255).all()):
        fail(f"oversized frame {tuple(big.shape)} {big.dtype}, or not opaque")
    big_args = k1_calls[0]
    k, p = both(K.render_tiles, K.render_tiles_plain, big_args)
    if not torch.equal(k, big):
        fail("oversized frame: K1 is not deterministic")
    compare("K1", f"history view at {OW}x{OH} (oversized path, "
            f"{big_args[4] * big_args[5]} tiles)", "history", k, p,
            (OH, OW, 4), torch.uint8)
    if not torch.equal(B.render_tiles_blocks(
            k1_as_blocks(big_args), font, image_atlas, big_args[3],
            big_args[4], big_args[5], OH, OW), big):
        fail("oversized frame: K2 over the same tables and bins differs")
    beyond = big[:, P.MAX_PACKED_PX + 1:, :3].int()
    if int((beyond - beyond[0, -1]).abs().max().item()) <= 8:
        fail("oversized frame: no ink beyond the i16 range")
    log(f"oversized: history view at {OW}x{OH} through render_scene_device, "
        f"(K1, K2, K3) launches {big_launches}, "
        f"{len(big_args[0])} layers over {big_args[4]}x{big_args[5]} tiles "
        "(bins widths " + ", ".join(
            f"{t[7].shape[1]}/{t[8].shape[1]}/{t[9].shape[1]}"
            for t in big_args[0])
        + "); torch.equal to K2 over the same tables and bins")

    log(f"phase 6 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 6. the CLI --------------------------------------------------------
    for cw, ch in (VIEWPORT, OVERSIZED):
        png = os.path.join(work, f"shot-{cw}x{ch}.png")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "whisper_git_tpu_torch", "--screenshot",
             png, "--size", f"{cw}x{ch}", "--repo", repo, "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail(f"CLI at {cw}x{ch} exited {res.returncode}: "
                 f"{res.stderr[-2000:]}")
        with open(png, "rb") as f:
            head = f.read(24)
        if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR" \
                or struct.unpack(">II", head[16:24]) != (cw, ch):
            fail(f"CLI wrote no {cw}x{ch} PNG")
        log(f"cli: {cw}x{ch} PNG, {os.path.getsize(png)} bytes, "
            f"{time.perf_counter() - t0:.2f} s")
    # --dump-bundles: the file names the reference's dump_all writes, read
    # from the code: every CLI screenshot state and every extra scene the
    # dump builds, each as .svg, .tree.txt and .lint.txt.
    import ast

    from whisper_git_tpu_torch.host.main import SCREENSHOT_STATES

    src = os.path.join(ROOT, "whisper_git_tpu_torch", "tools",
                       "dump_bundles.py")
    with open(src, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = list(SCREENSHOT_STATES) + [
        n.slice.value for n in ast.walk(tree)
        if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
        and n.value.id == "scenes" and isinstance(n.slice, ast.Constant)]
    want = sorted(f"{n}{ext}" for n in dict.fromkeys(names)
                  for ext in (".svg", ".tree.txt", ".lint.txt"))
    out_dir = os.path.join(work, "bundles")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "whisper_git_tpu_torch", "--dump-bundles",
         out_dir, "--device", "cuda"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    got = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if res.returncode != 0 or got != want \
            or f"wrote {len(want) // 3} scenes" not in res.stdout:
        fail(f"CLI --dump-bundles exited {res.returncode}, wrote "
             f"{len(got)} files for {len(want)} expected: "
             f"{sorted(set(want) ^ set(got))[:6]} {res.stderr[-2000:]}")
    log(f"cli: --dump-bundles wrote the {len(want)} files of "
        f"{len(want) // 3} scenes, {time.perf_counter() - t0:.2f} s")

    log(f"phase 7 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 7. timings --------------------------------------------------------
    scene0 = cached["scenes"][0.0]
    args1 = k1_inputs(scene0, image_atlas)
    args2 = k2_inputs(scene0, image_atlas)
    pos3, kw3, blob_bytes, rows3 = k3_inputs(composed["scenes"][0.0])
    from torch.profiler import ProfilerActivity, profile

    flush_buf = torch.empty(192 << 20, dtype=torch.uint8, device=dev)

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
        return [(ci, *block) for cls_lists in F.resolve_blocks(
                    layers_blocks, args2[4], args2[5])
                for ci in B.Z_ORDER for block in cls_lists[ci]]

    bound1 = kernel_bound(torch, K, [
        (ci, tuple(layer[j] for j in F._CLS_TABLES[ci]), layer[7 + ci],
         None, None)
        for layer, sig in zip(args1[0], args1[6])
        for ci in B.Z_ORDER if sig[ci]], out1, args1[5])
    bound2 = kernel_bound(torch, K, blocks_runs(args2[0]), out2, args2[5])
    desc3 = CK.op_descriptors(*pos3, kw3["ops"], kw3["tiles_y"],
                              pos3[0].device, rows3)[0]
    bound3 = compose_bound(torch, K, *pos3, kw3["ops"], out3, desc3.nbytes,
                           starts=kw3["starts"])
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

    log(f"timing [{card}]: K1 alone over K2 alone, the same frame in the "
        f"same call: {alone['K1'][0] / alone['K2'][0]:.4f} / "
        f"{alone['K1'][1] / alone['K2'][1]:.4f}; by events "
        f"{ms['K1'][0] / ms['K2'][0]:.4f} / {ms['K1'][1] / ms['K2'][1]:.4f}")

    # K1 at the oversized frame: by events, alone, against its bound; the
    # plain version; the frame end to end (host clock to a synchronize).
    def big_k1():
        return K.render_tiles(*big_args)

    big_ms = [event_ms(big_k1, 20) for _ in range(2)]
    big_alone = [device_ms(big_k1)[0] for _ in range(2)]
    big_plain = event_ms(lambda: K.render_tiles_plain(*big_args), 1)
    big_bound = kernel_bound(torch, K, [
        (ci, tuple(layer[j] for j in F._CLS_TABLES[ci]), layer[7 + ci],
         None, None)
        for layer, sig in zip(big_args[0], big_args[6])
        for ci in B.Z_ORDER if sig[ci]], big_k1(), big_args[5])
    big_frame = []
    for _ in range(3):
        t0 = time.perf_counter()
        render_scene_device(big_scene, font, image_atlas)
        torch.cuda.synchronize()
        big_frame.append((time.perf_counter() - t0) * 1e3)
    log(f"timing [{card}]: K1 at {OW}x{OH} (oversized path, "
        f"{big_args[4] * big_args[5]} tiles): {big_ms[0]:.4f} / "
        f"{big_ms[1]:.4f} ms by CUDA events around the wrapper, "
        f"{big_alone[0]:.4f} / {big_alone[1]:.4f} ms the kernel alone "
        f"(profiler), plain {big_plain:.4f} ms; bound {big_bound[0]:.6f} ms "
        f"by {big_bound[1]} ((shape, glyph, image) entries "
        f"{big_bound[2]['entries']} with {big_bound[2]['pixels']} pixels, "
        f"{big_bound[2]['bytes']} B; its busiest tile alone "
        f"{big_bound[2]['busiest_tile_ms']:.6f} ms of one SM); the frame "
        "through render_scene_device, compiled scene to a synchronize, "
        f"{', '.join(f'{t:.3f}' for t in big_frame)} ms")
    if min(min(big_ms), min(big_alone)) < big_bound[0]:
        fail("K1 at the oversized frame reads faster than its bound")

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

    # The splits, by measurement: the unit of a tile a K1 and a K2 CTA owns
    # (K1 at the history view and at the oversized frame, K2 at the history
    # view and at the slab of glyphs), the rows a K3 thread owns.
    glyph_slab = [a for a, _, _ in slab_builds
                  if [len(c) for c in a[0][0]].index(1) == 1]
    chosen1 = (K.STRIP_W, K.ROWS_PER_THREAD)
    chosen2 = (B.STRIP_W, B.ROWS_PER_THREAD)
    parts1, parts2 = [], []
    for strip, rows_pt in K.UNITS:
        K.STRIP_W, K.ROWS_PER_THREAD = strip, rows_pt
        B.STRIP_W, B.ROWS_PER_THREAD = strip, rows_pt
        t_hist = device_ms(lambda: K.render_tiles(*args1))[0]
        t_big = device_ms(lambda: K.render_tiles(*big_args))[0]
        parts1.append(f"{strip}x{4 * rows_pt} {t_hist:.4f} ms at the history "
                      f"view, {t_big:.4f} ms at {OW}x{OH}")
        t_hist = device_ms(lambda: B.render_tiles_blocks(*args2))[0]
        t_slab = (device_ms(lambda: B.render_tiles_blocks(
            *glyph_slab[0], layer_i16=True))[0] if glyph_slab
            else float("nan"))
        parts2.append(f"{strip}x{4 * rows_pt} {t_hist:.4f} ms at the history "
                      f"view, {t_slab:.4f} ms at the slab of glyphs")
    K.STRIP_W, K.ROWS_PER_THREAD = chosen1
    B.STRIP_W, B.ROWS_PER_THREAD = chosen2
    for name, chosen, parts in (("K1", chosen1, parts1),
                                ("K2", chosen2, parts2)):
        log(f"timing [{card}]: {name}'s unit of a tile (columns x rows a "
            f"CTA), the kernel alone (the port launches {chosen[0]}x"
            f"{4 * chosen[1]}): " + "; ".join(parts))
    chosen = CK.ROWS_PER_THREAD
    parts = []
    for rows_pt in (2, 4, 8):
        CK.ROWS_PER_THREAD = rows_pt

        def k3_call():
            return CK.compose_tiles(*pos3, **kw3, rows=rows3)

        parts.append(f"{2 * rows_pt} rows a CTA {device_ms(k3_call)[0]:.4f} "
                     f"ms, after a flush of the L2 "
                     f"{device_ms(k3_call, flush=flush_buf)[0]:.4f} ms")
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
        blob = torch.from_numpy(blob_host[id(scene)]).to(dev)
        starts, dyns, kops = C.frame_tails(
            blob, font, image_atlas, st["height"], st["width"],
            st["tiles_y"], st["tiles_x"], st["meta"])
        return (blob, tuple(args[1]), tuple(args[2]), dyns), dict(
            starts=starts, ops=kops, tiles_y=st["tiles_y"],
            tiles_x=st["tiles_x"], background=st["background"],
            height=st["height"], width=st["width"])

    n0 = counts()
    log(f"timing [{card}]: compose, stages alone, median of 20 steady "
        "frames: " + stages_alone((
            ("plan validation+pack_frame_blob",
             lambda scene, _: C.prepare_compose_dispatch(scene, font,
                                                         image_atlas)),
            ("upload+frame_tails", tails_step),
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
    # The same frames again with their blobs on the card: K3 reads each
    # blob itself, so a frame is K3's launch alone, no ATen kernel or copy.
    offs = COMPOSE_OFFSETS[-20:]
    for off in offs:
        render_scene_device(compile_at(off), font, image_atlas)
    torch.cuda.synchronize()
    for _ in range(3):   # a fresh profiler now and then records none
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for off in offs:
                render_scene_device(compile_at(off), font, image_atlas)
            torch.cuda.synchronize()
        steady = device_events(prof)
        if steady:
            break
    k3_n = sum(e.count for e in steady
               if "compose_tiles_kernel" in e.key)
    others = [f"{e.key[:60]} x{e.count}" for e in steady
              if "compose_tiles_kernel" not in e.key]
    log(f"profile [{card}]: compose, {len(offs)} steady frames with their "
        f"blobs on the card: {k3_n} compose_tiles_kernel launches; other "
        f"device events: {'; '.join(others) or 'none'}")
    if k3_n != len(offs) or others:
        fail("a steady composed frame runs more than compose_tiles_kernel "
             "on the card")
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

    log(f"phase 8-11 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 8-11. the presenter, the loop, the bench, word diff ------------
    run_host_phases(torch, card, work, repo, composed["frames"][0.0])

    log(f"phase 12-14 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 12-14. the EDT, the goldens, avatars -------------------------------
    asset_launches = run_asset_phases(torch, card, work, renderer, helpers)
    for name, n in asset_launches.items():
        slice_launches[name] += n

    log(f"phase 15 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 15. mesh -------------------------------------------------------------
    mesh_launches = run_mesh_phase(torch, card, renderer, helpers)
    for name, n in mesh_launches.items():
        slice_launches[name] += n

    log(f"phase 16 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 16. tools ------------------------------------------------------------
    run_tools_phase(torch, card, work, repo)

    log(f"phase 17 starts at {time.perf_counter() - T_START:.1f} s")
    # ---- 17. cards -------------------------------------------------------------
    # Phases 1-16 ran on the current card (WGIT_MESH=0): their launches
    # are card 0's.
    cards_launches, by_card = run_cards_phase(torch, card, work, repo,
                                              renderer, helpers)
    own = by_card.setdefault(str(torch.device("cuda", 0)),
                             dict.fromkeys(slice_launches, 0))
    for name, n in cards_launches.items():
        own[name] += slice_launches[name]
        slice_launches[name] += n
    log(f"phase 17 done, {time.perf_counter() - T_START:.1f} s")

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
    return kernels, by_card


def run_host_phases(torch, card: str, work: str, repo: str, frame) -> None:
    """Phases 8-11: the presenter, the interactive loop, the bench and the
    word diff on the card. `frame` is a composed history frame."""
    import io

    import numpy as np

    from whisper_git_tpu_torch.gitcore.diff import intra_line_highlight
    from whisper_git_tpu_torch.host import term_display as TD
    from whisper_git_tpu_torch.host.loop import run_loop
    from whisper_git_tpu_torch.host.main import open_app
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.ops import diffword
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import decode_png, get_renderer
    from whisper_git_tpu_torch.tools import ptydrive as PD

    dev = torch.device("cuda")
    W, H = VIEWPORT

    # ---- 8. present ---------------------------------------------------------
    gen = torch.Generator().manual_seed(0)
    frames = [frame] + [torch.randint(0, 256, (H, W, 4), generator=gen,
                                      dtype=torch.uint8).to(dev)
                        for _ in range(2)]
    sizes = ((78, 120), (96, 200), (60, 100), (450, 720), (H, W))
    worst = 0
    for i, f in enumerate(frames):
        for rows2, cols in sizes:
            got = TD._downsample(f, rows2, cols)
            want = TD._downsample(f.cpu(), rows2, cols)
            if tuple(got.shape) != (rows2, cols, 3) or not got.is_cuda:
                fail(f"_downsample on the card: {tuple(got.shape)} on "
                     f"{got.device}")
            mx = int((got.cpu().int() - want.int()).abs().max().item())
            worst = max(worst, mx)
            if mx > 1:
                fail(f"_downsample to {rows2}x{cols}: the card's grid {mx} "
                     "u8 from the CPU's")
    log(f"present: _downsample on the card within {worst} u8 of the CPU's "
        f"on {len(frames)} frames (the history view, two seeded) at "
        + ", ".join(f"{r}x{c}" for r, c in sizes))

    # TermDisplay fed CUDA frames through its pinned ring and present
    # thread, a slow present forcing the mailbox to drop; a resize
    # between two rounds reallocates the ring.
    shown = [torch.full((H, W, 4), 0, dtype=torch.uint8, device=dev)
             for _ in range(40)]
    for i, f in enumerate(shown):
        f[..., 0] = i * 6
        f[: (i + 1) * 20, :, 1] = 200
    presented = []

    def recording_fetch(item):
        grid = np.array(TD.TermDisplay._fetch(item))
        presented.append(grid)
        time.sleep(0.004)
        return grid

    display = TD.TermDisplay(VIEWPORT, out=io.StringIO())
    display._refresh_size = lambda: None
    display._fetch = recording_fetch
    rounds = []
    with display:
        for rows in (39, 30):
            display.rows, display.cols = rows, 120
            display._prev = None
            want = [TD._downsample(f, 2 * rows, 120).cpu().numpy()
                    for f in shown]
            n0 = len(presented)
            for f in shown:
                display.show(f)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not (
                    len(presented) > n0
                    and np.array_equal(presented[-1], want[-1])):
                time.sleep(0.01)
            got = presented[n0:]
            idx = []
            for g in got:
                hits = [i for i, w in enumerate(want)
                        if w.shape == g.shape and np.array_equal(w, g)]
                if not hits:
                    fail(f"present: a grid presented at {rows} rows is no "
                         "frame's downsample")
                idx.append(hits[0])
            if not idx or idx[-1] != len(shown) - 1 or idx != sorted(idx):
                fail(f"present: frames presented out of order or the last "
                     f"missing: {idx}")
            rounds.append((rows, len(idx), display._ring_shape))
        display.check()
    log("present: TermDisplay on CUDA frames through the pinned ring: "
        + "; ".join(f"{rows} rows, {n} of {len(shown)} presented (latest "
                    f"wins), ring {shape}" for rows, n, shape in rounds)
        + "; every presented grid its frame's downsample, the last frame "
        "presented")

    # ---- 9. loop --------------------------------------------------------------
    env = dict(os.environ)
    for var in ("WGIT_FRAME_DUMP", "WGIT_NO_INPUT", "WGIT_DEVICE"):
        env.pop(var, None)
    master, slave = PD.open_sized_pty(30, 100, 800, 480)
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "whisper_git_tpu_torch",
                             repo], stdin=slave, stdout=slave,
                            stderr=subprocess.PIPE, env=env, cwd=ROOT,
                            close_fds=True)
    os.close(slave)
    buf = bytearray()
    try:
        if not PD.wait_for(master, buf, PD.ALT_ENTER, 60):
            fail("loop: the CLI entered no alt screen")
        t_alt = time.monotonic() - t0
        if not PD.wait_for(master, buf, PD.HALF_BLOCK, 120):
            fail("loop: the CLI painted no frame")
        t_first = time.monotonic() - t0
        PD.drain(master, buf, 1.0)
        PD.drain_pending(master, buf)
        os.write(master, b"\x1b[<0;40;6M\x1b[<0;40;6m")   # click+release
        t_click = PD.wait_growth(master, buf, 8.0)
        if t_click is None:
            fail("loop: no repaint after a click")
        os.write(master, b"/")
        time.sleep(0.2)
        PD.drain_pending(master, buf)
        os.write(master, b"commit")
        t_search = PD.wait_growth(master, buf, 8.0)
        if t_search is None:
            fail("loop: no repaint after typing a search")
        for _ in range(8):   # the Escape ladder: search, selection, quit
            os.write(master, b"\x1b")
            PD.drain(master, buf, 0.35)
            if proc.poll() is not None:
                break
        end = time.monotonic() + 30
        while proc.poll() is None and time.monotonic() < end:
            PD.drain(master, buf, 0.25)
        if proc.poll() is None:
            fail("loop: the CLI did not exit after the Escape ladder")
        PD.drain(master, buf, 0.5)
        if proc.returncode != 0 or PD.ALT_EXIT not in buf:
            fail(f"loop: the CLI exited {proc.returncode} (terminal "
                 f"restored: {PD.ALT_EXIT in buf}): "
                 f"{proc.stderr.read()[-2000:].decode('utf-8', 'replace')}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        os.close(master)
    log(f"loop [{card}]: the CLI on a 100x30 pty: alt screen at "
        f"{t_alt:.3f} s, first half-block frame at {t_first:.3f} s after "
        f"the spawn; first repaint bytes {t_click * 1e3:.1f} ms after a "
        f"click and {t_search * 1e3:.1f} ms after typing a search (the "
        "dirty dot's pulse repaints every 0.15 s besides); the Escape "
        "ladder quit with rc 0, the terminal restored")

    # In this process: run_loop on the card, its dump held against
    # render_scene_device of the same state.
    dump = os.path.join(work, "loop-dump.png")
    os.environ["WGIT_NO_INPUT"] = "1"
    os.environ["WGIT_FRAME_DUMP"] = dump
    app = open_app([repo])
    composed = []
    real_composed = C.render_frame_composed

    def counting(*a, **k):
        out = real_composed(*a, **k)
        composed.append(out is not None)
        return out

    C.render_frame_composed = counting
    K.render_tiles.launches = 0
    B.render_tiles_blocks.launches = 0
    CK.compose_tiles.launches = 0
    try:
        rc = run_loop(app, max_frames=5)
        torch.cuda.synchronize()
    finally:
        C.render_frame_composed = real_composed
        del os.environ["WGIT_NO_INPUT"], os.environ["WGIT_FRAME_DUMP"]
    loop_launches = (K.render_tiles.launches, B.render_tiles_blocks.launches,
                     CK.compose_tiles.launches)
    n_composed = sum(composed)
    if rc != 0 or not n_composed or loop_launches[2] != n_composed \
            or loop_launches[0] != 0:
        fail(f"loop: run_loop returned {rc}; {n_composed} composed frames, "
             f"(K1, K2, K3) launches {loop_launches}")
    renderer = get_renderer("cuda")
    want = render_scene_device(
        compile_frame(app, renderer, int(app.config.window_width),
                      int(app.config.window_height)),
        renderer.font_tex_device(), renderer.image_atlas_device())
    with open(dump, "rb") as f:
        shown = decode_png(f.read())
    if shown is None:
        fail("loop: the frame dump is no PNG the port's decoder reads")
    got = torch.from_numpy(shown).to(dev)
    if not torch.equal(got, want):
        mx, _ = diff_stats(got, want)
        fail(f"loop: the frame dump is {mx} u8 from render_scene_device of "
             "the same state")
    log(f"loop: run_loop(app, max_frames=5) on the card: {len(composed)} "
        f"frames rendered, {n_composed} composed; (K1, K2, K3) launches "
        f"{loop_launches}; the dump torch.equal to render_scene_device of "
        "the same state")

    # ---- 10. bench ------------------------------------------------------------
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "whisper_git_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        fail(f"bench exited {res.returncode}: {res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    bench = json.loads(lines[-1]) if lines else {}
    rates = ("value", "median_fps", "device_fps", "presented_fps",
             "latency_p50_ms", "present_latency_p50_ms",
             "device_ms_per_frame", "oversized_ms", "rebuild_ms_max",
             "first_frame_present_s")
    for key in rates + ("vs_baseline", "device_busy_share",
                        "present_drop_rate", "rebuild_ms_p50",
                        "kernel_build_s", "kernels_built", "setup_s",
                        "iters_per_batch", "batches_fps", "device"):
        if bench.get(key) is None:
            fail(f"bench: no {key} in its line: {lines[-1:]}")
    bad = [k for k in rates if not bench[k] > 0]
    if bad or bench["metric"] != "history_view_frame_render" \
            or len(bench["batches_fps"]) != 12 \
            or bench["iters_per_batch"] != 80:
        fail(f"bench: non-positive {bad} or not the reference's counts: "
             f"{bench}")
    for line in res.stderr.strip().splitlines()[-4:]:
        log(f"bench: {line}")
    log(f"bench [{card}] ({time.perf_counter() - t0:.1f} s): {lines[-1]}")

    # ---- 11. diffword ---------------------------------------------------------
    import random

    rnd = random.Random(0)
    words = ["let", "x", "=", "5;", "héllo", "wörld", "日本語", "🙂", "",
             "a" * 70, "é" * 40, "fn", "return"]
    olds, news = [], []
    for _ in range(300):
        old = " ".join(rnd.choice(words) for _ in range(rnd.randrange(9)))
        parts = old.split(" ")
        parts.insert(rnd.randrange(len(parts) + 1), rnd.choice(words))
        olds.append(old)
        news.append(" ".join(parts))
    got = diffword.batched_highlights(olds, news, device="cuda")
    want = diffword.batched_highlights(olds, news, device="cpu")
    if got != want or got != [intra_line_highlight(o, n)
                              for o, n in zip(olds, news)]:
        fail("diffword: the card's ranges differ from the CPU's or the "
             "scalar highlight's")
    log(f"diffword: {len(olds)} seeded pairs on the card equal to the CPU's "
        "and to intra_line_highlight")


# Helpers of the mesh phases (15 and 17).

def volatile_image_scene(renderer, _off):
    """A 512x320 scene (5 tile rows, padded to 8 over 8 shards: 3 pad
    rows) holding a volatile image, so compose pre-renders a "dyn" tail
    for K3."""
    import numpy as np

    from whisper_git_tpu_torch.ui import image, rect, row, spacer, stack
    from whisper_git_tpu_torch.ui.theme import DARK

    tile = np.zeros((16, 16, 4), np.uint8)
    tile[:, :, 0] = 220
    tile[:, :, 3] = 255
    ui = stack(rect(width="fill", height="fill", fill=DARK.background),
               row(spacer(300), image(tile, width=16, height=16,
                                      volatile=True),
                   width="fill", height=60),
               width="fill", height="fill")
    root = renderer.layout(ui, (512, 320))
    return renderer.compile(root, (512, 320), DARK.background)


def pad_bins(torch, layer_data, T: int, T_pad: int) -> tuple:
    """K1's layer tables with their bins padded from T to T_pad rows of
    -1 (tiles past the frame: the bare background)."""
    return tuple(tuple(t if i < 7 else torch.cat(
        [t, torch.full((T_pad - T, t.shape[1]), -1, dtype=t.dtype,
                       device=t.device)]) for i, t in enumerate(layer))
        for layer in layer_data)


def assemble_tiles(K, t, ty: int, tx: int, H: int, W: int):
    """K1's f32 canvas of the frame's first ty * tx tiles → the quantized
    (H, W, 4) u8 frame, as one launch without a slice writes it."""
    img = t[:ty * tx].reshape(ty, tx, 64, 128, 4).permute(0, 2, 1, 3, 4)
    return K.quantize_u8(img.reshape(ty * 64, tx * 128, 4)[:H, :W])


def stack_frames(torch, frames, T: int, T_pad: int) -> tuple:
    """K1's inputs of several frames (`k1_inputs`' tuples) as
    `render_batch_sharded` takes them: each table with a leading frame
    axis, zero rows past a frame's own, bins padded to T_pad tiles with
    -1; → (batched layer data, the layers' joint signature)."""
    dev = frames[0][1].device
    n_layers = max(len(f[6]) for f in frames)
    sig = tuple(tuple(any(f[6][li][c] for f in frames if li < len(f[6]))
                      for c in range(3)) for li in range(n_layers))

    def stacked(li, i):
        ts = [f[0][li][i] if li < len(f[0]) else None for f in frames]
        if i >= 7:
            k = max([t.shape[1] for t in ts if t is not None] + [1])
            out = torch.full((len(ts), T_pad, k), -1, dtype=torch.int32,
                             device=dev)
            for b, t in enumerate(ts):
                if t is not None:
                    out[b, :T, :t.shape[1]] = t
            return out
        cols = (16, 4, 8, 4, 4, 8, 4)[i]
        n = max([t.shape[0] for t in ts if t is not None] + [1])
        out = torch.zeros((len(ts), n, cols), device=dev)
        for b, t in enumerate(ts):
            if t is not None:
                out[b, :t.shape[0]] = t
        return out

    return tuple(tuple(stacked(li, i) for i in range(10))
                 for li in range(n_layers)), sig



# The mesh phase: three steady scroll frames, and meshes of one card given
# several times (dp, sp).
MESH_OFFSETS = (0.0, 16.0, 32.0)
MESH_SHAPES = ((1, 4), (2, 4))
MESH_TIMED_OFFSETS = tuple(float(o) for o in range(0, 120, 6))   # 20 frames


def run_mesh_phase(torch, card: str, renderer, h) -> dict:
    """Phase 15: the mesh paths on the card (`parallel/mesh.py`, the mesh
    branches of `render/frame.py` and `render/compose.py`), the port's
    counterpart of the reference's `dryrun_multichip`. `h` holds
    run_phases' helpers. → each kernel's launches on the mesh's frame
    paths and the batched sweep."""
    from whisper_git_tpu_torch.parallel import mesh as PM
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render.meshstate import set_render_mesh
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.tools.fixtures import steady_window_scene

    dev = renderer.device
    font = renderer.font_tex_device()
    W, H = VIEWPORT
    launched = {"K1": 0, "K2": 0, "K3": 0}
    meshes = {f"{dp}x{sp}": PM.make_mesh(dp * sp, dp=dp,
                                         devices=[dev] * (dp * sp))
              for dp, sp in MESH_SHAPES}

    def zero():
        K.render_tiles.launches = 0
        B.render_tiles_blocks.launches = 0
        CK.compose_tiles.launches = 0

    def slices(tiles_y, mesh):
        """(row0, rows) of each shard of `mesh` over `tiles_y` rows."""
        _, ty_pad = F._sharded_tile_rows(tiles_y, 1, mesh)
        rows = ty_pad // mesh.size
        return [(s * rows, rows) for s in range(mesh.size)]

    def holding(tiles_y, mesh, rect=None):
        """Shards whose slice holds a row of the frame (of `rect`)."""
        lo, hi = (0, tiles_y) if rect is None else (rect[0], rect[2])
        return sum(1 for r0, n in slices(tiles_y, mesh)
                   if max(r0, lo) < min(r0 + n, hi, tiles_y))

    # K2's launches a layer build or frame under a mesh: one a shard that
    # holds a row of the output; every sharded K2 call is noted.
    want_k2 = []
    real_sharded = F._render_tiles_blocks_sharded

    def noting(*a, **k):
        mesh = a[8] if len(a) > 8 else k["mesh"]
        want_k2.append(holding(a[4], mesh, k.get("tile_rect")))
        return real_sharded(*a, **k)

    def volatile_scene(off):
        return volatile_image_scene(renderer, off)

    scene_sets = (
        (f"steady window {W}x{H}", lambda off: steady_window_scene(
            renderer, off, (W, H)), ("compose", "cache")),
        (f"history view {W}x{H}", h.compile_at, ("compose", "cache")),
        ("volatile image 512x320", volatile_scene, ("compose",)),
    )
    F._render_tiles_blocks_sharded = noting
    try:
        for label, make, levels in scene_sets:
            scenes = [make(off) for off in MESH_OFFSETS]
            ty = -(-scenes[0].height // 64)
            for level in levels:
                h.take_path(level)
                set_render_mesh(None)
                F.clear_caches()
                C.clear_caches()
                atlas = renderer.image_atlas_device()
                singles = [render_scene_device(sc, font, atlas)
                           for sc in scenes]
                for name, mesh in meshes.items():
                    # The caches hold rendered layers keyed without the
                    # mesh: a mesh pass after a single-device one would
                    # reuse its layers and certify nothing.
                    F.clear_caches()
                    C.clear_caches()
                    del want_k2[:]
                    set_render_mesh(mesh)
                    zero()
                    try:
                        got = [render_scene_device(sc, font, atlas)
                               for sc in scenes]
                        torch.cuda.synchronize()
                    finally:
                        set_render_mesh(None)
                    n = h.counts()
                    for kname, k in zip(("K1", "K2", "K3"), n):
                        launched[kname] += k
                    for off, a, b in zip(MESH_OFFSETS, singles, got):
                        if not torch.equal(a, b):
                            mx, _ = diff_stats(a, b)
                            fail(f"mesh {name}: {label} {level} at offset "
                                 f"{off:g} is {mx:g} u8 from the "
                                 "single-device frame")
                    rows_k3 = holding(ty, mesh) * len(scenes)
                    want = (0, sum(want_k2), rows_k3 if level == "compose"
                            else 0)
                    if level == "cache" and sum(want_k2) != \
                            holding(ty, mesh) * len(scenes):
                        fail(f"mesh {name}: {label}: the frame cache made "
                             f"{len(want_k2)} sharded K2 calls")
                    if n != want:
                        fail(f"mesh {name}: {label} {level}: (K1, K2, K3) "
                             f"launches {n}, expected {want}")
                    log(f"mesh {name} ({mesh.size} x {mesh.flat[0]}): "
                        f"{label}, "
                        f"{level}, {len(scenes)} frames torch.equal to one "
                        f"device's; {ty} tile rows, {holding(ty, mesh)} "
                        f"shards hold one; launches (K1, K2, K3) {n}: K2 "
                        f"on {len(want_k2)} sharded calls, a shard each "
                        "that holds a row of the output")
    finally:
        F._render_tiles_blocks_sharded = real_sharded
        set_render_mesh(None)
        h.take_path("compose")

    # Each sliced kernel against its plain version on the same slice, and
    # the slices put together against the whole launch.
    hist = h.compile_at(0.0)
    atlas = renderer.image_atlas_device()
    ty, tx = -(-H // 64), -(-W // 128)
    mesh8 = meshes["2x4"]
    args2 = h.k2_inputs(hist, atlas)
    whole2 = B.render_tiles_blocks(*args2)
    parts = []
    for r0, n in slices(ty, mesh8):
        k, p = h.both(
            lambda *a, r0=r0, n=n: B.render_tiles_blocks(
                *a, n_tiles=n * tx, tile0=r0 * tx),
            lambda *a, r0=r0, n=n: B.render_tiles_blocks_plain(
                *a, n_tiles=n * tx, tile0=r0 * tx), args2)
        rows = max(0, min((r0 + n) * 64, H) - r0 * 64)
        h.compare("K2", f"history view rows [{r0}, {r0 + n}) of {ty}",
                  "glyphs", k, p, (rows, W, 4), torch.uint8)
        parts.append(k)
    if not torch.equal(torch.cat(parts), whole2):
        fail("K2's slices put together are not the whole frame")
    layer_args = h.k2_inputs(hist, atlas, bg=None)
    for kw in ({}, {"layer_i16": True},
               {"layer_i16": True, "tile_rect": (3, 2, ty, tx)}):
        whole = B.render_tiles_blocks(*layer_args, **kw)
        got = torch.cat([B.render_tiles_blocks(
            *layer_args, n_tiles=n * tx, tile0=r0 * tx, **kw)
            for r0, n in slices(ty, mesh8)])
        p = B.render_tiles_blocks_plain(*layer_args, n_tiles=2 * tx,
                                        tile0=4 * tx, **kw)
        k = B.render_tiles_blocks(*layer_args, n_tiles=2 * tx, tile0=4 * tx,
                                  **kw)
        if not torch.equal(got, whole):
            fail(f"K2 {kw}: the slices put together are not the whole")
        if kw.get("layer_i16"):
            d = int((k.int() - p.int()).abs().max().item())
            if d > 1:
                fail(f"K2 {kw} on a slice: {d} counts from the plain version")
        else:
            h.compare("K2", "history view f32 layer rows [4, 6)", "glyphs",
                      k, p, (128, W, 4), torch.float32)
    log(f"mesh: K2 on every slice of the {mesh8.size}-shard mesh over {ty} "
        "tile rows (pad rows among them) against its plain version, and "
        "the slices put together torch.equal to the whole, in the u8, f32, "
        "i16 and tile-rect modes")

    for label, scene in (("history view", hist),
                         ("volatile image", volatile_scene(0.0))):
        C.clear_caches()
        pos, kw, _, rows3 = h.k3_inputs(scene, renderer.image_atlas_device())
        if label == "volatile image" and "dyn" not in {op[0] for op in
                                                      kw["ops"]}:
            fail(f"the volatile image composes {kw['ops']}: no dyn tail")
        whole = CK.compose_tiles(*pos, **kw, rows=rows3)
        for mesh in meshes.values():
            parts = []
            for r0, n in slices(kw["tiles_y"], mesh):
                k, p = h.k3_both(pos, dict(kw, n_rows=n, row0=r0))
                rows = max(0, min((r0 + n) * 64, kw["height"]) - r0 * 64)
                h.compare_k3(f"{label} rows [{r0}, {r0 + n}) of "
                             f"{kw['tiles_y']}", k, p, (rows, kw["width"], 4))
                parts.append(k)
            if not torch.equal(torch.cat(parts), whole):
                fail(f"K3 {label}: the slices put together are not the "
                     "whole frame")
    log("mesh: K3 on every slice of both meshes (pad rows; the volatile "
        "image's pre-rendered dyn tail) against its plain version, the "
        "slices put together torch.equal to the whole")

    # K1 on slices of tiles, as the batched sweep runs it.
    args1 = h.k1_inputs(hist, atlas)
    T = ty * tx
    sp = mesh8.shape["sp"]
    T_pad = -(-T // sp) * sp
    padded = pad_bins(torch, args1[0], T, T_pad)
    local = T_pad // sp
    tiles = []
    for j in range(sp):
        k, p = h.both(
            lambda *a, j=j: K.render_tiles(*a, n_tiles=local,
                                           tile0=j * local),
            lambda *a, j=j: K.render_tiles_plain(*a, n_tiles=local,
                                                 tile0=j * local),
            (padded,) + tuple(args1[1:]))
        h.compare("K1", f"history view tiles [{j * local}, "
                  f"{(j + 1) * local}) of {T} (+{T_pad - T} pad)", "glyphs",
                  k, p, (local, 64, 128, 4), torch.float32)
        tiles.append(k)
    whole1 = K.render_tiles(*args1)

    def assemble(t):
        return assemble_tiles(K, t, ty, tx, H, W)

    if not torch.equal(assemble(torch.cat(tiles)), whole1):
        fail("K1's slices, quantized, are not the whole frame")

    # The batched dp x sp sweep: 4 frames over the 2 x 4 mesh.
    frames = [h.k1_inputs(h.compile_at(off), atlas)
              for off in (0.0, 16.0, 32.0, 48.0)]
    batched, sig = stack_frames(torch, frames, T, T_pad)
    zero()
    batch = PM.render_batch_sharded(batched, font, atlas, args1[3], ty, tx,
                                    sig, mesh8)
    torch.cuda.synchronize()
    n = h.counts()
    launched["K1"] += n[0]
    if n != (len(frames) * sp, 0, 0) or tuple(batch.shape) != (
            len(frames), T_pad, 64, 128, 4):
        fail(f"render_batch_sharded: launches {n}, {tuple(batch.shape)}")
    for b, f in enumerate(frames):
        if not torch.equal(assemble(batch[b]), K.render_tiles(*f)):
            fail(f"render_batch_sharded: frame {b} is not K1's frame")
    log(f"mesh: render_batch_sharded, B = {len(frames)} history frames on "
        f"the 2 x 4 mesh ({n[0]} K1 launches, a frame a shard of its dp "
        "group): each frame torch.equal to one K1 launch without a slice; "
        "K1 on 4 tile slices against its plain version")

    # Each sliced launch timed by events beside the whole launch, and the
    # slice's bound over its own entries and bytes.
    mesh4 = meshes["1x4"]
    (r0, n4), = slices(ty, mesh4)[:1]
    rows = slice(r0 * tx, (r0 + n4) * tx)

    def runs2(layers_blocks, rows):
        return [(ci, tables, bins[rows], None if lo is None else lo[rows],
                 hi[rows]) for cls_lists in F.resolve_blocks(
                     layers_blocks, args2[4], args2[5])
                for ci in B.Z_ORDER
                for tables, bins, lo, hi in cls_lists[ci]]

    def runs1(layer_data, sig_, rows):
        return [(ci, tuple(layer[j] for j in F._CLS_TABLES[ci]),
                 layer[7 + ci][rows], None, None)
                for layer, s in zip(layer_data, sig_)
                for ci in B.Z_ORDER if s[ci]]

    C.clear_caches()
    pos, kw, _, rows3 = h.k3_inputs(hist, atlas)
    sl2 = B.render_tiles_blocks(*args2, n_tiles=n4 * tx, tile0=r0 * tx)
    sl3 = CK.compose_tiles(*pos, **kw, rows=rows3, n_rows=n4, row0=r0)
    sl1 = K.render_tiles(padded, *args1[1:], n_tiles=local, tile0=0)
    desc = CK.op_descriptors(*pos, kw["ops"], kw["tiles_y"], pos[0].device,
                             rows3)[0]
    cases = (
        ("K1", lambda: K.render_tiles(*args1),
         kernel_bound(torch, K, runs1(args1[0], args1[6], slice(0, T)),
                      whole1, tx)),
        (f"K1 tiles [0, {local})",
         lambda: K.render_tiles(padded, *args1[1:], n_tiles=local, tile0=0),
         kernel_bound(torch, K, runs1(padded, args1[6], slice(0, local)),
                      sl1, tx, 0, (H, W))),
        ("K2", lambda: B.render_tiles_blocks(*args2),
         kernel_bound(torch, K, runs2(args2[0], slice(0, T)), whole2, tx)),
        (f"K2 rows [{r0}, {r0 + n4})",
         lambda: B.render_tiles_blocks(*args2, n_tiles=n4 * tx,
                                       tile0=r0 * tx),
         kernel_bound(torch, K, runs2(args2[0], rows), sl2, tx, rows.start,
                      (H, W))),
        ("K3", lambda: CK.compose_tiles(*pos, **kw, rows=rows3),
         compose_bound(torch, K, *pos, kw["ops"],
                       CK.compose_tiles(*pos, **kw, rows=rows3),
                       desc.nbytes, starts=kw["starts"])),
        (f"K3 rows [{r0}, {r0 + n4})",
         lambda: CK.compose_tiles(*pos, **kw, rows=rows3, n_rows=n4,
                                  row0=r0),
         compose_bound(torch, K, *pos, kw["ops"], sl3, desc.nbytes, r0, H,
                       starts=kw["starts"])))
    # The kernel alone from a cold L2, as the bound's bytes come from device
    # memory: 38 MB of K3's layers fit in the 50 MB L2, and back-to-back
    # launches would read them from there.
    flush = torch.empty(192 << 20, dtype=torch.uint8, device=dev)
    for name, fn, bound in cases:
        ev, alone = [], []
        for _ in range(2):
            ev.append(event_ms(fn, TIMED_KERNEL_RUNS))
            alone.append(device_ms(fn, flush=flush)[0])
        log(f"mesh timing [{card}]: {name}: {ev[0]:.4f} / {ev[1]:.4f} ms by "
            f"CUDA events around the wrapper (median of "
            f"{TIMED_KERNEL_RUNS}), {alone[0]:.4f} / {alone[1]:.4f} ms the "
            f"kernel alone after a flush of the L2 (profiler); bound "
            f"{bound[0]:.6f} ms by {bound[1]} "
            f"({bound[2]['bytes']} B"
            + (f", bin entries {bound[2]['entries']}" if "K3" not in name
               else f", {bound[2]['layer_px']} layer pixels")
            + ")")
        if min(ev + alone) < bound[0]:
            fail(f"{name} reads faster than its bound")

    # The frame under a 4-shard mesh of this card against one device, in
    # this call: compose, the history view, host clock to a synchronize.
    def frame_ms(mesh):
        set_render_mesh(mesh)
        try:
            F.clear_caches()
            C.clear_caches()
            scenes = [h.compile_at(off) for off in MESH_TIMED_OFFSETS]
            for sc in scenes:                       # warm: plans and layers
                render_scene_device(sc, font, atlas)
            torch.cuda.synchronize()
            out = []
            for sc in scenes:
                t0 = time.perf_counter()
                render_scene_device(sc, font, atlas)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(out)
        finally:
            set_render_mesh(None)

    turns = [(name, m) for name, m in (("one device", None),
                                       ("1x4", meshes["1x4"]),
                                       ("2x4", meshes["2x4"]))]
    fms = {name: [] for name, _ in turns}
    for _ in range(2):
        for name, m in turns:
            fms[name].append(frame_ms(m))
    log(f"mesh timing [{card}]: the history view's steady composed frame "
        f"(render_scene_device to a synchronize, median of "
        f"{len(MESH_TIMED_OFFSETS)} warm frames, two turns): "
        + "; ".join(f"{name} {v[0]:.3f} / {v[1]:.3f} ms"
                    for name, v in fms.items())
        + " (on one card a mesh launches K3 once a shard for the same "
        "pixels)")

    return launched


# Phase 17: the render mesh over the machine's real cards, as a user's
# process takes it (WGIT_MESH unset).
CARDS_TIMED_OFFSETS = MESH_TIMED_OFFSETS       # 20 steady frames
CARDS_REBUILD_FRAMES = 50                      # a compose scroll, 0-400 px
CARDS_BATCH_OFFSETS = (0.0, 16.0, 32.0, 48.0)  # render_batch_sharded's B


def run_cards_phase(torch, card: str, work: str, repo: str, renderer,
                    h) -> tuple[dict, dict]:
    """Phase 17: the render mesh over several real cards. On one card it
    logs "not run (1 card)" and passes. `h` holds run_phases' helpers;
    `renderer` is phase 4's, on card 0 with no mesh. → (each kernel's
    launches on this phase's mesh paths, {card: {kernel: launches}} of
    them)."""
    n = torch.cuda.device_count()
    launched = {"K1": 0, "K2": 0, "K3": 0}
    by_card: dict = {}
    if n < 2:
        log(f"cards: not run ({n} card)")
        return launched, by_card

    from torch.profiler import ProfilerActivity, profile

    from whisper_git_tpu_torch.bench import card_device_us
    from whisper_git_tpu_torch.parallel import mesh as PM
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render.meshstate import (get_render_mesh,
                                                        set_render_mesh)
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import Renderer
    from whisper_git_tpu_torch.tools import ptydrive as PD

    t_phase = time.perf_counter()
    cards = [torch.device("cuda", i) for i in range(n)]
    names = [str(c) for c in cards]
    W, H = VIEWPORT
    ty, tx = -(-H // 64), -(-W // 128)
    font = renderer.font_tex_device()
    atlas = renderer.image_atlas_device()
    wrappers = {"K1": K.render_tiles, "K2": B.render_tiles_blocks,
                "K3": CK.compose_tiles}
    tag = f"[{card}, {n} cards]"

    def zero():
        for w in wrappers.values():
            w.launches = 0
            w.launches_on.clear()

    def per_card() -> list:
        """(K1, K2, K3) launched on each card since `zero()`."""
        return [tuple(w.launches_on.get(i, 0) for w in wrappers.values())
                for i in range(n)]

    def tally():
        for name, w in wrappers.items():
            launched[name] += w.launches
            for i, k in w.launches_on.items():
                by_card.setdefault(names[i], dict.fromkeys(wrappers, 0))[
                    name] += k

    def sync_all():
        for c in cards:
            torch.cuda.synchronize(c)

    def clear():
        # The layer caches key without the mesh, and the tails' high-water
        # marks are process state: each pass starts from nothing.
        F.clear_caches()
        C.clear_caches()
        F._DYN_HW.clear()
        F._WR_HW.clear()

    def shard_rows(tiles_y, mesh) -> list:
        _, ty_pad = F._sharded_tile_rows(tiles_y, 1, mesh)
        rows = ty_pad // mesh.size
        return [(s * rows, rows) for s in range(mesh.size)]

    def holders(tiles_y, mesh, rect=None) -> list:
        """The card indices of the shards whose slice of tile rows holds a
        row of the frame (of `rect`)."""
        lo, hi = (0, tiles_y) if rect is None else (rect[0], rect[2])
        return [mesh.flat[s].index
                for s, (r0, k) in enumerate(shard_rows(tiles_y, mesh))
                if max(r0, lo) < min(r0 + k, hi, tiles_y)]

    def render(scene):
        return render_scene_device(scene, font, atlas)

    # ---- each kernel on each card, and its first launch there --------------
    # Before anything else runs on cards 1..n-1: the inputs are copied
    # there first (the card's context and allocator), then each kernel's
    # first launch (its module loaded on that card) and a second one are
    # timed to a synchronize of the card.
    hist = h.compile_at(0.0)
    full = PM.make_mesh(n, devices=cards)
    args1 = h.k1_inputs(hist, atlas)
    args2 = h.k2_inputs(hist, atlas)
    C.clear_caches()
    pos, kw, _, _ = h.k3_inputs(hist, atlas)
    T = ty * tx
    T_pad = -(-T // n) * n
    padded = pad_bins(torch, args1[0], T, T_pad)
    local = T_pad // n
    first_ms = {}
    parts = {"K1": [], "K2": [], "K3": []}
    for k in list(range(1, n)) + [0]:
        dev = cards[k]
        a1 = F.replicate((padded,) + tuple(args1[1:]), dev)
        a2 = F.replicate(args2, dev)
        p3 = F.replicate(pos, dev)
        torch.cuda.synchronize(dev)
        r0, nr = shard_rows(ty, full)[k]
        px = max(0, min((r0 + nr) * 64, H) - r0 * 64)
        sl1 = dict(n_tiles=local, tile0=k * local)
        sl2 = dict(n_tiles=nr * tx, tile0=r0 * tx)
        sl3 = dict(kw, n_rows=nr, row0=r0)
        calls = {
            "K1": (lambda: K.render_tiles(*a1, **sl1),
                   lambda: K.render_tiles_plain(*a1, **sl1),
                   (local, 64, 128, 4), torch.float32),
            "K2": (lambda: B.render_tiles_blocks(*a2, **sl2),
                   lambda: B.render_tiles_blocks_plain(*a2, **sl2),
                   (px, W, 4), torch.uint8),
            "K3": (lambda: CK.compose_tiles(*p3, **sl3),
                   lambda: CK.compose_tiles_plain(*p3, **sl3),
                   (px, W, 4), torch.uint8)}
        for name, (kern, plain, shape, dtype) in calls.items():
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                out = kern()
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            first_ms[(names[k], name)] = times
            if out.device != dev:
                fail(f"cards: {name} on {dev} wrote its output on "
                     f"{out.device}")
            want = plain()
            label = (f"on {dev}, tiles [{k * local}, {(k + 1) * local})"
                     if name == "K1" else
                     f"on {dev}, rows [{r0}, {r0 + nr}) of {ty}")
            if name == "K3":
                h.compare_k3(f"history view {label}", out, want, shape)
            else:
                h.compare(name, f"history view {label}", "glyphs", out,
                          want, shape, dtype)
            parts[name].append((k, out))
    joined = {name: torch.cat([t.to(cards[0]) for _, t in sorted(p)])
              for name, p in parts.items()}
    if not torch.equal(assemble_tiles(K, joined["K1"], ty, tx, H, W),
                       K.render_tiles(*args1)) \
            or not torch.equal(joined["K2"], B.render_tiles_blocks(*args2)) \
            or not torch.equal(joined["K3"],
                               CK.compose_tiles(*pos, **kw)):
        fail("cards: the slices of the cards put together are not the "
             "whole frame of one card")
    log(f"cards: K1, K2 and K3 on a slice of the history view on each of "
        f"{n} cards against their plain versions on that card, the "
        "slices put together torch.equal to one card's whole frame")
    log(f"cards timing {tag}: each kernel's first launch on a card and the "
        "next one (host clock to a synchronize of that card, ms; cuda:0's "
        "modules were loaded in phase 3): " + "; ".join(
            f"{c} " + ", ".join(f"{name} {first_ms[(c, name)][0]:.3f} / "
                                f"{first_ms[(c, name)][1]:.3f}"
                                for name in wrappers) for c in names))

    # ---- the auto mesh ---------------------------------------------------------
    os.environ.pop("WGIT_MESH", None)
    try:
        Renderer("cuda")
        auto = get_render_mesh()
        if auto is None or auto.shape != {"dp": 1, "sp": n} \
                or auto.flat != tuple(cards):
            fail(f"cards: Renderer('cuda') with WGIT_MESH unset installed "
                 f"{auto}, not (1, {n}) over {names}")
        Renderer("cuda:1")
        got = get_render_mesh()
        if got.flat != tuple(cards[1:] + cards[:1]):
            fail(f"cards: Renderer('cuda:1') installed {got}")
        if n >= 4:
            os.environ["WGIT_MESH"] = "2"
            Renderer("cuda")
            got = get_render_mesh()
            if got is None or got.flat != tuple(cards[:2]):
                fail(f"cards: WGIT_MESH=2 installed {got}")
    finally:
        os.environ["WGIT_MESH"] = "0"
        set_render_mesh(None)
    log(f"cards: Renderer('cuda') with WGIT_MESH unset installed {auto}; "
        "Renderer('cuda:1') the same cards from cuda:1"
        + ("; WGIT_MESH=2 (1, 2) over cuda:0, cuda:1" if n >= 4 else ""))

    # ---- every frame equal to one card's -----------------------------------
    noted = []   # the cards each sharded K2 call should launch on
    real_sharded = F._render_tiles_blocks_sharded

    def noting(*a, **k):
        mesh = a[8] if len(a) > 8 else k["mesh"]
        noted.append(holders(a[4], mesh, k.get("tile_rect")))
        return real_sharded(*a, **k)

    def drive(level, scenes, mesh):
        """One pass from empty caches → the frames, and a row a frame:
        (launches on each card, plans built, the noted sharded K2
        calls)."""
        h.take_path(level)
        clear()
        set_render_mesh(mesh)
        zero()
        frames, rows, plans = [], [], {}
        try:
            for sc in scenes:
                before = per_card()
                del noted[:]
                frames.append(render(sc))
                after = per_card()
                built = [p for p in C._PLAN_CACHE.values()
                         if id(p) not in plans]
                plans.update((id(p), p) for p in built)
                rows.append(([tuple(b - a for a, b in zip(x, y))
                              for x, y in zip(before, after)], len(built),
                             list(noted)))
            sync_all()
        finally:
            set_render_mesh(None)
        return frames, rows

    def check(label, level, scenes, ty_, plan_only):
        singles, _ = drive(level, scenes, None)
        got, rows = drive(level, scenes, auto)
        tally()
        hold = holders(ty_, auto)
        for i, (a, b) in enumerate(zip(singles, got)):
            if b.device != a.device or not torch.equal(a, b):
                mx, _ = diff_stats(a, b.to(a.device))
                fail(f"cards: {label} {level}, frame {i}: {mx:g} u8 from "
                     f"one card's (on {b.device})")
        n_k2 = n_built = 0
        for i, (pc, built, calls) in enumerate(rows):
            want_k2 = [0] * n
            for c in calls:
                for idx in c:
                    want_k2[idx] += 1
            for idx in range(n):
                want = (0, want_k2[idx],
                        int(level == "compose" and idx in hold))
                if pc[idx] != want:
                    fail(f"cards: {label} {level}, frame {i}: (K1, K2, K3) "
                         f"on {names[idx]} {pc[idx]}, expected {want}")
            if level == "cache" and len(calls) != 1:
                fail(f"cards: {label}: a frame-cache frame made "
                     f"{len(calls)} sharded K2 calls")
            if plan_only and calls and not built:
                fail(f"cards: {label} frame {i}: K2 launched without a "
                     "plan build")
            n_k2 += sum(want_k2)
            n_built += built
        log(f"cards: {label}, {level}: {len(scenes)} frames under the auto "
            f"mesh torch.equal to one card's; K3 once a frame on each of "
            f"{len(hold)} cards that hold a frame row"
            if level == "compose" else
            f"cards: {label}, {level}: {len(scenes)} frames under the auto "
            f"mesh torch.equal to one card's; K2 once a frame on each of "
            f"{len(hold)} cards that hold a frame row")
        log(f"cards: {label}, {level}: {n_built} plans built, {n_k2} K2 "
            "launches over the cards, each where a sharded call's rows "
            "lie" + (", none without a plan build" if plan_only else ""))

    int_scenes = [h.compile_at(off) for off in COMPOSE_OFFSETS]
    sweep_scenes = [h.compile_at(off) for off in SWEEP]
    F._render_tiles_blocks_sharded = noting
    try:
        check(f"history view {W}x{H}", "compose", int_scenes, ty, True)
        check(f"history view {W}x{H}", "cache", int_scenes + sweep_scenes,
              ty, False)
        check("volatile image 512x320", "compose",
              [volatile_image_scene(renderer, off) for off in MESH_OFFSETS],
              5, False)
    finally:
        F._render_tiles_blocks_sharded = real_sharded
        h.take_path("compose")

    # The packed and the oversized path stay on one card under a mesh.
    OW, OH = OVERSIZED
    for label, scene, level in (
            (f"packed {W}x{H}", hist, "packed"),
            (f"oversized {OW}x{OH}", h.compile_at(0.0, OVERSIZED),
             "compose")):
        h.take_path(level)
        clear()
        one = render(scene)
        clear()
        set_render_mesh(auto)
        zero()
        try:
            got = render(scene)
            sync_all()
        finally:
            set_render_mesh(None)
            h.take_path("compose")
        pc = per_card()
        tally()
        if pc[0] != (1, 0, 0) or any(map(any, pc[1:])) \
                or got.device != cards[0] \
                or not torch.equal(one, got):
            fail(f"cards: {label} under the auto mesh: (K1, K2, K3) by card "
                 f"{pc}, on {got.device}, equal to one card's: "
                 f"{torch.equal(one, got.to(one.device))}")
        log(f"cards: {label} under the auto mesh: one K1 launch, on "
            f"{names[0]}, no launch on another card; torch.equal to one "
            "card's")

    # ---- render_batch_sharded over real cards ---------------------------------
    frames = [h.k1_inputs(h.compile_at(off), atlas)
              for off in CARDS_BATCH_OFFSETS]
    batched, sig = stack_frames(torch, frames, T, T_pad)
    wants = [K.render_tiles(*f) for f in frames]
    for dp in ((1, 2) if n % 2 == 0 else (1,)):
        mesh = PM.make_mesh(n, dp=dp, devices=cards)
        zero()
        batch = PM.render_batch_sharded(batched, font, atlas, args1[3], ty,
                                        tx, sig, mesh)
        sync_all()
        pc = per_card()
        tally()
        each = len(frames) // dp
        if pc != [(each, 0, 0)] * n or batch.device != cards[0]:
            fail(f"render_batch_sharded over {mesh}: (K1, K2, K3) by card "
                 f"{pc}, on {batch.device}")
        for b, want in enumerate(wants):
            if not torch.equal(assemble_tiles(K, batch[b], ty, tx, H, W),
                               want):
                fail(f"render_batch_sharded over {mesh}: frame {b} is not "
                     "one K1 launch's frame on one card")
        log(f"cards: render_batch_sharded, B = {len(frames)} history frames "
            f"over {dp} x {n // dp} cards: {each} K1 launches on each card, "
            "every frame torch.equal to one K1 launch on one card")

    # ---- bytes between cards ----------------------------------------------------
    timed = [h.compile_at(off) for off in CARDS_TIMED_OFFSETS]
    real_move = F.move
    copied = []

    def recording(t, device, kind):
        out = real_move(t, device, kind)
        if out is not t:
            copied.append((kind, t.data_ptr()))
        return out

    def moved_mb(scale=1.0):
        return ", ".join(f"{k} {v / scale / 1e6:.4f} MB"
                         for k, v in F.MOVED.items())

    F.move = recording
    try:
        for level in ("compose", "cache"):
            h.take_path(level)
            clear()
            set_render_mesh(auto)
            for k in F.MOVED:
                F.MOVED[k] = 0
            render(timed[0])
            sync_all()
            first = moved_mb()
            for sc in timed[1:]:
                render(sc)
            sync_all()
            plans = set(map(id, C._PLAN_CACHE.values()))
            for k in F.MOVED:
                F.MOVED[k] = 0
            del copied[:]
            for sc in timed:
                render(sc)
            sync_all()
            if set(map(id, C._PLAN_CACHE.values())) != plans:
                fail(f"cards: {level}: a warm frame built a plan")
            kept = {font.data_ptr(): "the font texture",
                    atlas.data_ptr(): "the image atlas"}
            kept.update((v[0].data_ptr(), "a cached chrome group")
                        for v in C._GROUP_CACHE.values())
            kept.update((v["img"].data_ptr(), "a cached slab")
                        for v in C._SLAB_CACHE.values())
            for e in F._CHROME_CACHE.values():
                for t in (*e["parts"], *e["bins"], *e["segs"]):
                    if isinstance(t, torch.Tensor):
                        kept[t.data_ptr()] = "a cached chrome table"
            bad = sorted({kept[p] for _, p in copied if p in kept})
            if bad or F.MOVED["layers"]:
                fail(f"cards: a steady {level} frame copied {bad} between "
                     f"cards ({moved_mb(len(timed))} a frame)")
            log(f"cards: bytes between cards {tag}, {level}: the first "
                f"frame from empty caches (a plan build) {first}; a steady "
                f"frame {moved_mb(len(timed))} ({len(copied)} copies over "
                f"{len(timed)} frames), no atlas and no cached layer or "
                "table")
    finally:
        F.move = real_move
        set_render_mesh(None)
        h.take_path("compose")

    # ---- overlap: a profiler trace over every card --------------------------
    h.take_path("compose")
    clear()
    set_render_mesh(auto)
    try:
        for sc in timed:
            render(sc)
        sync_all()
        for _ in range(3):   # a fresh profiler now and then records none
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for sc in timed:
                    render(sc)
                sync_all()
                wall_us = (time.perf_counter() - t0) * 1e6
            events = prof.events()
            dev_us = card_device_us(events, names)
            if sum(dev_us.values()) > 0:
                break
        else:
            fail("cards: the profiler shows no device time")
    finally:
        set_render_mesh(None)
    k3 = [(e.device_index, e.time_range.start, e.time_range.end)
          for e in events if "CUDA" in str(getattr(e, "device_type", ""))
          and "compose_tiles" in e.name]
    overlapping = sum(1 for d, a, b in k3
                      if any(d2 != d and a2 < b and a < b2
                             for d2, a2, b2 in k3))
    log(f"cards: profile {tag}, {len(timed)} steady composed frames under "
        "the auto mesh: device time a frame by card " + ", ".join(
            f"{c} {us / len(timed) / 1e3:.4f} ms (busy {us / wall_us:.4f})"
            for c, us in dev_us.items())
        + f"; {len(k3)} K3 launches, {overlapping} of them overlapping in "
        "time a K3 launch on another card")

    # ---- frame times, one card against the meshes, two turns ----------------
    two = PM.make_mesh(2, devices=cards[:2])
    configs = [("one card", None), (f"auto 1x{n}", auto)]
    if n > 2:
        configs.append(("2 cards", two))
    rebuild = [h.compile_at(float(int(i * 400 / CARDS_REBUILD_FRAMES)))
               for i in range(CARDS_REBUILD_FRAMES)]

    def steady_ms(level, mesh):
        h.take_path(level)
        clear()
        set_render_mesh(mesh)
        try:
            for sc in timed:
                render(sc)
            sync_all()
            out = []
            for sc in timed:
                t0 = time.perf_counter()
                render(sc)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
                # The synchronize of the current card covers the frame:
                # the gather made it wait for every other card.
                idle = [torch.cuda.current_stream(c).query() for c in cards]
                if not all(idle):
                    fail(f"cards: a frame synchronized on {names[0]} left "
                         f"work on {[c for c, i in zip(names, idle) if not i]}")
            return statistics.median(out)
        finally:
            set_render_mesh(None)
            h.take_path("compose")

    def worst_rebuild_ms(mesh):
        clear()
        set_render_mesh(mesh)
        plans, worst = {}, 0.0
        try:
            for i, sc in enumerate(rebuild):
                t0 = time.perf_counter()
                render(sc)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                built = [p for p in C._PLAN_CACHE.values()
                         if id(p) not in plans]
                plans.update((id(p), p) for p in built)
                if built and i > 0:
                    worst = max(worst, ms)
            return worst
        finally:
            set_render_mesh(None)

    times = {name: {"compose": [], "cache": [], "rebuild": []}
             for name, _ in configs}
    for _ in range(2):
        for name, mesh in configs:
            times[name]["compose"].append(steady_ms("compose", mesh))
            times[name]["cache"].append(steady_ms("cache", mesh))
            times[name]["rebuild"].append(worst_rebuild_ms(mesh))
    for what, text in (("compose", "steady composed frame"),
                       ("cache", "steady frame-cache frame"),
                       ("rebuild", "worst plan-rebuild frame of a compose "
                                   f"scroll over {CARDS_REBUILD_FRAMES} "
                                   "offsets from empty caches")):
        log(f"cards timing {tag}: the history view's {text} (render to a "
            "synchronize, ms, "
            + ("median of 20 warm frames, " if what != "rebuild" else "")
            + "two turns): " + "; ".join(
                f"{name} {v[what][0]:.3f} / {v[what][1]:.3f}"
                for name, v in times.items()))

    # ---- the CLI, the app and the bench under the auto mesh -----------------
    # A repository with nothing uncommitted: its dirty dot would pulse with
    # the clock, and two processes' screenshots could not be held equal.
    clean = os.path.join(work, "cards-repo")
    shutil.copytree(repo, clean, symlinks=True)
    os.remove(os.path.join(clean, "dirty.txt"))
    env_auto = {k: v for k, v in os.environ.items()
                if k not in ("WGIT_MESH", "WGIT_FRAME_DUMP", "WGIT_NO_INPUT",
                             "WGIT_DEVICE")}
    shots = {}
    for name, env in (("auto", env_auto), ("off", dict(env_auto,
                                                       WGIT_MESH="0"))):
        png = os.path.join(work, f"cards-{name}.png")
        shots[name] = (png, subprocess.Popen(
            [sys.executable, "-m", "whisper_git_tpu_torch", "--screenshot",
             png, "--size", f"{W}x{H}", "--repo", clean, "--device",
             "cuda"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        t_first = run_app_to_first_frame(PD, clean, env_auto)
        pngs = {}
        for name, (png, p) in shots.items():
            _, err = p.communicate(timeout=600)
            if p.returncode != 0:
                fail(f"cards: --screenshot with WGIT_MESH {name} exited "
                     f"{p.returncode}: {err[-2000:]}")
            with open(png, "rb") as f:
                pngs[name] = f.read()
    finally:
        for _, p in shots.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    if pngs["auto"] != pngs["off"]:
        fail("cards: the --screenshot under the auto mesh differs from "
             "WGIT_MESH=0's")
    log(f"cards: --screenshot {W}x{H} with WGIT_MESH unset byte-equal to "
        f"WGIT_MESH=0's ({len(pngs['auto'])} bytes); the app on a pty under "
        f"the auto mesh: first frame {t_first:.3f} s after the spawn, the "
        "Escape ladder quit with rc 0, the terminal restored")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "whisper_git_tpu_torch.bench",
                          "--iters", "40", "--batches", "3"], cwd=ROOT,
                         env=env_auto, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        fail(f"cards: the bench under the auto mesh exited "
             f"{res.returncode}: {res.stderr[-3000:]}")
    row = json.loads(res.stdout.strip().splitlines()[-1])
    by_ms = row.get("device_ms_per_frame_by_card") or {}
    by_busy = row.get("device_busy_share_by_card") or {}
    if row.get("mesh") != names or row.get("device_count") != n \
            or set(by_ms) != set(names) or set(by_busy) != set(names) \
            or not all(0 <= v <= 1 for v in by_busy.values()) \
            or not by_busy[names[0]] > 0 \
            or not row.get("value", 0) > 0:
        fail(f"cards: the bench under the auto mesh: {row}")
    log(f"cards: bench {tag} under the auto mesh "
        f"({time.perf_counter() - t0:.1f} s): {res.stdout.strip()}")
    log(f"cards: phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launched, by_card


def run_app_to_first_frame(PD, repo: str, env: dict) -> float:
    """The app (`python -m whisper_git_tpu_torch <repo>`) on a 100x30 pty
    under `env`: its first half-block frame, then the Escape ladder, which
    must quit it with rc 0 and the terminal restored. → seconds from the
    spawn to the first frame."""
    t0 = time.monotonic()
    master, slave = PD.open_sized_pty(30, 100, 800, 480)
    proc = subprocess.Popen([sys.executable, "-m", "whisper_git_tpu_torch",
                             repo], stdin=slave, stdout=slave,
                            stderr=subprocess.PIPE, env=env, cwd=ROOT,
                            close_fds=True)
    os.close(slave)
    buf = bytearray()
    try:
        if not PD.wait_for(master, buf, PD.ALT_ENTER, 60) \
                or not PD.wait_for(master, buf, PD.HALF_BLOCK, 120):
            fail("the app painted no frame")
        t_first = time.monotonic() - t0
        PD.drain(master, buf, 0.5)
        for _ in range(8):   # the Escape ladder quits
            os.write(master, b"\x1b")
            PD.drain(master, buf, 0.35)
            if proc.poll() is not None:
                break
        end = time.monotonic() + 30
        while proc.poll() is None and time.monotonic() < end:
            PD.drain(master, buf, 0.25)
        PD.drain(master, buf, 0.3)
        if proc.returncode != 0 or PD.ALT_EXIT not in buf:
            fail(f"the app exited {proc.returncode} (terminal restored: "
                 f"{PD.ALT_EXIT in buf}): "
                 f"{proc.stderr.read()[-2000:].decode('utf-8', 'replace')}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
        os.close(master)
    return t_first


def run_tools_phase(torch, card: str, work: str, repo: str) -> None:
    """Phase 16: the port's tools on the card: the vector smoke, the
    compose probe (`tools/kernel_times.py compose` on the history
    repository `repo`) and a 15 s soak of the CLI on a pty."""
    from whisper_git_tpu_torch.tools import vector_smoke

    t0 = time.perf_counter()
    res = vector_smoke.run(os.path.join(work, "vector_smoke.png"), "cuda")
    if res["max_diff_per_row_vs_single"] > 2 \
            or res["max_diff_overlap_vs_single"] > 2:
        fail(f"vector smoke: seams {res}")
    log(f"tools: vector_smoke on the card: per row vs single "
        f"{res['max_diff_per_row_vs_single']} u8, overlap vs single "
        f"{res['max_diff_overlap_vs_single']} u8 (gate 2), "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    probe = subprocess.run(
        [sys.executable, os.path.join(ROOT, "whisper_git_tpu_torch", "tools",
                                      "kernel_times.py"), "compose",
         "--repo", repo],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        fail(f"kernel_times.py compose exited {probe.returncode}: "
             f"{probe.stderr[-3000:]}")
    variants = [json.loads(line) for line in probe.stdout.splitlines()
                if line.startswith("{")]
    if [v["variant"] for v in variants] != ["none", "imgs", "slabs", "dyn",
                                            "all"]:
        fail(f"kernel_times.py compose printed {probe.stdout[-2000:]}")
    log(f"tools: compose probe [{card}] (kernel_times.py compose, "
        f"{time.perf_counter() - t0:.1f} s): K3 by op kind, events / alone "
        "ms: " + "; ".join(f"{v['variant']} ({len(v['ops'])} ops) "
                           f"{v['events_ms']:.4f} / {v['alone_ms']:.4f}"
                           for v in variants))

    t0 = time.perf_counter()
    out = os.path.join(work, "soak")
    soak = subprocess.run(
        [sys.executable, "-m", "whisper_git_tpu_torch.tools.soak", "--secs",
         "15", "--out", out], cwd=ROOT, capture_output=True, text=True,
        timeout=400)
    try:
        with open(os.path.join(out, "soak.json")) as f:
            result = json.load(f)
    except (OSError, ValueError):
        result = {}
    if soak.returncode != 0 or not result.get("ok"):
        fail(f"soak exited {soak.returncode}: {result.get('notes')} "
             f"{soak.stdout[-1500:]} {soak.stderr[-1500:]} "
             f"{result.get('stderr_tail', '')[-1500:]}")
    if sorted(os.listdir(out)) != ["soak.json"]:
        fail(f"the soak left {os.listdir(out)} under --out")
    log(f"tools: soak [{card}] 15 s on the card's pty "
        f"({time.perf_counter() - t0:.1f} s in all): first frame "
        f"{result['first_frame_s']} s, {result['interactions']} "
        f"interactions, repaint p50 {result['repaint_p50_ms']} ms, p95 "
        f"{result['repaint_p95_ms']} ms, device frames "
        f"{result['device_frames']}, degraded {result['degraded_frames']}, "
        f"RSS {result['rss_mb_series']} MB, host thread max gap "
        f"{result['host_thread_max_gap_s']} s, frame loop max gap "
        f"{result['app_loop_max_gap_s']} s; notes {result['notes']}")


OPTIONAL_LIBRARIES = ("PIL", "fontTools", "matplotlib")
REFUSED = ("jax", "jaxlib", "whisper_git_tpu") + OPTIONAL_LIBRARIES


class _Refuse:
    """A meta path finder under which every import of REFUSED raises."""

    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in REFUSED:
            raise ImportError(f"chip_smoke refuses {name}")
        return None


def refuse_imports() -> list:
    """Refuse JAX, the JAX package, Pillow, fontTools and matplotlib in
    this process, so that it runs as on a machine without them whatever
    this one has installed (the bank finds no chain font and the avatar
    decode no Pillow). → those of Pillow, fontTools and matplotlib that
    are installed here."""
    import importlib.util

    installed = [m for m in OPTIONAL_LIBRARIES
                 if importlib.util.find_spec(m) is not None]
    sys.meta_path.insert(0, _Refuse())
    return installed


def refuse_network() -> None:
    """Make every connection from this process to another host raise, as
    it would on a machine without a network: the smoke needs none, and the
    avatar of a corrupt cache file must fail its fetch here."""
    import socket

    local = ("localhost", "127.0.0.1", "::1")
    real_getaddrinfo = socket.getaddrinfo
    real_connect, real_connect_ex = socket.socket.connect, \
        socket.socket.connect_ex

    def getaddrinfo(host, *a, **k):
        if host is not None and host not in local:
            raise socket.gaierror(socket.EAI_NONAME,
                                  f"chip_smoke: no network ({host})")
        return real_getaddrinfo(host, *a, **k)

    def check(sock, address):
        if sock.family in (socket.AF_INET, socket.AF_INET6) \
                and address[0] not in local:
            raise OSError(f"chip_smoke: no network ({address[0]})")

    def connect(sock, address):
        check(sock, address)
        return real_connect(sock, address)

    def connect_ex(sock, address):
        check(sock, address)
        return real_connect_ex(sock, address)

    socket.getaddrinfo = getaddrinfo
    socket.socket.connect = connect
    socket.socket.connect_ex = connect_ex


def run_asset_phases(torch, card: str, work: str, renderer, h) -> dict:
    """Phases 12-14: the EDT on the card, the nine golden scenes (the
    `fallback` one through the fallback bank on the stored DejaVu masks),
    and the history view with avatars from a primed disk cache. `h` holds
    run_phases' helpers. → each kernel's launches on those paths."""
    import numpy as np

    from whisper_git_tpu_torch.host.main import open_app
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.ops import sdf as SDF
    from whisper_git_tpu_torch.ops.sdf import (sdf_to_u8,
                                               signed_distance_field_batch)
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render.atlas import (OVERSAMPLE, SPREAD,
                                                    encode_sdf_cells,
                                                    rasterize_glyph_cell)
    from whisper_git_tpu_torch.render.fallback import _ENSURE_BATCH
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import decode_png
    from whisper_git_tpu_torch.services.avatar import AvatarState
    from whisper_git_tpu_torch.tools import avatar_fixture as AF
    from whisper_git_tpu_torch.tools import goldens as G
    from whisper_git_tpu_torch.tools.mask_font import (load_mask_fonts,
                                                       pin_mask_bank)
    from whisper_git_tpu_torch.ui.theme import DARK

    dev = renderer.device
    launched = {"K1": 0, "K2": 0, "K3": 0}

    def zero():
        K.render_tiles.launches = 0
        B.render_tiles_blocks.launches = 0
        CK.compose_tiles.launches = 0

    def drive(scene, font, atlas, path):
        """One frame of `scene` through `path`, the counts zeroed just
        before and read just after. → (frame, (K1, K2, K3) launches)."""
        h.take_path(path)
        zero()
        img = render_scene_device(scene, font, atlas)
        torch.cuda.synchronize()
        n = h.counts()
        h.take_path("compose")
        for name, k in zip(("K1", "K2", "K3"), n):
            launched[name] += k
        want = {"packed": lambda k: k[0] == 1 and k[1] == k[2] == 0,
                "cache": lambda k: k[1] == 1 and k[0] == k[2] == 0,
                "compose": lambda k: k[2] == 1 and k[0] == 0}[path]
        if not want(n) or tuple(img.shape) != (scene.height, scene.width,
                                               4) \
                or img.dtype != torch.uint8 or img.device.type != dev.type:
            fail(f"{path}: (K1, K2, K3) launches {n}, frame "
                 f"{tuple(img.shape)} {img.dtype} on {img.device}")
        return img, n

    def record_uploads(method: str, version) -> list:
        """Wrap `renderer.<method>` (a device copy it uploads again when
        `version()` moves) to log (tensor, version) at each new upload."""
        uploads = []
        real = getattr(renderer, method)

        def recording():
            t = real()
            if not uploads or uploads[-1][0] is not t:
                uploads.append((t, version()))
            return t

        setattr(renderer, method, recording)
        return uploads

    def max_diff(a, b) -> tuple:
        d = (a.int() - b.int()).abs()
        return int(d.max().item()), int(d.gt(2).sum().item())

    # ---- 12. edt --------------------------------------------------------------
    rng = np.random.default_rng(0)
    os_cell = 128
    yy, xx = np.mgrid[0:os_cell, 0:os_cell]
    seeded = []
    for i in range(16):
        cov = np.zeros((os_cell, os_cell), np.float32)
        for _ in range(1 + i % 4):      # discs and boxes of seeded size
            cy, cx = rng.uniform(10, 118, 2)
            r = rng.uniform(3, 30)
            cov = np.maximum(cov, np.clip(r - np.hypot(yy - cy, xx - cx),
                                          0.0, 1.0))
            y0, x0 = rng.integers(0, 100, 2)
            cov[y0:y0 + rng.integers(2, 28), x0:x0 + rng.integers(2, 28)] = 1
        if i % 5 == 4:
            cov = (rng.random((os_cell, os_cell)) < 0.05).astype(np.float32)
        seeded.append(cov)
    fonts = load_mask_fonts()
    pad = int(SPREAD * OVERSAMPLE)
    base_row = pad + int(round(renderer.regular.ascent * OVERSAMPLE))
    masks = [rasterize_glyph_cell(f.pil, chr(cp),
                                  lambda y0, f=f: base_row + (y0 - f.ascent))[0]
             for f in fonts.values() for cp in sorted(f.cmap)]
    cov_all = np.stack(seeded + masks)
    got = encode_sdf_cells(cov_all, dev)
    want = encode_sdf_cells(cov_all, "cpu")
    sdf_dev = signed_distance_field_batch(torch.from_numpy(cov_all).to(dev),
                                          SPREAD * OVERSAMPLE)
    sdf_cpu = signed_distance_field_batch(torch.from_numpy(cov_all),
                                          SPREAD * OVERSAMPLE)
    if got.shape != want.shape or not np.array_equal(got, want) \
            or not torch.equal(sdf_dev.cpu(), sdf_cpu):
        fail(f"edt: the card's cells differ from the CPU's in "
             f"{int((got != want).sum())} u8 values")
    log(f"edt: {len(seeded)} seeded coverages and {len(masks)} DejaVu mask "
        f"cells at {os_cell}x{os_cell} through encode_sdf_cells on the card: "
        "the u8 cells byte-equal to the CPU's, the f32 distances "
        "torch.equal")
    # The bank's batch: the regular face's glyphs, padded with empty cells
    # to _ENSURE_BATCH.
    n_reg = len(fonts["regular"].cmap)
    batch = np.zeros((_ENSURE_BATCH, os_cell, os_cell), np.float32)
    batch[:n_reg] = masks[:n_reg]
    batch_dev = torch.from_numpy(batch).to(dev)

    def host_ms(fn, runs):
        fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    edt_host = host_ms(lambda: encode_sdf_cells(batch, dev), 20)
    edt_dev = event_ms(lambda: sdf_to_u8(signed_distance_field_batch(
        batch_dev, SPREAD * OVERSAMPLE) / OVERSAMPLE, SPREAD), 20)
    edt_cpu = host_ms(lambda: encode_sdf_cells(batch, "cpu"), 5)
    # The design choice of ops/sdf.py: the batch as it runs (a cell's two
    # transforms in one pass, in chunks bounded for the device), against a
    # pass over the whole batch for each transform, in turns.
    cov = {"card": batch_dev, "cpu": torch.from_numpy(batch)}

    def as_run(x):
        return signed_distance_field_batch(x, SPREAD * OVERSAMPLE)

    def a_pass_each(x):
        inside = x > 0.5
        return torch.where(inside, -(SDF._edt(~inside) - 0.5),
                           SDF._edt(inside) - 0.5).clamp(
                               -SPREAD * OVERSAMPLE, SPREAD * OVERSAMPLE)

    order = (a_pass_each, as_run, as_run, a_pass_each)
    on_card = [event_ms(lambda f=f: f(cov["card"]), 20) for f in order]
    on_cpu = [host_ms(lambda f=f: f(cov["cpu"]), 5) for f in order]
    if not torch.equal(as_run(cov["cpu"]), a_pass_each(cov["cpu"])):
        fail("edt: the two forms of the batch differ")
    log(f"edt [{card}]: the batch's signed distances as ops/sdf.py runs "
        f"them / a pass per transform over the batch, in turns: on the card "
        f"{on_card[1]:.3f}, {on_card[2]:.3f} / {on_card[0]:.3f}, "
        f"{on_card[3]:.3f} ms (CUDA events, median of 20); on the CPU "
        f"{on_cpu[1]:.3f}, {on_cpu[2]:.3f} / {on_cpu[0]:.3f}, "
        f"{on_cpu[3]:.3f} ms (host clock, median of 5)")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            encode_sdf_cells(batch, dev)
    edt_events = device_events(prof)
    edt_top = sorted(edt_events, key=lambda e: -e.self_device_time_total)[:4]
    log(f"edt [{card}]: where a batch's device time goes (profiler, 5 "
        f"batches): {sum(e.count for e in edt_events) / 5:.1f} device "
        f"events, {sum(e.self_device_time_total for e in edt_events) / 5e3:.3f}"
        " ms a batch; top (us a batch, count): " + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 5:.1f} x"
            f"{e.count // 5}" for e in edt_top))
    log(f"edt [{card}]: a bank batch of {n_reg} glyphs padded to "
        f"{_ENSURE_BATCH} cells at "
        f"{os_cell}x{os_cell}: encode_sdf_cells on the card {edt_host:.3f} ms "
        f"(host clock, upload to u8 cells on the host, median of 20), the "
        f"EDT and the encode on the device {edt_dev:.3f} ms (CUDA events, "
        f"median of 20); on this machine's CPU ({torch.get_num_threads()} "
        f"threads) {edt_cpu:.3f} ms (host clock, median of 5)")

    # ---- 13. goldens ----------------------------------------------------------
    maxima = {}
    for name in G.SCENES:
        with open(os.path.join(G.golden_dir(), f"{name}.png"), "rb") as f:
            golden = decode_png(f.read())
        if golden is None:
            fail(f"goldens: {name}.png is no PNG the port's decoder reads")
        golden = torch.from_numpy(golden).to(dev)
        restore = pin_mask_bank(renderer)
        bank = renderer.fallback_bank
        uploads = record_uploads("font_tex_device", lambda: bank.version)
        try:
            root = renderer.layout(G.SCENES[name](), (float(G.SIZE[0]),
                                                      float(G.SIZE[1])))
            scene = renderer.compile(root, G.SIZE, DARK.background)
            atlas = renderer.image_atlas_device()
            frames = {}
            for path in (("compose", "cache", "packed") if name == "fallback"
                         else ("compose",)):
                frames[path], n = drive(scene, renderer.font_tex_device(),
                                        atlas, path)
                mx, over = max_diff(frames[path], golden)
                maxima[(name, path)] = (mx, over)
                log(f"goldens: {name} through {path}, (K1, K2, K3) launches "
                    f"{n}: max {mx} u8 from the golden, {over} values over 2")
                if mx > G.TOLERANCE:
                    fail(f"goldens: {name} through {path} is {mx} u8 from "
                         f"its golden, {over} values over {G.TOLERANCE}")
            if name != "fallback":
                continue
            if not torch.equal(frames["cache"], frames["packed"]):
                fail("goldens: fallback: the frame cache's frame differs "
                     "from the packed path's")
            mx, _ = max_diff(frames["compose"], frames["packed"])
            if mx > 1:
                fail(f"goldens: fallback: composed {mx} u8 from packed")
            resident = renderer.font_tex.shape
            want_rows = resident[0] + bank.texture.shape[0]
            font = renderer.font_tex_device()
            if not bank.used or bank.missing or len(bank.metrics) < 12 \
                    or tuple(font.shape) != (want_rows, resident[1]):
                fail(f"goldens: the bank holds {len(bank.metrics)} glyphs, "
                     f"misses {len(bank.missing)}, font texture "
                     f"{tuple(font.shape)}")
            k, p = h.both(K.render_tiles, K.render_tiles_plain,
                          h.k1_inputs(scene, atlas, font_tex=font))
            h.compare("K1", "fallback golden (bank glyphs)", "glyphs", k, p,
                      (scene.height, scene.width, 4), torch.uint8)
            k, p = h.both(B.render_tiles_blocks, B.render_tiles_blocks_plain,
                          h.k2_inputs(scene, atlas, font_tex=font))
            h.compare("K2", "fallback golden (bank glyphs)", "glyphs", k, p,
                      (scene.height, scene.width, 4), torch.uint8)
            # One more glyph: the bank's version moves, the texture goes up
            # once more at the same size, and not again while it stands.
            bank.ensure([ord("∮")], bold=False)
            again = renderer.font_tex_device()
            if renderer.font_tex_device() is not again \
                    or not torch.equal(again[resident[0]:].cpu(),
                                       torch.from_numpy(bank.texture)):
                fail("goldens: the font texture after a new bank glyph")
            versions = {v for _, v in uploads}
            shapes = {tuple(t.shape) for t, _ in uploads}
            if len(uploads) != len(versions) or len(uploads) < 2 \
                    or shapes != {(want_rows, resident[1])}:
                fail(f"goldens: font texture uploads {len(uploads)} for bank "
                     f"versions {sorted(versions)}, shapes {shapes}")
            tex = np.concatenate([renderer.font_tex, bank.texture])
            up_ms = host_ms(lambda: (torch.from_numpy(tex).to(dev),
                                     torch.cuda.synchronize()), 20)
            log(f"goldens [{card}]: the fallback scene's bank holds "
                f"{len(bank.metrics)} glyphs from the stored masks; the font "
                f"texture grew once from {resident[0]} to {want_rows} rows "
                f"and was uploaded {len(uploads)} times for bank versions "
                f"{sorted(versions)}; a re-upload of its {tex.nbytes} B takes "
                f"{up_ms:.3f} ms (host clock to a synchronize, median of 20)")
        finally:
            del renderer.font_tex_device
            restore()
    worst = max(maxima.values())
    log(f"goldens [{card}]: nine scenes at {G.SIZE[0]}x{G.SIZE[1]} within "
        f"{worst[0]} u8 of their goldens (tolerance {G.TOLERANCE}): "
        + ", ".join(f"{n}/{p} {mx}" for (n, p), (mx, _) in maxima.items()))

    # ---- 14. avatars ----------------------------------------------------------
    W, H = VIEWPORT
    repo = AF.build_authors_repo(work)
    emails = AF.author_emails()
    kinds = AF.prime_avatar_cache(emails)
    del os.environ["WGIT_SKIP_AVATARS"]
    try:
        app = open_app([repo])      # prefetches, one 3 s deadline
    finally:
        os.environ["WGIT_SKIP_AVATARS"] = "1"
    states = {e: app.avatar_cache._states.get(e) for e in emails}
    loaded = [e for e in emails if states[e] is AvatarState.LOADED]
    if len(loaded) != 7 or states[emails[AF.KINDS.index("corrupt")]] \
            is not AvatarState.FAILED:
        fail(f"avatars: states {[str(s) for s in states.values()]}")
    log(f"avatars: {len(emails)} authors, cache primed ({', '.join(kinds.values())}"
        f"): {len(loaded)} LOADED, 1 FAILED (the corrupt file)")
    atlas_uploads = record_uploads(
        "image_atlas_device", lambda: renderer.compiler.atlas_version)
    F.clear_caches()
    C.clear_caches()
    layer_builds = []
    real_blocks = C.render_tiles_blocks

    def recording(*a, **k):
        out = real_blocks(*a, **k)
        if k.get("layer_i16") and "tile_rect" not in k:
            layer_builds.append([len(c) for c in a[0][0]].index(1))
        return out

    try:
        v0 = renderer.compiler.atlas_version
        scene = compile_frame(app, renderer, W, H)
        atlas = renderer.image_atlas_device()
        n_img = sum(int(lb.n_images) for lb in scene.layers) + sum(
            len(w.comp.images) for w in scene.windows)
        if renderer.compiler.atlas_version <= v0 or n_img < 7:
            fail(f"avatars: the view drew {n_img} image quads, atlas version "
                 f"{v0} -> {renderer.compiler.atlas_version}")
        font = renderer.font_tex_device()
        packed, _ = drive(scene, font, atlas, "packed")
        cached, _ = drive(scene, font, atlas, "cache")
        C.render_tiles_blocks = recording
        try:
            composed, n_build = drive(scene, font, atlas, "compose")
        finally:
            C.render_tiles_blocks = real_blocks
        steady, n_steady = drive(scene, font, atlas, "compose")
        if not torch.equal(packed, cached):
            mx, _ = max_diff(packed, cached)
            fail(f"avatars: the frame cache's frame is {mx} u8 from the "
                 "packed path's")
        mx, _ = max_diff(composed, packed)
        if mx > 1 or not torch.equal(composed, steady):
            fail(f"avatars: composed frame {mx} u8 from packed, or the "
                 "steady frame differs from the plan build's")
        if 2 not in layer_builds or n_steady[1]:
            fail(f"avatars: the plan build's slabs hold classes "
                 f"{layer_builds}; a steady frame launched K2 "
                 f"{n_steady[1]} times")
        log(f"avatars: history view {W}x{H}, {n_img} image quads: packed "
            "torch.equal to the frame cache, composed within "
            f"{mx} u8 of packed; the plan build launched (K1, K2, K3) "
            f"{n_build}, K2 for slabs of classes {layer_builds} (2: images), "
            f"a steady frame {n_steady}")
        k, p = h.both(K.render_tiles, K.render_tiles_plain,
                      h.k1_inputs(scene, atlas, font_tex=font))
        h.compare("K1", "history view with avatars", "images", k, p,
                  (H, W, 4), torch.uint8)
        k, p = h.both(B.render_tiles_blocks, B.render_tiles_blocks_plain,
                      h.k2_inputs(scene, atlas, font_tex=font))
        h.compare("K2", "history view with avatars", "images", k, p,
                  (H, W, 4), torch.uint8)
        pos, kw, _, _ = h.k3_inputs(scene, atlas=atlas)
        k, p = h.k3_both(pos, kw)
        h.compare_k3(f"history view with avatars, {len(kw['ops'])} ops", k,
                     p, (H, W, 4))
        versions = {v for _, v in atlas_uploads}
        if len(atlas_uploads) != len(versions):
            fail(f"avatars: {len(atlas_uploads)} image atlas uploads for "
                 f"atlas versions {sorted(versions)}")

        # A steady composed frame with avatars against one without, in
        # turns: host clock to a synchronize, and device time (profiler).
        def frame():
            img = render_scene_device(compile_frame(app, renderer, W, H),
                                      renderer.font_tex_device(),
                                      renderer.image_atlas_device())
            torch.cuda.synchronize()
            return img

        timing = {True: [], False: []}
        device = {True: [], False: []}
        for with_avatars in (True, False, False, True):
            app.avatar_cache.enabled = with_avatars
            for _ in range(3):
                frame()
            timing[with_avatars].append(host_ms(frame, 30))
            device[with_avatars].append(device_ms(frame)[1])
        app.avatar_cache.enabled = True
        log(f"avatars [{card}]: a steady composed frame of the history view "
            f"with avatars {timing[True][0]:.3f} / {timing[True][1]:.3f} ms, "
            f"without (identicons) {timing[False][0]:.3f} / "
            f"{timing[False][1]:.3f} ms (host clock to a synchronize, median "
            f"of 30, in turns); device time a frame with "
            f"{device[True][0]:.6f} / {device[True][1]:.6f} ms, without "
            f"{device[False][0]:.6f} / {device[False][1]:.6f} ms (profiler, "
            f"20 frames); image atlas uploads {len(atlas_uploads)} for "
            f"versions {sorted(versions)}")
    finally:
        del renderer.image_atlas_device
    return launched


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
