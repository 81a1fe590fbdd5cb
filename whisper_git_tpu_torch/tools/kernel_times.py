#!/usr/bin/env python3
"""Time a kernel of the port on the card, for one checkout.

    python3 whisper_git_tpu_torch/tools/kernel_times.py
        {raster,slabs,compose} [--root DIR] [--repo REPO]

Every mode opens the generated history repository of `chip_smoke.py` (or
the repository `--repo` names, made by it) and compiles its history view at
1280x800, scroll offset 0.

raster: the tile kernel (K1) and the blocks kernel (K2) draw that frame, K1
from the packed path's tables (`pack_scene`, `unpack_layers`), K2 from the
frame cache's blocks (`frame.pack_frame`, `build_blocks`); their frames must
be equal. For each: CUDA events around the wrapper (median of 50), the
kernel alone (the profiler's device time of this repository's kernels over
20 calls) and the wrapper's host time to enqueue one call (host clock over
200 calls, no synchronize between, the least of 5 such batches). Then the
ratio of K1 alone to K2 alone, and K1 alone with the glyphs of every layer
switched off (how much of its time the glyphs take). One JSON object.

slabs: the compose path's slab builds. A slab build is what
`render/compose.py::_window_slab` asks of the device for one scroll window
and class: K2 over the 1216x1280 slab on a transparent canvas, writing the
i16 fixed point layer the compose kernel reads. The frame is rendered
through compose once, the arguments of every slab's `render_tiles_blocks`
call noted, and each replayed: CUDA events around the build (median of 30)
and the profiler's device time (every device event of the build, and this
repository's kernel among them). One JSON object a slab.

compose: the compose kernel's (K3's) device time by op kind, the port's
counterpart of the reference's `tools/compose_probe.py`. The frame is
prepared through compose (`prepare_compose_dispatch`, `frame_tails`) and K3
launched over the plan's op list filtered to one kind: none (the background
and the quantize alone), imgs (the chrome layers), slabs (the scroll
windows' crops), dyn (the volatile tails) and all. Each variant: CUDA events
around the wrapper (median of 50) and the kernel alone (the profiler). One
JSON object a variant. The reference took the slope between two lengths of
a jitted scan, which rests on XLA removing the work of the ops left out;
here the ops left out are simply not in the launch. The deltas between
variants are not additive: the full list overlaps one op's loads with the
blend of another.

The package under `--root` (default: the checkout this file lies in) is
timed with this checkout's harness (`chip_smoke.py`'s repository and timing
helpers), using only what every checkout since K2 writes i16 layers has,
so that a commit and its parent can be held side by side in one call on one
card (parent, change, change, parent). Every object holds the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))


def raster(smoke, torch, renderer, scene) -> list:
    from whisper_git_tpu_torch.render import blocks_kernel as B
    from whisper_git_tpu_torch.render import frame as F
    from whisper_git_tpu_torch.render import raster_kernel as K
    from whisper_git_tpu_torch.render.rasterizer import (pack_scene,
                                                         unpack_layers)

    K.build()
    B.build()
    font, atlas = renderer.font_tex_device(), renderer.image_atlas_device()
    dev = font.device
    bg = tuple(float(c) for c in scene.background[:3])
    height, width = scene.height, scene.width
    fused, meta, ty, tx, win_list = pack_scene(scene)
    wins = tuple(torch.from_numpy(b).to(dev) for _, _, b in win_list)
    layer_data, sig = unpack_layers(torch.from_numpy(fused).to(dev), wins,
                                    meta, ty * tx)
    blob, chrome_args, win_args, fmeta = F.pack_frame(scene, dev)
    blocks = F.build_blocks(torch.from_numpy(blob).to(dev), chrome_args,
                            win_args, fmeta)

    def k1(sig=sig):
        return K.render_tiles(layer_data, font, atlas, bg, ty, tx, sig,
                              height, width)

    def k2():
        return B.render_tiles_blocks(blocks, font, atlas, bg, fmeta[0],
                                     fmeta[1], height, width)

    if not torch.equal(k1(), k2()):
        sys.exit("kernel_times: K1's frame differs from K2's")
    out = {"layers": len(sig)}
    for name, fn in (("K1", k1), ("K2", k2)):
        out[name] = {"events_ms": round(smoke.event_ms(fn, 50), 6),
                     "alone_ms": round(smoke.device_ms(fn)[0], 6),
                     "host_us": round(smoke.host_us(fn, batches=5), 3)}
    out["K1_over_K2_alone"] = round(out["K1"]["alone_ms"]
                                    / out["K2"]["alone_ms"], 4)
    no_glyphs = tuple((s, False, i) for s, _, i in sig)
    out["K1_without_glyphs_alone_ms"] = round(smoke.device_ms(
        lambda: k1(no_glyphs))[0], 6)
    return [out]


def slabs(smoke, torch, renderer, scene) -> list:
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device

    calls = []
    real = C.render_tiles_blocks

    def recording(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    C.render_tiles_blocks = recording
    try:
        render_scene_device(scene, renderer.font_tex_device(),
                            renderer.image_atlas_device())
    finally:
        C.render_tiles_blocks = real
    torch.cuda.synchronize()
    slab_h = C._slab_height(scene.height)
    builds = [(a, k) for a, k in calls
              if a[3] is None and a[6] == slab_h and "tile_rect" not in k]
    if not builds:
        sys.exit("kernel_times: the plan build rendered no slab")
    rows = []
    for a, k in builds:
        def build(a=a, k=k):
            return real(*a, **k)

        layer = build()
        if layer.dtype != torch.int16:
            sys.exit("kernel_times: K2 wrote no i16 layer")
        kernel_ms, device_ms, events = smoke.device_ms(build)
        rows.append({
            "class": [len(c) for c in a[0][0]].index(1),
            "slab": [layer.shape[1], layer.shape[0]],
            "events_ms": round(smoke.event_ms(build, 30), 6),
            "device_ms": round(device_ms, 6),
            "kernel_ms": round(kernel_ms, 6),
            "device_events": events})
    return rows


# Op kinds of each compose variant.
COMPOSE_VARIANTS = (("none", ()), ("imgs", ("img",)), ("slabs", ("slab",)),
                    ("dyn", ("dyn", "dyni")),
                    ("all", ("img", "slab", "dyn", "dyni")))


def compose(smoke, torch, renderer, scene) -> list:
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render import compose_kernel as CK

    CK.build()
    font, atlas = renderer.font_tex_device(), renderer.image_atlas_device()
    prepared = C.prepare_compose_dispatch(scene, font, atlas)
    if prepared is None:
        sys.exit("kernel_times: compose declined the frame")
    args, st = prepared
    starts, dyns, kops = C.frame_tails(
        args[0], font, atlas, st["height"], st["width"], st["tiles_y"],
        st["tiles_x"], st["meta"])
    pos = (starts, tuple(args[1]), tuple(args[2]), dyns)
    kw = dict(tiles_y=st["tiles_y"], tiles_x=st["tiles_x"],
              background=st["background"], height=st["height"],
              width=st["width"], rows=st.get("rows"))
    rows = []
    for name, kinds in COMPOSE_VARIANTS:
        ops = tuple(op for op in kops if op[0] in kinds)

        def blend(ops=ops):
            return CK.compose_tiles(*pos, ops=ops, **kw)

        kernel_ms, _, events = smoke.device_ms(blend)
        rows.append({"variant": name, "ops": [op[0] for op in ops],
                     "events_ms": round(smoke.event_ms(blend, 50), 6),
                     "alone_ms": round(kernel_ms, 6),
                     "device_events": events})
    return rows


MODES = {"raster": raster, "slabs": slabs, "compose": compose}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=tuple(MODES))
    ap.add_argument("--root", default=CHECKOUT,
                    help="checkout whose package to time")
    ap.add_argument("--repo", default=None,
                    help="the history repository to open (default: made "
                    "afresh by chip_smoke.build_history_repo)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(CHECKOUT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    import whisper_git_tpu_torch.render as render
    from whisper_git_tpu_torch.app.views.widgets import freeze_pulse
    from whisper_git_tpu_torch.host.main import open_app
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render.renderer import Renderer

    if not os.path.samefile(os.path.dirname(render.__file__),
                            os.path.join(root, "whisper_git_tpu_torch",
                                         "render")):
        print(f"kernel_times: the package is not {root}'s", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="wgit-kernel-times-")
    for var in ("XDG_STATE_HOME", "XDG_CACHE_HOME", "XDG_CONFIG_HOME"):
        os.environ[var] = os.path.join(work, var.lower())
    os.environ["WGIT_SKIP_AVATARS"] = "1"
    for var in ("WGIT_DEVICE", "WGIT_FRAME_CACHE", "WGIT_FRAME_COMPOSE"):
        os.environ.pop(var, None)
    try:
        repo = args.repo or smoke.build_history_repo(work)
        freeze_pulse(1.0)
        renderer = Renderer(torch.device("cuda"))
        app = open_app([repo])
        app.current().history_scroll = 0.0
        scene = compile_frame(app, renderer, *smoke.VIEWPORT)
        for row in MODES[args.kernel](smoke, torch, renderer, scene):
            print(json.dumps({"card": card, "root": root, **row}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
