#!/usr/bin/env python3
"""Time the compose path's slab builds on the card, for one checkout.

    python3 whisper_git_tpu_torch/tools/layer_build_times.py [--root DIR]

A slab build is what `render/compose.py::_window_slab` asks of the device
for one scroll window and class: the blocks rasterizer (K2) over the
1216x1280 slab on a transparent canvas, and the i16 fixed point layer that
the compose kernel reads. Where the rasterizer writes f32, the quantize
pass in torch ops (`compose._quant_i16_planar`) belongs to the build, and
is timed with it.

The script runs the package under `--root` (default: the checkout this file
lies in), so that two checkouts, a commit and its parent, can be held side
by side in one call on one card. It uses only what both have: it opens the
generated history repository of `chip_smoke.py`, renders the history view at
1280x800 through compose once, notes the arguments of every slab's
`render_tiles_blocks` call, and replays each: CUDA events around the call
(median of 30) and the profiler's device time (every device event of the
call, and this repository's kernel among them). Prints one JSON object a
slab, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose package and chip_smoke.py to run")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("layer_build_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()

    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from whisper_git_tpu_torch.app.views.widgets import freeze_pulse
    from whisper_git_tpu_torch.host.main import open_app
    from whisper_git_tpu_torch.host.screenshot_mode import compile_frame
    from whisper_git_tpu_torch.render import compose as C
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import Renderer

    if not os.path.samefile(os.path.dirname(C.__file__),
                            os.path.join(root, "whisper_git_tpu_torch",
                                         "render")):
        print(f"layer_build_times: the package is not {root}'s",
              file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="wgit-layer-builds-")
    for var in ("XDG_STATE_HOME", "XDG_CACHE_HOME", "XDG_CONFIG_HOME"):
        os.environ[var] = os.path.join(work, var.lower())
    os.environ["WGIT_SKIP_AVATARS"] = "1"
    for var in ("WGIT_DEVICE", "WGIT_FRAME_CACHE", "WGIT_FRAME_COMPOSE"):
        os.environ.pop(var, None)
    try:
        dev = torch.device("cuda")
        repo = chip_smoke.build_history_repo(work)
        freeze_pulse(1.0)
        renderer = Renderer(dev)
        app = open_app([repo])
        app.current().history_scroll = 0.0
        width, height = chip_smoke.VIEWPORT
        scene = compile_frame(app, renderer, width, height)

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
        slab_h = C._slab_height(height)
        slabs = [(a, k) for a, k in calls
                 if a[3] is None and a[6] == slab_h and "tile_rect" not in k]
        if not slabs:
            print("layer_build_times: the plan build rendered no slab",
                  file=sys.stderr)
            return 1

        for a, k in slabs:
            def build(a=a, k=k):
                layer = real(*a, **k)
                if layer.dtype != torch.int16:
                    layer = C._quant_i16_planar(layer)
                return layer

            layer = build()
            torch.cuda.synchronize()
            times = []
            for _ in range(30):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                build()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    build()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if getattr(e, "device_type", None) is not None
                      and "CUDA" in str(e.device_type)]
            print(json.dumps({
                "card": card, "root": root,
                "class": [len(c) for c in a[0][0]].index(1),
                "slab": [layer.shape[1], layer.shape[0]],
                "rasterizer_writes": "i16" if k.get("layer_i16") else "f32",
                "events_ms": round(statistics.median(times), 6),
                "device_ms": round(sum(e.self_device_time_total
                                       for e in events) / 20 / 1e3, 6),
                "kernel_ms": round(sum(e.self_device_time_total
                                       for e in events
                                       if "raster::" in e.key) / 20 / 1e3, 6),
                "device_events": sum(e.count for e in events) // 20,
            }), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
