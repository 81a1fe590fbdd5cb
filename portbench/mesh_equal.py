"""Frames of the four-card cell drawn over the render mesh, against the same
scenes drawn on one card.

    python3 -m portbench.mesh_equal --seed <n> [--seconds 10] [--frames 48]
        [--out <path.json>]

Runs `history1000-1280x800-mesh4.wheel` through `harness.run_cell` as
`portbench.run` does (no `WGIT_MESH`: the renderer's auto mesh over every
card), and keeps `--frames` of the run's frames (its warm-up cycle and its
window), drawn from the seed, each with its scene and the gathered frame
copied to the host. Then the mesh is taken down (`WGIT_MESH=0`, no render
mesh), the layer caches are emptied, and each kept scene is drawn again,
in the run's order, on the first card alone: every pair must be
`torch.equal`, and the one-card pass must count no mesh frame. Prints one
JSON line, writes it to `--out` where one is given, and exits 0 only where
every pair is equal and the run is correct. A check, not a cell: it prints
no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

from . import events, harness

CELL = "history1000-1280x800-mesh4.wheel"


def check(cell: dict, conf: dict, traffic: dict, seed: int, seconds: float,
          frames: int, device: str = "cuda", log=sys.stderr) -> dict:
    """The run, then the kept frames against one device's → the report."""
    import torch

    from whisper_git_tpu_torch import tracing
    from whisper_git_tpu_torch.render import compose, frame, meshstate
    from whisper_git_tpu_torch.render.rasterizer import render_scene_device
    from whisper_git_tpu_torch.render.renderer import get_renderer

    rng = random.Random(f"portbench-mesh-equal-{seed}")
    kept = []
    drawn = [0]

    def wrap(path):
        render = path["render"]

        def r(scene):
            img = render(scene)
            i = drawn[0]
            drawn[0] += 1
            j = harness.Sampler._slot(rng, frames, i)
            if j is not None:
                item = (i, scene, img.to("cpu"))
                if j < len(kept):
                    kept[j] = item
                else:
                    kept.append(item)
            return img
        return dict(path, render=r)

    out = harness.run_cell(cell, conf, traffic, seed, seconds, False, device,
                           wrap=wrap, log=log)
    mesh = meshstate.get_render_mesh()
    os.environ["WGIT_MESH"] = "0"
    meshstate.set_render_mesh(None)
    compose.clear_caches()
    frame.clear_caches()
    renderer = get_renderer(device)
    c0 = tracing.counters()
    gaps = []
    for i, scene, img in sorted(kept, key=lambda k: k[0]):
        one = render_scene_device(scene, renderer.font_tex_device(),
                                  renderer.image_atlas_device()).cpu()
        gaps.append((i, bool(torch.equal(one, img)),
                     int((one.to(torch.int16) - img.to(torch.int16))
                         .abs().max())))
    c1 = tracing.counters()
    return {"cell": cell["name"], "seed": seed,
            "mesh": None if mesh is None else [str(d) for d in mesh.flat],
            "correct": bool(out["correct"]), "attempted": out["attempted"],
            "frames_drawn": drawn[0], "frames_compared": len(gaps),
            "equal": sum(e for _, e, _ in gaps),
            "max_gap_u8": max((g for _, _, g in gaps), default=None),
            "unequal": [i for i, e, _ in gaps if not e],
            "one_card_counts": {k: c1[k] - c0[k] for k in
                                ("mesh.frames", "frames.composed",
                                 "frames.frame_cache")},
            "checks": out["checks"]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="portbench.mesh_equal")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = harness.load_benchmark()
    cell, entry = harness.find_cell(bench, CELL)
    conf = harness.load_json(harness.ROOT, entry["file"])
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench.mesh_equal: {CELL} needs {cell['chips']} CUDA "
              f"cards", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = check(cell, conf, events.load(cell["traffic"]), args.seed,
              args.seconds, args.frames)
    r["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(r)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    ok = r["correct"] and r["frames_compared"] \
        and r["equal"] == r["frames_compared"] \
        and r["one_card_counts"]["mesh.frames"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
