"""Row-tiling seam smoke test.

Counterpart of `whisper_git_tpu/tools/vector_smoke.py` (capability parity
with reference src/bin/vector_smoke.rs): render the same lane geometry
three ways — (a) per-row integer-aligned segments, (b) per-row segments
with 1px overlap, (c) one unbroken segment — and verify the three renders
agree, proving per-row decomposition introduces no AA seams (the
constraint integer-rounded row heights exist to protect). Writes
out/vector_smoke.png with the three variants side by side (the port's
`png_bytes`).

    python -m whisper_git_tpu_torch.tools.vector_smoke [OUT.png]
        [--device cpu]

It renders on the card unless `--device cpu` asks for the CPU; exit 0 when
both diffs are within 2 u8 (the reference's gate).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..ui import column, path, rect, row, stack, text
from ..ui.theme import DARK as T

ROWS = 8
ROW_H = 28.0
LANE_X = 24.0


def _variant(kind: str):
    prims = []
    color = (0.36, 0.61, 0.84, 1.0)
    total = ROWS * ROW_H
    if kind == "per-row":
        for r in range(ROWS):
            prims.append(("vline", LANE_X, r * ROW_H, (r + 1) * ROW_H, 2.0,
                          color))
    elif kind == "overlap":
        for r in range(ROWS):
            y0 = max(0.0, r * ROW_H - 0.5)
            y1 = min(total, (r + 1) * ROW_H + 0.5)
            prims.append(("vline", LANE_X, y0, y1, 2.0, color))
    else:  # single
        prims.append(("vline", LANE_X, 0.0, total, 2.0, color))
    # An S-curve split per row, like the graph's cross-lane edges.
    for r in range(0, ROWS - 1, 2):
        prims.append(("cubic", (LANE_X + 24, r * ROW_H),
                      (LANE_X + 24, (r + 1) * ROW_H),
                      (LANE_X + 48, (r + 1) * ROW_H),
                      (LANE_X + 48, (r + 2) * ROW_H), 2.0,
                      (0.46, 0.78, 0.50, 1.0)))
    return rect(path(prims), width=100, height=ROWS * ROW_H,
                fill=T.background)


def run(out_path: str = "out/vector_smoke.png", device="cuda") -> dict:
    from ..render.renderer import get_renderer, save_png

    renderer = get_renderer(device)
    ui = stack(
        column(
            row(*[column(text(k, color=T.text_muted, font_size=11),
                         _variant(k), gap=4)
                  for k in ("per-row", "overlap", "single")],
                gap=20, padding=(10, 10, 10, 10)),
            width="fill", height="fill"),
        width="fill", height="fill", fill=T.background)
    W, H = 420, int(ROWS * ROW_H + 50)
    img = renderer.render(ui, (W, H))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_png(img, out_path)

    # Compare the vline column of each variant: extract a 30px-wide strip
    # around each lane x and diff per-row vs single.
    strips = []
    for i in range(3):
        x0 = 10 + i * 120 + int(LANE_X) - 3  # column offsets from layout
        strips.append(img[30:30 + int(ROWS * ROW_H), x0:x0 + 30, :3]
                      .astype(int))
    per_row, overlap, single = strips
    diff_a = np.abs(per_row - single).max()
    diff_b = np.abs(overlap - single).max()
    return {"out": out_path, "max_diff_per_row_vs_single": int(diff_a),
            "max_diff_overlap_vs_single": int(diff_b)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="out/vector_smoke.png")
    ap.add_argument("--device", default="cuda",
                    help="device to render on (default: the card)")
    args = ap.parse_args(argv)
    result = run(args.out, args.device)
    print(result)
    ok = (result["max_diff_per_row_vs_single"] <= 2
          and result["max_diff_overlap_vs_single"] <= 2)
    print("PASS" if ok else "FAIL: tiling introduced seams "
          f"(per-row {result['max_diff_per_row_vs_single']}, "
          f"overlap {result['max_diff_overlap_vs_single']})")
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
