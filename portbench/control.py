"""The readings that a cell's limits are set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--fault stale]

For each seed, in one process: a run of the cell with a short window, its
sampled frames judged by the reference (the program's readings of
`frame_gap_u8`, `row_err_px`, `text_err_rows`) and by the control, the
reference computed in bfloat16 in the program's place
(`control_frame_gap_u8`).
`--fault stale` runs the program with its input handler left out, so
that the view's state never changes: the reading of `row_err_px` under
that fault. One JSON line a seed, then one with the largest program
readings and the smallest control readings.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=("none", "stale"), default="none")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from . import events
    from .harness import ROOT, find_cell, load_benchmark, load_json, run_cell

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = load_benchmark()
    cell, entry = find_cell(bench, args.workload)
    conf = load_json(ROOT, entry["file"])
    traffic = events.load(cell["traffic"])

    def stale(path):
        return dict(path, handle=lambda e: None)

    wrap = stale if args.fault == "stale" else None
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(cell, conf, traffic, seed, args.seconds, False,
                       "cuda", wrap=wrap, control=args.fault == "none")
        row = {"seed": seed, "frames": out["attempted"],
               "correct": out["correct"]}
        row.update({k: c["value"] for k, c in out["checks"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": cell["name"], "fault": args.fault,
               "seeds": len(rows),
               "program_max": {k: max(r[k] for r in rows)
                               for k in ("frame_gap_u8", "row_err_px",
                                         "text_err_rows")}}
    if args.fault == "none":
        summary["control_min"] = {
            "control_frame_gap_u8": min(r["control_frame_gap_u8"]
                                        for r in rows)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
