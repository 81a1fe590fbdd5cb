"""The program's spans over a cell's window: what the host half of a frame
does, and what the device's idle gaps are put down to.

    python3 -m portbench.spans --workload <name> --seed <n> --seconds <s>
        [--out <path.json>]
    python3 -m portbench.spans --cost [--n <iterations>]

The first runs the cell as `python3 -m portbench.run --trace 1` does
(`harness.run_cell`, the device trace on), with the port's tracing
(`whisper_git_tpu_torch/tracing.py`) on from the start of the run, and
reports over the window: spans a frame, the largest self times (a span's
time less its children's) in ms a frame, the collections, the program's
counters, the slowest frames and what covers them, the ten longest idle
gaps of the device named by `gap_name`, and the device-to-host copies of
the window beside the harness's own copies of its sampled frames. Those
copies are made at known host times, so they also give the shift that puts
the device events where they happened on the host's clock; where it is not
0 the gaps are named again with the events so moved (`idle_gaps_realigned`).
It prints a summary on stderr and writes everything to `--out` as JSON. It
is a diagnosis, not a cell: it prints no result line.

`--cost` times `tracing.span()` entered and left, tracing off and on,
over `--n` iterations (the loop's own time reported beside it).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

from . import trace
from .run import STEADY_ENV, process_start

STALL_MS = 15.0


def span_index(spans, t0_ns: int, t1_ns: int) -> list:
    """The spans that meet [t0_ns, t1_ns], as (t0, t1, name, tid)."""
    return [(s.t0, s.t1, s.name, s.tid) for s in spans
            if s.t1 > t0_ns and s.t0 < t1_ns]


def innermost(index: list, t_ns: int, tid=None, other_than=None):
    """The name of the shortest span covering `t_ns` on thread `tid` (any
    thread but `other_than` where that is given instead), or None."""
    best = None
    for a, b, name, th in index:
        if not a <= t_ns < b:
            continue
        if tid is not None and th != tid:
            continue
        if other_than is not None and th == other_than:
            continue
        if best is None or b - a < best[0]:
            best = (b - a, name)
    return None if best is None else best[1]


def gap_name(phase: str, index: list, t_ns: int, frame_tid: int) -> str:
    """An idle gap's name from the span at its middle `t_ns`: the harness's
    phase, then `/` and the innermost program span on the frame's thread,
    then `+` and a collection (`gc`, on any thread) or else the innermost
    span of another thread, where such spans cover the middle."""
    name = phase
    inner = innermost(index, t_ns, tid=frame_tid)
    if inner is not None:
        name += "/" + inner
    gcs = [e for e in index if e[2] == "gc" and e[0] <= t_ns < e[1]]
    other = "gc" if gcs else innermost(index, t_ns, other_than=frame_tid)
    if other is not None and other != inner:
        name += "+" + other
    return name


def self_times(spans) -> dict:
    """name -> (count, summed self time in ns): each span's time less the
    time its direct children cover (children lie inside their parent)."""
    child_ns: dict = {}
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.t1 - s.t0
    out: dict = {}
    for s in spans:
        n, ns = out.get(s.name, (0, 0))
        out[s.name] = (n + 1, ns + s.t1 - s.t0 - child_ns.get(s.sid, 0))
    return out


def span_cost(n: int) -> dict:
    """ns an iteration of a loop entering and leaving one span, tracing
    off and on, and of the same loop with no span."""
    from whisper_git_tpu_torch import tracing

    def loop(with_span: bool) -> float:
        span = tracing.span
        t0 = time.perf_counter_ns()
        if with_span:
            for _ in range(n):
                with span("layout"):
                    pass
        else:
            for _ in range(n):
                pass
        return (time.perf_counter_ns() - t0) / n

    was = tracing.enabled()
    tracing.disable()
    empty = loop(False)
    off = loop(True)
    tracing.enable()
    on = loop(True)
    tracing.disable()
    if was:
        tracing.enable()
    return {"n": n, "loop_ns": empty, "off_ns": off, "on_ns": on}


def _steady(argv) -> None:
    if any(os.environ.get(k) != v for k, v in STEADY_ENV.items()):
        os.environ.update(STEADY_ENV)
        os.execv(sys.executable, [sys.executable, "-m", "portbench.spans",
                                  *argv])


def diagnose(cell, conf, traffic, seed: int, seconds: float, t_proc,
             device: str = "cuda", log=sys.stderr) -> dict:
    """Run the cell traced with the program's tracing on → the report
    (see the module's docstring)."""
    import numpy as np

    from whisper_git_tpu_torch import tracing

    from . import harness, program

    kept = {}
    base = trace.DeviceTrace

    class Kept(base):
        def summary(self, *a, **k):
            kept["call"] = (self, a, k)
            return super().summary(*a, **k)

    trace.DeviceTrace = Kept
    tracing.enable()
    try:
        out = harness.run_cell(cell, conf, traffic, seed, seconds, True,
                               device, t_proc, log=log)
    finally:
        tracing.disable()
        trace.DeviceTrace = base
    data = tracing.collect()
    ctx = out["ctx"]
    ph, n = ctx["phase_ns"], ctx["frames"]
    t0, t1 = int(ph[0, 0]), int(ph[-1, 5])
    spans = [s for s in data["spans"] if s.t0 >= t0 and s.t1 <= t1]
    frame_tid = next(s.tid for s in spans if s.name == "render")
    ours = [s for s in spans if s.tid == frame_tid and s.name != "gc"]
    selfs = self_times(ours)
    top = sorted(selfs.items(), key=lambda kv: -kv[1][1])
    report = {"cell": cell["name"], "seed": seed, "frames": n,
              "window_s": ctx["window_s"], "correct": out["correct"],
              "dropped_spans": data["dropped"],
              "spans_per_frame": len(ours) / n,
              "spans_per_frame_all_threads": len(spans) / n,
              "self_ms_per_frame": {k: v[1] / 1e6 / n for k, v in top},
              "count_per_frame": {k: v[0] / n for k, v in top},
              "counters": program.window_counters(ctx),
              "gc": _collections(spans, n)}
    index = span_index(data["spans"], t0, t1)
    if "call" in kept:
        tracer, a, k = kept["call"]
        skip = a[4] if len(a) > 4 else k.get("skip", ())
        report["dtoh"] = _dtoh(tracer, t0, t1, skip)
        s = _named_summary(tracer, a, k, index, frame_tid)
        report["idle_gaps"] = s["idle_gaps"]
        report["device_ops"] = s["device_ops"]
        report["idle_share"] = 1.0 - s["busy_s"] / s["window_s"]
        shift = report["dtoh"]["best_shift_ns"]
        if shift:
            # The gaps again with the device events moved by the shift
            # that puts the harness's own copies where it made them.
            events = tracer.events
            tracer.events = [(s0 + shift, d, c, n)
                             for s0, d, c, n in events]
            try:
                report["idle_gaps_realigned"] = _named_summary(
                    tracer, a, k, index, frame_tid)["idle_gaps"]
            finally:
                tracer.events = events
    lat = ctx["lat_ns"]
    slow = [int(i) for i in np.argsort(lat)[::-1] if lat[i] / 1e6
            > STALL_MS][:12]
    stalls = []
    for i in slow:
        a, b = int(ph[i, 0]), int(ph[i, 5])
        inside = [s for s in data["spans"] if s.t1 > a and s.t0 < b]
        mine = self_times([s for s in inside if s.tid == frame_tid
                           and s.name != "gc"])
        stalls.append({
            "frame": i, "ms": float(lat[i] / 1e6),
            "top_self_ms": sorted(((k, v[1] / 1e6) for k, v in mine.items()),
                                  key=lambda kv: -kv[1])[:4],
            "gc": [(s.attrs.get("gen"), (s.t1 - s.t0) / 1e6)
                   for s in inside if s.name == "gc"],
            "other_threads": sorted({s.name for s in inside
                                     if s.tid != frame_tid
                                     and s.name != "gc"})})
    report["stalls"] = stalls
    report["frames_over_stall_ms"] = int((lat / 1e6 > STALL_MS).sum())
    return report


def _collections(spans, frames: int) -> dict:
    """The window's collections by generation: count, ms a frame, the
    longest in ms."""
    out: dict = {}
    for s in spans:
        if s.name == "gc":
            n, ns, top = out.get(s.attrs["gen"], (0, 0, 0))
            out[s.attrs["gen"]] = (n + 1, ns + s.t1 - s.t0,
                                   max(top, s.t1 - s.t0))
    return {g: {"count": n, "ms_per_frame": ns / 1e6 / frames,
                "longest_ms": top / 1e6}
            for g, (n, ns, top) in sorted(out.items())}


def _named_summary(tracer, a, k, index, frame_tid) -> dict:
    """`tracer.summary(*a, **k)` with each idle gap named by `gap_name`."""
    phase_of = trace.name_phase

    def name_phase(phase_ns, t_ns):
        return gap_name(phase_of(phase_ns, t_ns), index, t_ns, frame_tid)

    trace.name_phase = name_phase
    try:
        return tracer.summary(*a, **k)
    finally:
        trace.name_phase = phase_of


def _copies(tracer, t0: int, t1: int) -> list:
    """The window's device-to-host copies on the host clock, (start,
    end)."""
    return [(s, s + d) for s, d, _, name in tracer.events
            if name.startswith("Memcpy DtoH") and s + d > t0 and s < t1]


def best_shift(copies: list, skip, pad: int = trace.SKIP_PAD_NS,
               reach_ns: int = 50_000_000, step_ns: int = 10_000) -> tuple:
    """The shift of the device events on the host clock, within ±reach_ns,
    that puts the most copies inside the harness's sampled-copy intervals
    `skip` (each widened by `pad`), the smallest such shift where several
    tie → (shift ns, copies inside)."""
    iv = sorted((a - pad, b + pad) for a, b in skip)
    starts = [a for a, _ in iv]

    def inside(shift):
        n = 0
        for s, e in copies:
            k = bisect.bisect_right(starts, s + shift) - 1
            n += k >= 0 and e + shift <= iv[k][1]
        return n

    best = (inside(0), 0)
    for shift in range(-reach_ns, reach_ns + 1, step_ns):
        n = inside(shift)
        if n > best[0] or (n == best[0] and abs(shift) < abs(best[1])):
            best = (n, shift)
    return best[1], best[0]


def _dtoh(tracer, t0: int, t1: int, skip) -> dict:
    """The window's device-to-host copies (count, seconds) beside the
    harness's sampled-frame copies (`skip`): how many fall inside those as
    the harness aligns the clocks, and the shift that fits them best, over
    the window and over each of its halves (a drift between the clocks
    shows as two shifts)."""
    copies = _copies(tracer, t0, t1)
    mid = (t0 + t1) // 2
    halves = [[c for c in copies if c[0] < mid],
              [c for c in copies if c[0] >= mid]]
    shift, n = best_shift(copies, skip)
    zero = best_shift(copies, skip, reach_ns=0)[1]
    return {"copies": len(copies),
            "seconds": sum(e - s for s, e in copies) / 1e9,
            "sampled_copies": len(skip), "inside_as_aligned": zero,
            "best_shift_ns": shift, "inside_at_best_shift": n,
            "half_shifts_ns": [best_shift(h, skip)[0] if h else None
                               for h in halves]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="portbench.spans")
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out")
    p.add_argument("--cost", action="store_true")
    p.add_argument("--n", type=int, default=1_000_000)
    args = p.parse_args(argv)
    if args.cost:
        print(json.dumps(span_cost(args.n)))
        return 0
    if args.workload is None or args.seed is None:
        p.error("--workload and --seed, or --cost")
    _steady(argv)
    t_proc = process_start()
    from . import events
    from .harness import ROOT, find_cell, load_benchmark, load_json

    bench = load_benchmark()
    cell, entry = find_cell(bench, args.workload)
    conf = load_json(ROOT, entry["file"])
    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    report = diagnose(cell, conf, events.load(cell["traffic"]), args.seed,
                      args.seconds, t_proc)
    c = report["counters"] or {}
    print("# program counters over the window: " + ", ".join(
        f"{k} {v}" for k, v in c.items() if v), file=sys.stderr)
    print(f"# spans a frame {report['spans_per_frame']:.2f}; self ms a "
          "frame: " + ", ".join(
              f"{k} {v:.4f}" for k, v in
              list(report["self_ms_per_frame"].items())[:5]),
          file=sys.stderr)
    print(f"# collections {report['gc']}; device-to-host copies "
          f"{report.get('dtoh')}", file=sys.stderr)
    for key in ("idle_gaps", "idle_gaps_realigned"):
        for name, g in report.get(key, []):
            print(f"# {key} {g * 1e3:.3f} ms {name}", file=sys.stderr)
    for st in report["stalls"]:
        print(f"# stall {st}", file=sys.stderr)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
