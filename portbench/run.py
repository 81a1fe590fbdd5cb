"""Run one cell of the benchmark and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

With `--trace 0` the line's metrics are the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read from the profiler's trace
of the window and from the harness's spans. The numbers that decide
`correct` are printed beside their limits as the last lines on stderr
and under `checks`, the line's last key. No card, fewer cards than the
cell asks for, or a module of JAX or of the JAX package in the process
once the window has closed: no result, and a code other than 0.

A run is one process with one thread of library work: the command sets
`PYTHONHASHSEED=0` and one thread for OpenMP, MKL and OpenBLAS (and so
for PyTorch's CPU ops), replacing itself (`os.execv`, the same process)
where it started without them. On an NVIDIA H100 machine that took the
wheel cell's run-to-run spread of the window's frame rate from 12.8 % to
5.6 % of the median (PERF.md).
"""

from __future__ import annotations

import os
import time

_T_PROC = time.perf_counter()


def process_start() -> float:
    """When this process started, on `time.perf_counter`'s clock: from
    /proc where it can be read, else when this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rpartition(")")[2].split()
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / ticks
        return time.perf_counter() - age if 0.0 <= age < 600.0 else _T_PROC
    except (OSError, ValueError, IndexError):
        return _T_PROC


import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

STEADY_ENV = {"PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
              "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def steady_process(argv) -> None:
    """Take `STEADY_ENV`, replacing this process where the interpreter
    started without its hash seed."""
    need = any(os.environ.get(k) != v for k, v in STEADY_ENV.items())
    if not need:
        return
    os.environ.update(STEADY_ENV)
    os.execv(sys.executable, [sys.executable, "-m", "portbench.run", *argv])


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(bench: dict, cell: dict, out: dict, trace: bool,
                kind: str, power: list) -> dict:
    from .harness import metrics_for, read_metric

    ctx = out["ctx"]
    metrics = {}
    for m in metrics_for(bench, cell["name"],
                         "per_layer" if trace else "end_to_end"):
        v = read_metric(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
           "memory_peak_bytes": int(ctx["peak_bytes"]),
           "power_limit": power[:int(cell["chips"])]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    s = ctx["trace"]
    if trace and s is not None:
        dev["busy_s"] = s["busy_s"]
        dev["window_s"] = s["window_s"]
        line["breakdown"] = {"device_ops": s["device_ops"],
                             "idle_gaps": s["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steady_process(argv)
    t_proc = process_start()
    args = parse_args(argv)
    from . import events
    from .guard import forbidden_modules
    from .harness import ROOT, find_cell, load_benchmark, load_json

    bench = load_benchmark()
    cell, conf_entry = find_cell(bench, args.workload)
    conf = load_json(ROOT, conf_entry["file"])
    traffic = events.load(cell["traffic"])
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .device import card_name, power_limits
    from .harness import run_cell

    out = run_cell(cell, conf, traffic, args.seed, args.seconds,
                   bool(args.trace), "cuda", t_proc)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    line = result_line(bench, cell, out, bool(args.trace),
                       card_name(torch), power_limits())
    for name, c in out["checks"].items():
        print(f"# check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
