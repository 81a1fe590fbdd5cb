"""The benchmark of `whisper_git_tpu_torch`, the PyTorch / CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run builds a git repository from the seed, opens it in the port's
app, warms up the cell's input cycle, feeds it through the app's frame
path for `--seconds`, checks sampled frames against a plain reference
(`portbench/reference.py`) and prints one JSON line. Everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own (`configs/`, `traffic/`, `metrics/`), found by the name
that `BENCHMARK.json` gives it.
"""
