"""The port's bench (`python -m whisper_git_tpu_torch.bench`) on the CPU,
in a process where the JAX package and JAX are refused: it exits 0 and
prints one JSON line with the reference bench's fields (the tunnel's
dropped) and the port's own; asked for cuda without a GPU it fails."""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REFUSING_RUN = """
import importlib.abc, runpy, sys
REFUSED = ("whisper_git_tpu", "jax", "jaxlib", "PIL", "matplotlib")
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"{name} is refused")
        return None
sys.meta_path.insert(0, _Refuse())
sys.argv = ["whisper_git_tpu_torch.bench"] + sys.argv[1:]
runpy.run_module("whisper_git_tpu_torch.bench", run_name="__main__")
"""

FIELDS = {"metric", "value", "unit", "vs_baseline", "median_fps",
          "latency_p50_ms", "present_latency_p50_ms",
          "first_frame_present_s", "device_ms_per_frame", "device_fps",
          "device_busy_share", "presented_fps", "present_drop_rate",
          "rebuild_ms_p50", "rebuild_ms_max", "rebuild_frames",
          "oversized_ms", "kernel_build_s",
          "kernels_built", "setup_s", "iters_per_batch", "batches_fps",
          "device", "device_count", "mesh", "device_ms_per_frame_by_card",
          "device_busy_share_by_card"}
TUNNEL = {"link_warmup_s", "compile_s", "compile_trace_s",
          "compile_cache_hits", "compile_cache_misses"}


def _bench(tmp_path, *args):
    script = tmp_path / "refusing_run.py"
    script.write_text(REFUSING_RUN)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "WGIT_DEVICE", "XLA_FLAGS",
                        "WGIT_FRAME_CACHE", "WGIT_FRAME_COMPOSE")}
    env.update(PYTHONPATH=ROOT, WGIT_SKIP_AVATARS="1",
               XDG_STATE_HOME=str(tmp_path / "state"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               XDG_CONFIG_HOME=str(tmp_path / "config"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(script), *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_bench_on_the_cpu_prints_its_line(tmp_path):
    res = _bench(tmp_path, "--device", "cpu", "--iters", "4",
                 "--batches", "2")
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    row = json.loads(lines[-1])
    assert set(row) == FIELDS and not set(row) & TUNNEL
    assert row["metric"] == "history_view_frame_render"
    assert row["device"] == "cpu" and row["iters_per_batch"] == 4
    assert len(row["batches_fps"]) == 2
    assert row["value"] == max(row["batches_fps"]) > 0
    assert row["vs_baseline"] == row["value"] / 60.0
    for key in ("median_fps", "latency_p50_ms", "present_latency_p50_ms",
                "first_frame_present_s", "presented_fps", "setup_s"):
        assert row[key] > 0, key
    assert 0.0 <= row["present_drop_rate"] <= 1.0
    # A scroll over 0-400 px crosses compose's scroll buckets.
    assert row["rebuild_frames"] >= 1 and row["rebuild_ms_max"] > 0
    # No device on the CPU: its figures are null, no kernel was built.
    for key in ("device_ms_per_frame", "device_fps", "device_busy_share",
                "device_ms_per_frame_by_card", "device_busy_share_by_card",
                "oversized_ms", "mesh"):
        assert row[key] is None, key
    assert row["kernels_built"] == 0 and row["kernel_build_s"] == 0.0
    assert row["device_count"] == 0   # CUDA_VISIBLE_DEVICES is empty


def test_bench_cuda_without_a_gpu_fails(tmp_path):
    res = _bench(tmp_path, "--iters", "1", "--batches", "1")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not res.stdout.strip()
