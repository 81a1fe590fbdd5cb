"""BENCHMARK.json against the benchmark's contract, and the harness finds
every configuration, traffic mix and metric by its name."""

import importlib
import json
import os
import re

import pytest

from portbench import events, guard, harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["portbench"]
    names = [c["name"] for c in bench["configs"]] \
        + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(n for n in names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_entries(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        # Every cell that reports the metric reports what it moves.
        for w in m.get("workloads", cells):
            assert m["moves"] in {x["name"] for x in harness.metrics_for(
                bench, w, "end_to_end")}, (m["name"], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, kind):
    for m in bench[kind]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(mod.read)


def test_cells_find_their_files(bench):
    for w in bench["workloads"]:
        cell, entry = harness.find_cell(bench, w["name"])
        conf = harness.load_json(ROOT, entry["file"])
        assert conf["name"] == entry["name"]
        assert conf["chips"] == cell["chips"] in (1, 4)
        assert conf["reduced"] == entry["reduced"]
        assert events.load(cell["traffic"])["kind"] in ("wheel", "drag")
        assert entry["file"].startswith("portbench/")
        assert len(w["why"]) <= 200
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = harness.metrics_for(bench, w["name"], "end_to_end")
        per = harness.metrics_for(bench, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert per


def test_command_stays_inside_paths(bench):
    cmd = bench["command"]
    assert cmd[:2] == ["python3", "-m"]
    assert cmd[2].split(".")[0] in bench["paths"]
    assert os.path.exists(os.path.join(ROOT, *cmd[2].split(".")) + ".py")


@pytest.mark.parametrize("names,bad", [
    (["whisper_git_tpu_torch", "whisper_git_tpu_torch.render"], []),
    (["whisper_git_tpu", "whisper_git_tpu.render.scene"],
     ["whisper_git_tpu", "whisper_git_tpu.render.scene"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "jaxtyping"],
     ["flax.linen", "jax", "jaxlib.xla_client"]),
    (["whisper_git_tpu_torchx", "numpy"], []),
])
def test_guard_compares_top_level_names_whole(names, bad):
    assert guard.forbidden_modules(names) == bad
