"""The command as the benchmark's runs call it."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

CMD = [sys.executable, "-m", "portbench.run", "--workload",
       "history1000-1280x800.wheel", "--seed", str(2**31 + 9),
       "--seconds", "1", "--trace", "0"]


def run_cli(env_extra=None, cwd=harness.ROOT):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(CMD, capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=600)


def test_no_card_no_result():
    """Where no card is visible the command prints no result and exits
    with another code than 0."""
    res = run_cli({"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "needs 1 CUDA card" in res.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory with BENCHMARK.json and the harness alone, the
    command fails."""
    import shutil

    shutil.copytree(os.path.join(harness.ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    res = run_cli(cwd=str(tmp_path))
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.card
def test_a_run_on_the_card(card):
    res = run_cli()
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["kind"] == card
    assert line["checks"]["frame_gap_u8"]["value"] \
        <= line["checks"]["frame_gap_u8"]["limit"]
