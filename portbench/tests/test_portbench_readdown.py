"""The readdown cell (`history1000-3840x2160-s2.readdown`): its traffic,
its configuration and cell found by name, and its two readers
(`metrics/plan_builds_per_frame.py`, `metrics/build_mpx_per_frame.py`)
on a window and on a program that lacks their counters."""

import collections
import time

import numpy as np
import pytest

from portbench import events, harness, program, reference, repo
from portbench.metrics import build_mpx_per_frame, plan_builds_per_frame
from whisper_git_tpu_torch import tracing

CELL = "history1000-3840x2160-s2.readdown"
CONFIG = "history1000-3840x2160-s2"
SEEDS = (7, 2**33 + 11, 2**31 + 5)
NEW_METRICS = ("plan_builds_per_frame", "build_mpx_per_frame")


def history(seed):
    bench = harness.load_benchmark()
    _, entry = harness.find_cell(bench, CELL)
    spec = harness.load_json(harness.ROOT, entry["file"])["history"]
    return reference.History(repo.display_order(repo.history(seed, spec)),
                             1_790_000_000)


def test_the_cycle_is_150_clicks_down_then_150_up():
    t = events.load("readdown")
    cycles = [events.cycle(t, seed, history(seed).total)["cycle"]
              for seed in SEEDS]
    assert cycles[0] == cycles[1] == cycles[2]
    assert cycles[0] == [("wheel", 84.0)] * 150 + [("wheel", -84.0)] * 150


def test_offsets_are_whole_and_stay_far_from_the_bottom():
    t = events.load("readdown")
    for seed in SEEDS:
        h = history(seed)
        ev = events.cycle(t, seed, h.total)
        offs = events.replay_offsets(ev, 2 * len(ev["cycle"]), h.total)
        assert np.all(offs == np.round(offs))
        assert offs.max() == 150 * 84.0 == 12600.0
        assert offs[149] == 12600.0 and offs[299] == offs[599] == 0.0
        # The app's infinite scroll asks for more rows within 2000 px of
        # the bottom; the readdown never comes near it.
        assert offs.max() < h.total - 2000.0


def test_the_configuration_and_cell_find_their_files():
    bench = harness.load_benchmark()
    cell, entry = harness.find_cell(bench, CELL)
    conf = harness.load_json(harness.ROOT, entry["file"])
    five_k = harness.load_json(harness.ROOT, "portbench", "configs",
                               "history1000-5120x2880-s2.json")
    assert entry["name"] == conf["name"] == cell["config"] == CONFIG
    assert cell["traffic"] == "readdown" and cell["chips"] == 1
    assert conf["viewport"] == [3840, 2160] and conf["scale"] == 2.0
    assert conf["chips"] == 1 and conf["WGIT_MESH"] == "0"
    assert conf["reduced"] == entry["reduced"] == []
    assert conf["reference"] == "portbench/reference.py"
    for key in ("history", "limits", "pane"):
        assert conf[key] == five_k[key], key
    assert len(entry["source"]) <= 200
    per = {m["name"] for m in harness.metrics_for(bench, CELL, "per_layer")}
    e2e = {m["name"] for m in harness.metrics_for(bench, CELL, "end_to_end")}
    assert e2e == {"device_ms_per_frame", "device_peak_mib", "setup_s"}
    assert per == {"k2_launches_per_frame", "k3_roofline",
                   "compose_served_share", "uploads_per_frame",
                   *NEW_METRICS}
    for name in NEW_METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "device_ms_per_frame"


def compose_window(frames: int, builds: int, px: int):
    """A window of `frames` composed frames as the harness's ctx has it,
    `builds` of them a plan build of `px` device pixels; the counters move
    before the window too."""
    tracing.next_frame()
    tracing.COUNTERS["compose.plan_builds"] += 5     # the warm-up
    tracing.COUNTERS["compose.built_px"] += 10**8
    rows = []
    for k in range(frames):
        a = time.perf_counter_ns()
        tracing.next_frame()
        tracing.COUNTERS["frames.composed"] += 1
        if k < builds:
            tracing.COUNTERS["compose.plan_builds"] += 1
            tracing.COUNTERS["compose.built_px"] += px
        b = time.perf_counter_ns()
        rows.append([a, a, a, b, b, b])
    return {"frames": frames, "window_s": 1.0, "trace": {},
            "phase_ns": np.array(rows, np.int64)}


def test_the_readers_on_a_window():
    ctx = compose_window(8, 6, 3840 * 2560)
    assert plan_builds_per_frame.read(ctx) == pytest.approx(0.75)
    assert build_mpx_per_frame.read(ctx) == pytest.approx(
        6 * 3840 * 2560 / 1e6 / 8)
    for change in ({"trace": None}, {"phase_ns": None}, {"frames": 0}):
        assert plan_builds_per_frame.read(dict(ctx, **change)) is None
        assert build_mpx_per_frame.read(dict(ctx, **change)) is None


def test_a_program_without_the_counters_gives_nothing(monkeypatch):
    """A program that counts no compose plan or layer build (the port
    before `compose.built_px`): the readers find nothing, and do not
    raise."""
    monkeypatch.setattr(tracing, "COUNTERS", {
        k: v for k, v in tracing.COUNTERS.items()
        if not k.startswith("compose.")})
    monkeypatch.setattr(tracing, "FRAME_LOG",
                        collections.deque(maxlen=tracing.FRAME_LOG_LEN))
    tracing.next_frame()
    rows = []
    for _ in range(3):
        a = time.perf_counter_ns()
        tracing.next_frame()
        rows.append([a] * 6)
    ctx = {"frames": 3, "window_s": 1.0, "trace": {},
           "phase_ns": np.array(rows, np.int64)}
    assert program.window_counters(ctx) is not None
    assert plan_builds_per_frame.read(ctx) is None
    assert build_mpx_per_frame.read(ctx) is None
