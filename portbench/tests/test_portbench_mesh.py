"""The four-card cell's configuration through the harness on the CPU, and
the mesh's three readers (`metrics/mesh_served_share.py`,
`metrics/mesh_moved_kib_per_frame.py`, `metrics/mesh_busiest_card_share.py`).

On the CPU the harness's run of `history1000-1280x800-mesh4.wheel` takes
the mesh the renderer installs with `WGIT_MESH=4` over four entries, each
the CPU (`meshstate.CPU_DEVICES = 4`; the cell's own configuration sets no
`WGIT_MESH`, so on a machine of four cards the auto mesh takes all four):
every frame of the window is a mesh frame, judged by the same reference on
the gathered frame."""

import collections
import time

import numpy as np
import pytest

from portbench import harness, mesh_equal, program
from portbench.metrics import (
    mesh_busiest_card_share,
    mesh_moved_kib_per_frame,
    mesh_served_share,
)
from portbench.run import result_line
from portbench.tests.test_portbench_run import SEED, cell_args
from whisper_git_tpu_torch import tracing

CELL = "history1000-1280x800-mesh4.wheel"


@pytest.fixture
def cpu_mesh(monkeypatch):
    """A CPU mesh of four for the harness's renderer: a renderer made anew
    (the shared one installs its mesh as it is made), the mesh taken down
    and the layer caches cleared after."""
    from whisper_git_tpu_torch.render import compose, frame, meshstate
    from whisper_git_tpu_torch.render import renderer as R

    monkeypatch.setattr(meshstate, "CPU_DEVICES", 4)
    monkeypatch.setattr(R, "_RENDERERS", {})
    monkeypatch.setenv("WGIT_MESH", "4")     # the runs pin it again
    meshstate.set_render_mesh(None)
    compose.clear_caches()
    frame.clear_caches()
    yield
    meshstate.set_render_mesh(None)
    compose.clear_caches()
    frame.clear_caches()


def test_the_configuration_is_the_one_card_view_on_the_auto_mesh():
    bench, cell, conf, _ = cell_args(CELL)
    one = cell_args("history1000-1280x800.wheel")[2]
    assert cell["chips"] == conf["chips"] == 4 and "WGIT_MESH" not in conf
    assert conf["reduced"] == []
    assert conf["reference"] == one["reference"] == "portbench/reference.py"
    for key in ("viewport", "scale", "history", "pane", "limits",
                "min_rows"):
        assert conf[key] == one[key], key
    assert [w["name"] for w in bench["workloads"] if w["chips"] == 4] \
        == [CELL]


def test_a_mesh_run_is_correct_and_every_frame_a_mesh_frame(cpu_mesh):
    bench, cell, conf, t = cell_args(CELL)
    conf = dict(conf, WGIT_MESH="4")
    from whisper_git_tpu_torch.render import meshstate

    c0 = tracing.counters()
    out = harness.run_cell(cell, conf, t, SEED, 1.0, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    mesh = meshstate.get_render_mesh()
    assert mesh is not None and mesh.size == 4
    # The window's counters cover its frames; the CPU repeated copies
    # nothing. (The device trace, and so the line's counter metrics, needs
    # a card: a stand-in trace lets the readers read.)
    ctx = dict(out["ctx"], trace={})
    c = program.window_counters(ctx)
    n = ctx["frames"]
    assert c["mesh.frames"] == c["frames.composed"] == n
    assert c["mesh.shard_launches"] >= 4 * n
    assert mesh_served_share.read(ctx) == 100.0
    assert mesh_moved_kib_per_frame.read(ctx) == 0.0
    assert tracing.counters()["mesh.frames"] - c0["mesh.frames"] > n
    line = result_line(bench, cell, out, True, "cpu", [])
    assert line["correct"]
    assert not {"mesh_served_share", "mesh_moved_kib_per_frame",
                "mesh_busiest_card_share"} & set(line["metrics"])


def test_the_side_check_finds_every_mesh_frame_one_devices(cpu_mesh):
    """`mesh_equal.check` on the CPU mesh of four: the kept frames, drawn
    again with no mesh from empty caches, are each `torch.equal` to the
    gathered one, and that pass counts no mesh frame."""
    _, cell, conf, t = cell_args(mesh_equal.CELL)
    r = mesh_equal.check(cell, dict(conf, WGIT_MESH="4"), t, SEED, 0.3, 5,
                         "cpu")
    assert r["correct"] and r["mesh"] == ["cpu"] * 4
    assert r["frames_compared"] == 5 and r["equal"] == 5, r["unequal"]
    assert r["max_gap_u8"] == 0
    assert r["one_card_counts"]["mesh.frames"] == 0
    assert r["one_card_counts"]["frames.composed"] == 5


def mesh_window(frames: int, moved_per_frame: int):
    """A window of `frames` mesh frames as the harness's ctx has it, each
    moving `moved_per_frame` bytes between cards; the counters move before
    the window too."""
    tracing.next_frame()
    tracing.COUNTERS["mesh.frames"] += 3            # the warm-up
    rows = []
    for _ in range(frames):
        a = time.perf_counter_ns()
        tracing.next_frame()
        tracing.COUNTERS["mesh.frames"] += 1
        tracing.COUNTERS["mesh.shard_launches"] += 4
        b = time.perf_counter_ns()
        rows.append([a, a, a, b, b, b])
    return {"frames": frames, "window_s": 1.0,
            "phase_ns": np.array(rows, np.int64),
            "moved_bytes": frames * moved_per_frame,
            "trace": {"device_s_by_card": {0: 0.40, 1: 0.25, 2: 0.25,
                                           3: 0.10}}}


def test_the_readers_on_a_window():
    ctx = mesh_window(8, 2_785_280 + 3 * 4096)
    assert mesh_served_share.read(ctx) == pytest.approx(100.0)
    assert mesh_moved_kib_per_frame.read(ctx) == pytest.approx(2720.0 + 12)
    assert mesh_busiest_card_share.read(ctx) == pytest.approx(40.0)
    even = dict(ctx, trace={"device_s_by_card": {i: 0.2 for i in range(4)}})
    assert mesh_busiest_card_share.read(even) == pytest.approx(25.0)
    half = mesh_window(4, 0)
    tracing.COUNTERS["mesh.frames"] -= 2    # two frames drawn on one card
    assert mesh_served_share.read(half) == pytest.approx(50.0)
    assert mesh_moved_kib_per_frame.read(half) == 0.0


def test_nothing_to_read(monkeypatch):
    ctx = mesh_window(3, 1024)
    for change in ({"trace": None}, {"phase_ns": None}, {"frames": 0}):
        bad = dict(ctx, **change)
        assert mesh_served_share.read(bad) is None
        assert mesh_moved_kib_per_frame.read(bad) is None
    for trace in (None, {"device_s_by_card": {}},
                  {"device_s_by_card": {0: 0.0, 1: 0.0}}):
        assert mesh_busiest_card_share.read(dict(ctx, trace=trace)) is None


def test_a_program_without_the_mesh_counters_gives_nothing(monkeypatch):
    """A program that counts no mesh frame (the port before these
    counters): the counter readers find nothing, and do not raise."""
    monkeypatch.setattr(tracing, "COUNTERS", {
        k: v for k, v in tracing.COUNTERS.items()
        if not k.startswith("mesh.")})
    monkeypatch.setattr(tracing, "FRAME_LOG",
                        collections.deque(maxlen=tracing.FRAME_LOG_LEN))
    tracing.next_frame()
    rows = []
    for _ in range(3):
        a = time.perf_counter_ns()
        tracing.next_frame()
        rows.append([a] * 6)
    ctx = {"frames": 3, "window_s": 1.0, "moved_bytes": 0, "trace": {},
           "phase_ns": np.array(rows, np.int64)}
    assert program.window_counters(ctx) is not None
    assert mesh_served_share.read(ctx) is None
    assert mesh_moved_kib_per_frame.read(ctx) is None
