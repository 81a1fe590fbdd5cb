"""The per-layer metrics that read the program's own counters
(`program.py`, `metrics/compose_served_share.py`,
`metrics/uploads_per_frame.py`, `metrics/oversized_uploads_per_frame.py`)
and the span report (`spans.py`): the window's counts from the counters
as its first frame began, nothing read where there is nothing to read,
and the idle gaps named by the spans at their middle."""

import json
import sys
import time

import numpy as np
import pytest

from portbench import harness, program, spans
from portbench.metrics import (
    compose_served_share,
    oversized_uploads_per_frame,
    uploads_per_frame,
)
from whisper_git_tpu_torch import tracing
from whisper_git_tpu_torch.tracing import Span


def window_ctx(frames: int, work):
    """A window of `frames` frames as the harness's ctx has it, in which
    `work(i)` runs frame i's counted work after `next_frame()`; the
    counters move before the window too."""
    tracing.next_frame()
    tracing.COUNTERS["upload.calls"] += 7      # set-up and warm-up
    tracing.COUNTERS["compose.attempted"] += 5
    t0 = time.perf_counter_ns()
    rows = []
    for i in range(frames):
        a = time.perf_counter_ns()
        tracing.next_frame()
        work(i)
        b = time.perf_counter_ns()
        rows.append([a, a, a, b, b, b])
    return {"frames": frames, "trace": {}, "window_s": 1.0,
            "phase_ns": np.array(rows, np.int64), "t0": t0}


def composed_frames(i):
    tracing.COUNTERS["compose.attempted"] += 1
    if i % 4:
        tracing.COUNTERS["frames.composed"] += 1
    tracing.COUNTERS["upload.calls"] += 2


def test_the_window_counts_from_its_first_frame():
    ctx = window_ctx(8, composed_frames)
    c = program.window_counters(ctx)
    assert c["compose.attempted"] == 8 and c["frames.composed"] == 6
    assert c["upload.calls"] == 16
    assert compose_served_share.read(ctx) == pytest.approx(75.0)
    assert uploads_per_frame.read(ctx) == pytest.approx(2.0)
    assert oversized_uploads_per_frame.read(ctx) == pytest.approx(2.0)


def test_a_declining_window_reads_zero():
    def declined(i):
        tracing.COUNTERS["compose.attempted"] += 1
        tracing.COUNTERS["compose.declined_subpixel"] += 1
    ctx = window_ctx(5, declined)
    assert compose_served_share.read(ctx) == 0.0
    assert uploads_per_frame.read(ctx) == 0.0


def test_nothing_to_read():
    ctx = window_ctx(3, composed_frames)
    # No device trace (a run on the CPU), no spans of the frames
    # (`--trace 0`), no frames.
    for change in ({"trace": None}, {"phase_ns": None}, {"frames": 0}):
        bad = dict(ctx, **change)
        assert program.window_counters(bad) is None
        assert uploads_per_frame.read(bad) is None
        assert compose_served_share.read(bad) is None
    # A window after the newest frame the program logged.
    late = dict(ctx, phase_ns=ctx["phase_ns"] + 10**15)
    assert uploads_per_frame.read(late) is None
    # No compose attempt: no share.
    ctx = window_ctx(3, lambda i: None)
    assert compose_served_share.read(ctx) is None


def test_a_program_without_the_counters_gives_nothing(monkeypatch):
    import whisper_git_tpu_torch

    ctx = window_ctx(3, composed_frames)
    monkeypatch.delattr(whisper_git_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "whisper_git_tpu_torch.tracing", None)
    assert program.window_counters(ctx) is None
    assert uploads_per_frame.read(ctx) is None


def _span(sid, parent, name, t0, t1, tid=1):
    return Span(sid, parent, name, t0, t1, tid, 1, {})


def test_gap_names():
    ss = [_span(1, None, "render", 0, 100), _span(2, 1, "frame.pack", 10, 60),
          _span(3, None, "refresh.state", 40, 90, tid=2),
          _span(4, None, "gc", 50, 55, tid=1)]
    idx = spans.span_index(ss, 0, 1000)
    assert spans.gap_name("render_host", idx, 20, 1) \
        == "render_host/frame.pack"
    assert spans.gap_name("render_host", idx, 45, 1) \
        == "render_host/frame.pack+refresh.state"
    assert spans.gap_name("render_host", idx, 52, 1) \
        == "render_host/gc"
    assert spans.gap_name("render_host", idx, 70, 1) \
        == "render_host/render+refresh.state"
    assert spans.gap_name("between_frames", idx, 500, 1) == "between_frames"


def test_self_times():
    ss = [_span(1, None, "render", 0, 100), _span(2, 1, "frame.pack", 10, 60),
          _span(3, 1, "frame.launch", 60, 90), _span(4, 2, "gc", 20, 30)]
    assert spans.self_times(ss) == {"render": (1, 20), "frame.pack": (1, 40),
                                    "frame.launch": (1, 30), "gc": (1, 10)}


def test_span_cost_runs():
    c = spans.span_cost(2000)
    assert set(c) == {"n", "loop_ns", "off_ns", "on_ns"}
    assert 0 < c["off_ns"] <= c["on_ns"]
    assert not tracing.enabled()


def test_the_report_of_a_cpu_run():
    """`diagnose` on a short CPU window: spans on the frame's thread, the
    render step's children named, the counters (and so the metrics that
    read them) left out without the device trace."""
    from portbench.tests.test_portbench_run import cell_args

    _, cell, conf, t = cell_args("history1000-1280x800.wheel")
    r = spans.diagnose(cell, conf, t, 2**31 + 5, 0.3, None, "cpu")
    assert r["correct"] and r["frames"] > 0
    assert r["spans_per_frame"] >= 6
    assert {"input", "build", "layout", "compile", "render",
            "compose.plan", "compose.blob", "compose.launch"} \
        <= set(r["self_ms_per_frame"])
    assert r["counters"] is None and "idle_gaps" not in r
    json.dumps(r)
    assert not tracing.enabled()


def test_best_shift_finds_the_clocks_offset():
    """Copies made inside the sampled intervals, put 3.2 ms late on the
    host clock: the shift that fits them best moves them back."""
    ms = 1_000_000
    skip = [(k * 40 * ms, k * 40 * ms + 2 * ms) for k in range(1, 8)]
    copies = [(a + ms // 2 + 3_200_000, a + ms + 3_200_000)
              for a, _ in skip]
    assert spans.best_shift(copies, skip, reach_ns=0) == (0, 0)
    shift, n = spans.best_shift(copies, skip)
    assert n == len(copies)
    assert -3_800_000 <= shift <= -2_100_000
