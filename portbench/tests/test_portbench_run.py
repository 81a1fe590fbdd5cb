"""Whole runs of the harness on the CPU, with the look for a card left
out: a sound run is correct, and each fault the cells can have, planted
under the timed path, and the control in the program's place, make
`correct` false. Short cycles and windows keep them in a test's time; the
frames are the cells' own size."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import harness, reference
from portbench.run import result_line

SEED = 3 * 2**31 + 1


def cell_args(name):
    bench = harness.load_benchmark()
    cell, entry = harness.find_cell(bench, name)
    conf = harness.load_json(harness.ROOT, entry["file"])
    t = harness.load_json(harness.HERE, "traffic", f"{cell['traffic']}.json")
    if t["kind"] == "wheel":
        t.update(cycle_events=6, range_clicks=3)
    else:
        t.update(share_of_track=0.03, track_px=[2.0, 8.0])
    return bench, cell, conf, t


def run(name, seconds=1.0, trace=False, wrap=None):
    bench, cell, conf, t = cell_args(name)
    out = harness.run_cell(cell, conf, t, SEED, seconds, trace, "cpu",
                           wrap=wrap)
    return bench, cell, out


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    bench, cell, out = run("history1000-1280x800.wheel", trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 6
    line = result_line(bench, cell, out, trace, "cpu", [])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    json.dumps(line)
    want = harness.metrics_for(bench, cell["name"],
                               "per_layer" if trace else "end_to_end")
    names = {m["name"] for m in want}
    if trace:
        # The counters; the device's metrics need the card.
        assert set(line["metrics"]) == {"k2_launches_per_frame"} <= names
        assert len(out["ctx"]["phase_ns"]) == out["attempted"]
    else:
        assert set(line["metrics"]) == {"setup_s"} <= names


def test_drag_run_is_correct():
    _, _, out = run("history1000-1280x800.drag", seconds=1.0)
    assert out["correct"], out["checks"]


def stale(path):
    """A step that returns its state unchanged: the input is dropped."""
    return dict(path, handle=lambda e: None)


def altered(path):
    """An answer altered where it is produced: a block of the frame."""
    render = path["render"]

    def r(scene):
        img = render(scene).clone()
        img[200:216, 400:432, :3] ^= 0x20
        return img
    return dict(path, render=r)


def shards_missing(path):
    """The exchange between cards left out: the rows past the first
    card's slice (13 tile rows over 4 cards: 4 rows of 64 px) never
    gathered."""
    render = path["render"]

    def r(scene):
        img = render(scene).clone()
        img[256:] = 0
        return img
    return dict(path, render=r)


def control(path):
    """The control in the program's place: the reference in bfloat16."""
    tex, _ = reference.font_atlas(harness.ROOT)

    def r(scene):
        layers = reference.splice(harness.capture(scene))
        return reference.raster(layers, scene.height, scene.width,
                                scene.background, tex, scene.image_atlas,
                                "cpu", dtype=torch.bfloat16)
    return dict(path, render=r)


@pytest.mark.parametrize("fault,check", [
    (stale, "row_err_px"), (altered, "frame_gap_u8"),
    (shards_missing, "frame_gap_u8"), (control, "frame_gap_u8")])
def test_a_broken_path_is_not_correct(fault, check):
    _, _, out = run("history1000-1280x800.wheel", seconds=1.5, wrap=fault)
    assert not out["correct"]
    assert out["failed"] > 0
    c = out["checks"][check]
    assert c["value"] > c["limit"]


def scene_fault(change):
    """A fault planted in the scene `compile_frame` returns: `change`
    maps each scroll window's part to a broken one."""
    def wrap(path):
        comp = path["compile"]

        def c():
            sc = comp()
            return dataclasses.replace(
                sc, windows=[change(w) for w in sc.windows])
        return dict(path, compile=c)
    return wrap


def _chunks(w, **arrays):
    return dataclasses.replace(w, comp=dataclasses.replace(w.comp, **arrays))


shifted_down = scene_fault(lambda w: dataclasses.replace(w, dy=w.dy + 3.0))
shifted_right = scene_fault(lambda w: dataclasses.replace(w, dx=w.dx + 6.0))
one_letter = scene_fault(lambda w: _chunks(
    w, glyphs=np.concatenate([w.comp.glyphs[:, :4],
                              np.repeat(w.comp.glyphs[-1:, 4:6],
                                        len(w.comp.glyphs), axis=0),
                              w.comp.glyphs[:, 6:]], axis=1)
    if len(w.comp.glyphs) else w.comp.glyphs))
no_avatars = scene_fault(lambda w: _chunks(
    w, images=w.comp.images[:0], image_clips=w.comp.image_clips[:0]))


@pytest.mark.parametrize("fault,check", [
    (shifted_down, "row_err_px"), (shifted_right, "row_err_px"),
    (one_letter, "text_err_rows"), (no_avatars, "text_err_rows")])
def test_a_scene_off_the_model_is_not_correct(fault, check):
    _, _, out = run("history1000-1280x800.wheel", seconds=0.5, wrap=fault)
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"], out["checks"]


def test_traced_spans_time_compile_frame_itself():
    """A traced run calls `compile_frame` once a frame, as an untraced run
    does, and the renderer's own layout stamps the spans inside it."""
    calls = []

    def count(path):
        comp = path["compile"]

        def c():
            calls.append(1)
            return comp()
        return dict(path, compile=c)

    _, _, out = run("history1000-1280x800.wheel", seconds=0.3, trace=True,
                    wrap=count)
    ph = out["ctx"]["phase_ns"]
    n = out["attempted"]
    assert n and len(ph) == n
    assert len(calls) == n + 6          # the warm-up's cycle, then the window
    assert (ph[:, 1] > ph[:, 0]).all()
    assert (np.diff(ph, axis=1) >= 0).all()
