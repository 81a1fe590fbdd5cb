"""The traffic generator: events are a function of the seed and their
index, wheel offsets are whole pixels, drag offsets fractional, and no
cycle comes near the history's bottom."""

import json
import os

import numpy as np
import pytest

from portbench import events, reference, repo

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEEDS = (7, 2**33 + 11, 2**31 + 5)


def history_total(seed):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "history1000-1280x800.json")) as f:
        spec = json.load(f)["history"]
    commits = repo.history(seed, spec)
    return reference.History(repo.display_order(commits), 1_790_000_000)


@pytest.mark.parametrize("name", ["wheel", "drag"])
def test_one_seed_gives_one_cycle(name):
    t = events.load(name)
    h = history_total(SEEDS[1])
    a = events.cycle(t, SEEDS[1], h.total)
    b = events.cycle(t, SEEDS[1], h.total)
    c = events.cycle(t, SEEDS[2], h.total)
    assert a == b
    assert a != c


def test_wheel_offsets_are_whole_and_in_range():
    t = events.load("wheel")
    for seed in SEEDS:
        h = history_total(seed)
        ev = events.cycle(t, seed, h.total)
        assert len(ev["cycle"]) >= t["cycle_events"]
        offs = events.replay_offsets(ev, 3 * len(ev["cycle"]), h.total)
        assert np.all(offs == np.round(offs))
        assert np.all(offs % t["step_px"] == 0)
        assert offs.min() >= 0 and offs.max() <= t["range_clicks"] * 84
        # The cycle ends where it started.
        assert offs[len(ev["cycle"]) - 1] == 0.0
        assert {abs(dy) for _, dy in ev["cycle"]} == {84.0}


def test_drag_offsets_are_fractional():
    t = events.load("drag")
    for seed in SEEDS:
        h = history_total(seed)
        ev = events.cycle(t, seed, h.total)
        n = len(ev["lead_in"]) + 3 * len(ev["cycle"])
        offs = events.replay_offsets(ev, n, h.total)
        frac = offs % 1.0
        assert frac.min() >= 0.25 - 1e-9 and frac.max() <= 0.75 + 1e-9
        # Snapped to 1/8 px as the layout does, no offset is whole.
        snapped = np.round(offs * 8.0) / 8.0
        assert np.all(snapped != np.round(snapped))
        steps = [dy for _, dy in ev["cycle"]]
        assert all(1.0 <= abs(d) <= 8.0 and (abs(d) * 4) % 1 == 0
                   for d in steps)
        assert offs.max() <= 0.8 * h.total + 1e-6
        # Down, then back by the same steps.
        assert abs(sum(steps)) < 1e-9


@pytest.mark.parametrize("name", ["wheel", "drag"])
def test_no_cycle_reaches_the_bottom(name):
    t = events.load(name)
    for seed in SEEDS:
        h = history_total(seed)
        ev = events.cycle(t, seed, h.total)
        n = len(ev["lead_in"]) + 2 * len(ev["cycle"])
        offs = events.replay_offsets(ev, n, h.total)
        assert offs.max() < h.total - 2000.0


def test_event_index_wraps_the_cycle():
    t = events.load("drag")
    h = history_total(SEEDS[0])
    ev = events.cycle(t, SEEDS[0], h.total)
    k, L = len(ev["lead_in"]), len(ev["cycle"])
    assert events.event_at(ev, 0) == ev["lead_in"][0]
    assert events.event_at(ev, k + 5) == events.event_at(ev, k + 5 + 7 * L)
