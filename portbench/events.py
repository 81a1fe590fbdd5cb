"""The one traffic generator: a traffic file of parameters → the cycle of
input events a run repeats.

A traffic file (`traffic/<name>.json`) names its `kind` and the
parameters of that kind. Every event is a function of the seed and its
index alone, never of the clock, so every run sends the same events in the
same order and only the number of frames differs.

- `wheel`: wheel clicks of `step_px` through `WhisperApp.on_scroll`, in
  bursts of `burst_clicks` clicks that alternate direction, inside
  [0, `range_clicks`] clicks from the top; the cycle has at least
  `cycle_events` events and ends where it started.
- `drag`: the history scrollbar's thumb dragged through `_act_scroll_drag`
  (the route `scroll-drag:history:<dx>:<dy>`), `track_px` track pixels a
  frame in steps of `track_step`, down from about `start_track_px` to at
  most `share_of_track` of the 600 px track, then back up by the same
  steps in reverse. Content offsets move by the history's height over the
  track's; each step is the allowed one nearest to the drawn one that
  leaves the offset's fraction within `fraction` (the layout snaps offsets
  to 1/8 px, and compose serves an integer one). One lead-in event takes
  the view from the top to the cycle's start. The history's height comes
  from the reference's model of the seed's history.

`replay_offsets` works out the history's scroll offset after every event
with the app's arithmetic (a float64 sum, clamped to [0, total - 200]),
for the reference.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TRACK_PX = 600.0


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, stream])


def cycle(traffic: dict, seed: int, total: float) -> dict:
    """→ {"lead_in": [events], "cycle": [events]}; an event is (kind, dy)
    with dy in the unit its handler takes (content px for a wheel click,
    track px for a drag). `total` is the history's height in px."""
    kind = traffic["kind"]
    if kind == "wheel":
        return {"lead_in": [], "cycle": _wheel(traffic, seed)}
    if kind == "drag":
        return _drag(traffic, seed, total)
    raise ValueError(f"unknown traffic kind {kind!r}")


def _wheel(t: dict, seed: int) -> list:
    rng = _rng(seed, 11)
    top = int(t["range_clicks"])
    lo, hi = t["burst_clicks"]
    step = float(t["step_px"])
    at, down, out = 0, True, []
    while True:
        room = top - at if down else at
        n = min(int(rng.integers(lo, hi + 1)), room)
        if len(out) >= int(t["cycle_events"]) and not down:
            n = at                    # the last burst goes back to the top
        out += [("wheel", step if down else -step)] * n
        at += n if down else -n
        down = not down
        if len(out) >= int(t["cycle_events"]) and at == 0:
            return out


def _drag_step(s: float, units: int, q: float, total: float) -> float:
    """The offset after a drag of `units` track steps from `s`, as the
    app computes it."""
    tot = max(total, 1.0)
    d = float(f"{units * q:.2f}")
    return max(0.0, min(s + d * tot / TRACK_PX, max(0.0, tot - 200.0)))


def _drag(t: dict, seed: int, total: float) -> dict:
    rng = _rng(seed, 12)
    q = float(t["track_step"])
    lo, hi = (round(v / q) for v in t["track_px"])
    f_lo, f_hi = t["fraction"]
    end = round(float(t["share_of_track"]) * TRACK_PX / q)

    def ok(s):
        return f_lo <= s % 1.0 <= f_hi

    def nearest(s, want, top):
        """The allowed step nearest to `want` (at most `top`)."""
        for d in range(0, hi - lo + 1):
            for u in (want - d, want + d):
                if lo <= u <= min(hi, top) and ok(_drag_step(s, u, q, total)):
                    return u
        return None

    start = nearest(0.0, round(float(t["start_track_px"]) / q), end)
    s = _drag_step(0.0, start, q, total)
    steps, at = [], start
    while True:
        u = nearest(s, int(rng.integers(lo, hi + 1)), end - at)
        if u is None:
            break
        steps.append(u)
        at += u
        s = _drag_step(s, u, q, total)
    steps += [-u for u in reversed(steps)]
    return {"lead_in": [("drag", start * q)],
            "cycle": [("drag", u * q) for u in steps]}


def event_at(ev: dict, n: int):
    """The n-th event of a run: the lead-in, then the cycle over and
    over."""
    k = len(ev["lead_in"])
    if n < k:
        return ev["lead_in"][n]
    return ev["cycle"][(n - k) % len(ev["cycle"])]


def replay_offsets(ev: dict, n_events: int, total: float) -> np.ndarray:
    """The history's scroll offset after each of the first `n_events`
    events, as the app computes it from offset 0."""
    out = np.empty(n_events, np.float64)
    s = 0.0
    top = max(0.0, total - 200.0)
    tot = max(total, 1.0)
    for n in range(n_events):
        kind, dy = event_at(ev, n)
        if kind == "wheel":
            s = max(0.0, min(s + dy * 1.0, top))
        else:
            s = max(0.0, min(s + float(f"{dy:.2f}") * tot / TRACK_PX,
                             max(0.0, tot - 200.0)))
        out[n] = s
    return out
