"""Compose plans built a composed frame in the window
(`compose.plan_builds` over `frames.composed`, the program's counters):
a plan is built where the scene's chrome, its windows' content or the
crop of a cached slab changed. Nothing where the program counts no plan
build or composed no frame."""

from ..program import window_counters


def read(ctx):
    c = window_counters(ctx)
    if c is None or "compose.plan_builds" not in c \
            or c.get("frames.composed", 0) <= 0:
        return None
    return c["compose.plan_builds"] / c["frames.composed"]
