"""The share of the window's compose attempts that compose served
(`frames.composed` over `compose.attempted`, the program's counters), in
%."""

from ..program import window_counters


def read(ctx):
    c = window_counters(ctx)
    if c is None or c["compose.attempted"] <= 0:
        return None
    return 100.0 * c["frames.composed"] / c["compose.attempted"]
