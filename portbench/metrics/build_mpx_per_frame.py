"""Device pixels the compose path's layer builds wrote a frame in the
window, in millions (`compose.built_px`, the program's counter: a slab's
rows times its width, a chrome group's tile box, each time K2 builds one),
over the window's frames. Nothing where the program does not count them."""

from ..program import window_counters


def read(ctx):
    c = window_counters(ctx)
    if c is None or "compose.built_px" not in c:
        return None
    return c["compose.built_px"] / 1e6 / ctx["frames"]
