"""The share of the window's frames whose device work a render mesh split
(`mesh.frames`, the program's counter, over the window's frames), in %."""

from ..program import window_counters


def read(ctx):
    c = window_counters(ctx)
    if c is None or "mesh.frames" not in c:
        return None
    return 100.0 * c["mesh.frames"] / ctx["frames"]
