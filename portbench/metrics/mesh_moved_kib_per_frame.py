"""Bytes the render mesh copied between cards a frame in the window, in
KiB: the frame's inputs replicated to the shards, compose's layers
committed to every shard and the slices gathered onto the first card
(`moved.replicas` + `moved.layers` + `moved.gather`, the program's
`frame.MOVED`, which the harness reads around the window), over the
window's frames. Nothing where the program counts no mesh frame
(`mesh.frames`)."""

from ..program import window_counters


def read(ctx):
    c = window_counters(ctx)
    if c is None or "mesh.frames" not in c:
        return None
    return ctx["moved_bytes"] / 1024.0 / ctx["frames"]
