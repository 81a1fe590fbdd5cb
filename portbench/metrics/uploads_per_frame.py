"""Host-to-device copies a frame that the program's render path made in
the window (`upload.calls`, the program's counter, over the window's
frames): the frame blob, pair bins, chrome entries and layer builds."""

from ..program import window_counters


def read(ctx):
    c = window_counters(ctx)
    if c is None:
        return None
    return c["upload.calls"] / ctx["frames"]
