"""Device time a frame: the durations of every operation the profiler
records on the card with the most over the window (kernels and copies),
over the window's frames, in ms."""


def read(ctx):
    s = ctx.get("trace")
    if s is None or not s["device_s_by_card"] or not ctx["frames"]:
        return None
    return 1e3 * max(s["device_s_by_card"].values()) / ctx["frames"]
