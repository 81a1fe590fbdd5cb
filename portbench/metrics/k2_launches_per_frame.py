"""K2 launches a frame in the window (compose layer builds where the
frame composes)."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return ctx["launches"]["K2"] / ctx["frames"]
