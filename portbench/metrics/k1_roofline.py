"""K1's share of its roofline over the window (`counts.py`), in %."""

from . import roofline


def read(ctx):
    return roofline(ctx, "K1")
