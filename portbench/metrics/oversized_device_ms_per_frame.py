"""Device time a frame, as `device_ms_per_frame` reads it, in the cells
whose frames take the oversized path: a bound of their own, since their
pageable uploads spread wider from run to run (PERF.md)."""

from .device_ms_per_frame import read  # noqa: F401
