"""The program's own counters over a run's window, for the per-layer
metrics that read them (`metrics/compose_served_share.py`,
`metrics/uploads_per_frame.py`, `metrics/oversized_uploads_per_frame.py`).

The port counts what its frame path does in `whisper_git_tpu_torch.tracing`
(always on), and keeps the counters as each frame began. A traced run's
`phase_ns` holds the host time at which the window's first frame started,
so the window's counts are the counters now (read after the window, when
the program has run nothing more) less the counters as that frame began.
A program without those counters gives nothing to read, and so does a
run without the device trace that the metrics' end-to-end metrics come
from."""

from __future__ import annotations


def window_counters(ctx: dict) -> dict | None:
    """The program's counters over the window (name -> count), or None
    where there is nothing to read."""
    if ctx.get("trace") is None or ctx.get("phase_ns") is None \
            or not ctx.get("frames"):
        return None
    try:
        from whisper_git_tpu_torch import tracing
    except ImportError:
        return None
    counters_at = getattr(tracing, "counters_at", None)
    if counters_at is None:
        return None
    start = counters_at(int(ctx["phase_ns"][0][0]))
    if start is None:
        return None
    now = tracing.counters()
    return {k: now[k] - v for k, v in start.items()}
