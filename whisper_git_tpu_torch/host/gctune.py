"""Interactive GC policy — keep CPython gen2 collections off the frame
path.

At large-repo scale (10k CommitInfo rows + row-memo graphs) a gen2
collection walks the whole object graph: measured 300-740 ms pauses
landing at random frames of a scroll sweep (tests/test_scale.py found
them; with gen2 deferred the worst frame drops to ~50 ms). The policy
every interactive runtime uses applies here:

  * `install_interactive_gc()` after startup: `gc.freeze()` moves the
    boot-time object population (modules, atlases, fixtures) out of
    collection consideration entirely, and the gen2 threshold is raised
    so automatic full collections effectively never trigger inside a
    frame. Gen0/gen1 stay at defaults — they are sub-ms.
  * `idle_gc_tick(idle)` from the loop's housekeeping cadence: a full
    collection runs only when the user is idle (no input for a beat),
    at most every 15 s — plus a 90 s hard backstop so a session with no
    idle windows still cannot accumulate unbounded cycles.

Reference analog: none needed — Rust has no tracing GC, so the
reference gets its pause-free frames for free; this module buys the
same property back for the Python host (the no-sync-work-on-the-frame-
thread rule, the reference's docs/async-engine-redesign.md:27-31,
extended to the collector)."""

from __future__ import annotations

import gc
import time

_STATE = {"installed": False, "last_full": 0.0}

IDLE_EVERY_S = 15.0
BACKSTOP_S = 90.0


def install_interactive_gc() -> None:
    if _STATE["installed"]:
        return
    _STATE["installed"] = True
    gc.freeze()
    # gen2 follows gen1 at this many gen1 collections; 10_000 pushes the
    # automatic full collection out past any realistic frame window.
    g0, g1, _ = gc.get_threshold()
    gc.set_threshold(g0, g1, 10_000)
    _STATE["last_full"] = time.monotonic()


def idle_gc_tick(idle: bool) -> float | None:
    """Run the deferred full collection when allowed; returns its
    duration in ms when one ran (observability), else None."""
    if not _STATE["installed"]:
        return None
    now = time.monotonic()
    due = now - _STATE["last_full"]
    if (idle and due >= IDLE_EVERY_S) or due >= BACKSTOP_S:
        t0 = time.perf_counter()
        gc.collect()
        # Survivors of a full collect are long-lived (caches, memo
        # entries, library internals): freeze them so the NEXT collect
        # scans only newer objects — a backstop collect over a grown
        # heap is long enough to land as a frame-loop gap when no idle
        # window ever arrives. The app's
        # object graph is acyclic where it matters (El/LayoutNode/
        # chunk trees have no back-references), so refcounting still
        # frees evicted frozen entries; true frozen cycles are bounded
        # by the LRU caps and watched by the cache ledger.
        gc.freeze()
        _STATE["last_full"] = time.monotonic()
        ms = (time.perf_counter() - t0) * 1e3
        return ms
    return None
