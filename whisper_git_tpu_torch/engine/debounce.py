"""Dual-lane debounce thread (invariant #1's second half).

Capability parity with reference src/watcher.rs:506-607
(`spawn_debounce_thread`): two lanes — metadata/structure (150 ms) and
working-tree (500 ms) — each with a 2 s hard cap so sustained activity can't
defer a refresh forever. Within a lane window, the highest-priority kind
wins (max-priority coalescing).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from .proxy import EventLoopProxy
from .watcher import DEBOUNCE_HARD_CAP_MS, FsChangeKind


def spawn_debounce_thread(
    raw_queue: "queue.Queue[FsChangeKind]",
    out_queue: "queue.Queue[FsChangeKind]",
    proxy: Optional[EventLoopProxy] = None,
    hard_cap_ms: int = DEBOUNCE_HARD_CAP_MS,
) -> threading.Event:
    """Returns a stop Event; set it to terminate the thread."""
    stop = threading.Event()

    def lane_of(kind: FsChangeKind) -> int:
        return 0 if kind is FsChangeKind.WORKING_TREE else 1

    def worker():
        # Per-lane state: pending kind (max-priority), window deadline,
        # window start (for the hard cap).
        pending: list[Optional[FsChangeKind]] = [None, None]
        deadline: list[float] = [0.0, 0.0]
        started: list[float] = [0.0, 0.0]

        while not stop.is_set():
            now = time.monotonic()
            # Flush any lane whose window elapsed or hit the hard cap.
            for lane in (1, 0):  # metadata lane first (snappier)
                k = pending[lane]
                if k is None:
                    continue
                capped = (now - started[lane]) * 1000.0 >= hard_cap_ms
                if now >= deadline[lane] or capped:
                    pending[lane] = None
                    out_queue.put(k)
                    if proxy is not None:
                        proxy.send_event()
            # Compute wait: nearest pending deadline, else idle poll.
            # `is not None`, NOT truthiness: FsChangeKind.WORKING_TREE
            # is IntEnum 0 — falsy — and its lane's deadline would be
            # silently dropped from the wait (flushes would ride the
            # 0.1 s idle poll instead of the computed lane deadline).
            waits = [max(0.0, deadline[l] - now) for l in (0, 1)
                     if pending[l] is not None]
            timeout = min(waits) if waits else 0.1
            try:
                kind = raw_queue.get(timeout=max(timeout, 0.001))
            except queue.Empty:
                continue
            lane = lane_of(kind)
            now = time.monotonic()
            if pending[lane] is None:
                started[lane] = now
                pending[lane] = kind
            elif kind > pending[lane]:
                pending[lane] = kind  # max-priority coalescing
            deadline[lane] = now + kind.debounce_ms / 1000.0

    threading.Thread(target=worker, daemon=True, name="fs-debounce").start()
    return stop
