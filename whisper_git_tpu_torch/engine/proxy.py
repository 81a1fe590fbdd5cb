"""EventLoopProxy — the wake/doorbell primitive.

The reference uses winit's EventLoopProxy<()> (reference: src/host.rs:195-204)
to wake the render loop when a worker finishes. Ours is a thread-safe flag +
optional callback; the host frame loop waits on it with a timeout (the timer
safety nets need periodic wakeups anyway).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class EventLoopProxy:
    def __init__(self, on_wake: Optional[Callable[[], None]] = None):
        self._event = threading.Event()
        self._on_wake = on_wake
        self._lock = threading.Lock()
        self.wake_count = 0  # for tests / diagnostics

    def send_event(self) -> None:
        """Ring the doorbell (callable from any thread)."""
        with self._lock:
            self.wake_count += 1
        self._event.set()
        if self._on_wake is not None:
            self._on_wake()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Host-side: block until woken (or timeout). Clears the flag
        only when it actually fired — clearing unconditionally would
        discard a send_event() landing between the wait's timeout return
        and the clear (lost wakeup: the finished worker's result would
        sit unprocessed until the next timer tick)."""
        fired = self._event.wait(timeout)
        if fired:
            self._event.clear()
        return fired

    def pending(self) -> bool:
        return self._event.is_set()
