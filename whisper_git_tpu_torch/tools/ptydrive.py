"""Shared pty-drive plumbing for full-process harnesses.

A copy of the reference's `tools/ptydrive.py`, used by
tests/test_torch_pty.py and chip_smoke.py's `loop` phase so pty quirks
(EIO on child exit, drain cadence, wire-protocol markers) are fixed in
ONE place.
"""

from __future__ import annotations

import fcntl
import os
import select
import struct
import termios
import time

ALT_ENTER = b"\x1b[?1049h"
ALT_EXIT = b"\x1b[?1049l"
HALF_BLOCK = "▀".encode()


def open_sized_pty(rows: int, cols: int, xpx: int, ypx: int):
    """openpty with a real terminal geometry set on the slave side (the
    app derives its half-block grid and SGR-Pixels mapping from it)."""
    import pty

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ,
                struct.pack("HHHH", rows, cols, xpx, ypx))
    return master, slave


def drain(master: int, buf: bytearray, seconds: float,
          poll: float | None = None) -> int:
    """Read whatever arrives on `master` for `seconds`; returns byte
    count. EIO (child side closed) and EOF read as end-of-stream."""
    end = time.monotonic() + seconds
    got = 0
    while time.monotonic() < end:
        budget = end - time.monotonic()
        if poll is not None:
            budget = min(budget, poll)
        r, _, _ = select.select([master], [], [], max(0.0, budget))
        if not r:
            continue
        try:
            chunk = os.read(master, 65536)
        except OSError:   # EIO: child side closed
            return got
        if not chunk:
            return got
        buf += chunk
        got += len(chunk)
    return got


def wait_for(master: int, buf: bytearray, needle: bytes,
             timeout: float) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if needle in buf:
            return True
        drain(master, buf, 0.25)
    return needle in buf


def drain_pending(master: int, buf: bytearray) -> int:
    """Read whatever is ALREADY buffered on `master`, without waiting.
    Call before writing an input whose repaint latency will be measured
    — otherwise ambient repaint traffic (pulse animation, degraded
    present cadence) already in the pty buffer reads as an instant
    response."""
    got = 0
    while True:
        r, _, _ = select.select([master], [], [], 0)
        if not r:
            return got
        try:
            chunk = os.read(master, 65536)
        except OSError:
            return got
        if not chunk:
            return got
        buf += chunk
        got += len(chunk)


def wait_growth(master: int, buf: bytearray, timeout: float
                ) -> float | None:
    """Seconds until the FIRST new bytes arrive (a repaint), or None on
    timeout. Returns at the first chunk — the old implementation always
    ran a full 0.05 s drain cycle before reporting, putting a 50 ms
    floor under every latency it measured."""
    t0 = time.monotonic()
    end = t0 + timeout
    while True:
        remain = end - time.monotonic()
        if remain <= 0.0:
            return None
        r, _, _ = select.select([master], [], [], min(remain, 0.5))
        if not r:
            continue
        try:
            chunk = os.read(master, 65536)
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
        return time.monotonic() - t0
