"""Crash logging: breadcrumb ring buffer + exception-hook crash reports +
clean-exit marker + log pruning.

Capability parity with reference src/crash_log.rs: 50-entry
[elapsed][thread] ring buffer (:23-76), hook writing a full report
(sysinfo + panic + breadcrumbs + backtrace) to
~/.config/whisper-git/crashes/crash-<ts>.log (:213), clean-exit marker +
crash-since-last-exit detection (:278-312), pruning (:315).
"""

from __future__ import annotations

import os
import platform
import sys
import threading
import time
import traceback
from collections import deque
from typing import Optional

RING_SIZE = 50      # reference: crash_log.rs:23
MAX_CRASH_LOGS = 20

_start = time.monotonic()
_ring: "deque[str]" = deque(maxlen=RING_SIZE)
_ring_lock = threading.Lock()
_prev_excepthook = None


def _crash_dir() -> str:
    base = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    path = os.path.join(base, "whisper-git", "crashes")
    os.makedirs(path, exist_ok=True)
    return path


def _marker_path() -> str:
    return os.path.join(_crash_dir(), ".clean-exit")


def init() -> None:
    """reference: crash_log.rs:35 — start the session, clear the marker."""
    _ring.clear()
    try:
        if os.path.exists(_marker_path()):
            os.unlink(_marker_path())
    except OSError:
        pass
    breadcrumb("session started")


def breadcrumb(message: str) -> None:
    """reference: crash_log.rs:41 — [elapsed][thread] message."""
    elapsed = time.monotonic() - _start
    name = threading.current_thread().name
    with _ring_lock:
        _ring.append(f"[{elapsed:9.3f}][{name}] {message}")


def breadcrumbs() -> list[str]:
    with _ring_lock:
        return list(_ring)


def write_crash_report(exc_type, exc, tb) -> Optional[str]:
    """reference: install_panic_hook body, crash_log.rs:213."""
    ts = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(_crash_dir(), f"crash-{ts}.log")
    try:
        with open(path, "w", encoding="utf-8") as f:
            f.write("=== whisper-git-tpu crash report ===\n")
            f.write(f"time: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
            f.write(f"platform: {platform.platform()}\n")
            f.write(f"python: {sys.version.split()[0]}\n")
            f.write(f"uptime: {time.monotonic() - _start:.1f}s\n\n")
            f.write("--- exception ---\n")
            f.write("".join(traceback.format_exception(exc_type, exc, tb)))
            f.write("\n--- breadcrumbs (oldest first) ---\n")
            for line in breadcrumbs():
                f.write(line + "\n")
        prune_crash_logs()
        return path
    except OSError:
        return None


def install_panic_hook() -> None:
    """reference: crash_log.rs:213."""
    global _prev_excepthook
    _prev_excepthook = sys.excepthook

    def hook(exc_type, exc, tb):
        path = write_crash_report(exc_type, exc, tb)
        if path:
            print(f"crash report written to {path}", file=sys.stderr)
        if _prev_excepthook:
            _prev_excepthook(exc_type, exc, tb)

    sys.excepthook = hook


def mark_clean_exit() -> None:
    """reference: crash_log.rs:278."""
    try:
        with open(_marker_path(), "w") as f:
            f.write(str(int(time.time())))
    except OSError:
        pass


def has_crash_since_last_exit() -> Optional[str]:
    """Newest crash log newer than the last clean exit
    (reference: crash_log.rs:288)."""
    try:
        marker_mtime = os.path.getmtime(_marker_path())
    except OSError:
        marker_mtime = 0.0
    newest: Optional[str] = None
    newest_mtime = marker_mtime
    try:
        for name in os.listdir(_crash_dir()):
            if not name.startswith("crash-"):
                continue
            full = os.path.join(_crash_dir(), name)
            mtime = os.path.getmtime(full)
            if mtime > newest_mtime:
                newest_mtime = mtime
                newest = full
    except OSError:
        pass
    return newest


def prune_crash_logs(keep: int = MAX_CRASH_LOGS) -> None:
    """reference: crash_log.rs:315."""
    try:
        logs = sorted(
            (os.path.join(_crash_dir(), n) for n in os.listdir(_crash_dir())
             if n.startswith("crash-")),
            key=os.path.getmtime, reverse=True)
        for path in logs[keep:]:
            os.unlink(path)
    except OSError:
        pass
