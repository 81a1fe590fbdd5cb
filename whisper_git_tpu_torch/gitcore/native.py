"""ctypes loader for the native C++ gitcore (`libwgitcore.so`).

The native library accelerates the hot, frequently-polled paths (the 5 s
ref-fingerprint reconciliation, loose-ref parsing). Build with
`make -C native`. Every entry point has a pure-Python fallback in the
calling module, so the package works without the .so.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from .. import tracing

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates = [
        os.path.join(here, "native", "libwgitcore.so"),
        os.path.join(here, "libwgitcore.so"),
    ]
    env = os.environ.get("WGIT_NATIVE_LIB")
    if env:
        candidates.insert(0, env)
    for path in candidates:
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.wgit_ref_fingerprint.argtypes = [
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
                lib.wgit_ref_fingerprint.restype = ctypes.c_int
                if hasattr(lib, "wgit_quick_dirty"):
                    lib.wgit_quick_dirty.argtypes = [
                        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
                    lib.wgit_quick_dirty.restype = ctypes.c_int
                if hasattr(lib, "wgit_status_scan"):
                    lib.wgit_status_scan.argtypes = [
                        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                        ctypes.POINTER(ctypes.c_long)]
                    lib.wgit_status_scan.restype = ctypes.c_void_p
                _LIB = lib
                break
            except (OSError, AttributeError):
                # AttributeError: a loadable but stale .so missing the
                # symbol must fall back to pure Python, same as no .so.
                continue
    return _LIB


def available() -> bool:
    return _lib() is not None


def ref_fingerprint(git_dir: str, common_dir: str) -> Optional[str]:
    lib = _lib()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(64)
    rc = lib.wgit_ref_fingerprint(git_dir.encode(), common_dir.encode(), buf, 64)
    if rc != 0:
        return None
    return buf.value.decode()


# Bitmask returned by quick_dirty (keep in sync with native/statusscan.cc).
DIRTY_STAGED = 1
DIRTY_UNSTAGED = 2
DIRTY_UNTRACKED = 4
DIRTY_CONFLICTED = 8

# Certain-vs-fallback telemetry: the scanner's honesty contract says it
# refuses whenever a repo feature could make it disagree with `git
# status` — these counters measure how often that actually happens, so
# the "0.06 ms typical" claim is bounded by data, not hope. Printed to
# stderr under WGIT_FRAME_DIAG=1 (every 50 verdicts per kind), and
# snapshot with the program's other counters (`tracing.counters()`, as
# `scan.<kind>`).
SCAN_STATS = {"quick_certain": 0, "quick_fallback": 0,
              "status_certain": 0, "status_fallback": 0}
tracing.register_counters("scan", SCAN_STATS)


def scan_stats() -> dict:
    """Snapshot of the certain-vs-fallback counters (+ derived rates)."""
    s = dict(SCAN_STATS)
    for kind in ("quick", "status"):
        total = s[f"{kind}_certain"] + s[f"{kind}_fallback"]
        s[f"{kind}_fallback_rate"] = (
            s[f"{kind}_fallback"] / total if total else 0.0)
    return s


def reset_scan_stats() -> None:
    for k in SCAN_STATS:
        SCAN_STATS[k] = 0


def _count_verdict(kind: str, certain: bool) -> None:
    key = f"{kind}_{'certain' if certain else 'fallback'}"
    SCAN_STATS[key] += 1
    if os.environ.get("WGIT_FRAME_DIAG"):
        total = (SCAN_STATS[f"{kind}_certain"]
                 + SCAN_STATS[f"{kind}_fallback"])
        if total % 50 == 0 or not certain:
            import sys

            fb = SCAN_STATS[f"{kind}_fallback"]
            print(f"statusscan[{kind}]: {fb}/{total} fallbacks "
                  f"({100.0 * fb / total:.1f}%)", file=sys.stderr)


def quick_dirty(workdir: str, git_dir: str,
                common_dir: str) -> Optional[int]:
    """Subprocess-free dirty check via the native scanner (index parse +
    object-store HEAD-tree compare + stat walk + gitignore engine). Returns
    a DIRTY_* bitmask (0 = certainly clean), or None when the native library
    is absent or the repository uses features the scanner cannot certify
    (sha256, split/sparse/v4 index, autocrlf, content filters) — callers
    must then fall back to `git status`."""
    lib = _lib()
    if lib is None or not hasattr(lib, "wgit_quick_dirty"):
        return None
    rc = lib.wgit_quick_dirty(
        workdir.encode(), git_dir.encode(), common_dir.encode())
    _count_verdict("quick", rc >= 0)
    if rc < 0:
        return None
    return rc


def status_scan(workdir: str, git_dir: str,
                common_dir: str) -> Optional[list[tuple[int, str, str, str]]]:
    """Full status via the native scanner: a porcelain-equivalent record
    list [(bucket, letter, path, orig_path)] — bucket 0 staged / 1 unstaged /
    2 untracked / 3 conflicted, letters A M D R T U ?, paths sorted within
    each bucket. Returns None when the library is absent or the scanner
    declines to certify (incl. possible content-similarity renames, which
    only git can adjudicate)."""
    lib = _lib()
    if lib is None or not hasattr(lib, "wgit_status_scan"):
        return None
    ln = ctypes.c_long(0)
    ptr = lib.wgit_status_scan(
        workdir.encode(), git_dir.encode(), common_dir.encode(),
        ctypes.byref(ln))
    _count_verdict("status", bool(ptr) and ln.value >= 0)
    if not ptr or ln.value < 0:
        return None
    data = ctypes.string_at(ptr, ln.value)
    records = []
    off = 0
    while off < len(data):
        bucket = data[off] - 0x30
        letter = chr(data[off + 1])
        end = data.index(b"\0", off + 2)
        path = data[off + 2:end].decode("utf-8", "surrogateescape")
        end2 = data.index(b"\0", end + 1)
        orig = data[end + 1:end2].decode("utf-8", "surrogateescape")
        records.append((bucket, letter, path, orig))
        off = end2 + 1
    return records
