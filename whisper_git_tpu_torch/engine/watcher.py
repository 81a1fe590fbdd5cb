"""Filesystem watcher with three-tier event classification (invariant #1)
and async construction (invariant #6).

Capability parity with reference src/watcher.rs: recursive watch on the
workdir + non-recursive on git_dir/common_dir + recursive refs + worktrees
dir + each linked worktree root and its parent dir; 3-tier `FsChangeKind`
classifier; hot-swappable submodule exclusion; watch-set diffing; watcher
errors synthesize a GitMetadata full refresh (reference: watcher.rs:179-183).

Backend: raw inotify via ctypes on libc (Linux). When inotify is
unavailable (non-Linux, seccomp-restricted container), spawn_init
delivers an error result and NO events flow — the app then runs on its
timer safety nets alone (30 s status re-query + 5 s ref-fingerprint
reconciliation, docs/async-engine.md invariants #8/#9), the same
degraded mode a watcher error at runtime produces. There is
deliberately no mtime-polling backend: a shallow scan cheap enough to
run continuously would miss deep edits anyway, making it a less honest
version of the nets that already exist.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import queue
import select
import struct
import threading
from dataclasses import dataclass
from enum import IntEnum
from typing import Optional

from .proxy import EventLoopProxy

# Debounce constants (reference: watcher.rs:48-54).
DEBOUNCE_WORKING_TREE_MS = 500
DEBOUNCE_GIT_METADATA_MS = 150
DEBOUNCE_HARD_CAP_MS = 2000


class FsChangeKind(IntEnum):
    """Priority-ordered change classification (reference: watcher.rs:58-84).
    Higher value = higher priority when coalescing."""

    WORKING_TREE = 0       # file edits outside .git (500 ms lane)
    GIT_METADATA = 1       # HEAD/refs/index/... (150 ms lane)
    WORKTREE_STRUCTURE = 2 # worktrees/ add/remove (150 ms lane)

    @property
    def debounce_ms(self) -> int:
        return (DEBOUNCE_WORKING_TREE_MS if self is FsChangeKind.WORKING_TREE
                else DEBOUNCE_GIT_METADATA_MS)


# Git-dir entries whose change means "refs/HEAD/index moved" (reference:
# classify_git_path, watcher.rs:466).
_GIT_META_FILES = {
    "HEAD", "index", "packed-refs", "MERGE_HEAD", "CHERRY_PICK_HEAD",
    "REVERT_HEAD", "BISECT_LOG", "FETCH_HEAD", "ORIG_HEAD", "MERGE_MSG",
    "COMMIT_EDITMSG",
}
_GIT_META_DIRS = ("refs", "logs", "rebase-merge", "rebase-apply")


def classify_git_path(rel_path: str) -> Optional[FsChangeKind]:
    """Classify a path *relative to a git dir*. Returns None for noise
    (objects/, tmp files) that should not trigger any refresh."""
    rel_path = rel_path.strip("/")
    if not rel_path:
        return FsChangeKind.GIT_METADATA
    parts = rel_path.split("/")
    head = parts[0]
    if head == "worktrees":
        # worktrees/<name> or worktrees/<name>/<file> at depth ≤ 2 is
        # structural (add/remove/lock); deeper is that worktree's metadata.
        if len(parts) <= 2:
            return FsChangeKind.WORKTREE_STRUCTURE
        return FsChangeKind.GIT_METADATA
    if head in _GIT_META_FILES:
        return FsChangeKind.GIT_METADATA
    if head in _GIT_META_DIRS:
        return FsChangeKind.GIT_METADATA
    if head == "objects":
        return None  # object writes precede ref moves; the ref move triggers
    if head.endswith(".lock") or head.endswith(".tmp"):
        return None
    return None


@dataclass(frozen=True)
class WatchConfig:
    """The path sets that drive classification."""

    workdir: Optional[str]
    git_dir: str
    common_dir: str
    worktree_roots: tuple[str, ...] = ()
    submodule_paths: tuple[str, ...] = ()  # absolute paths to exclude


def _norm_cfg(cfg: WatchConfig) -> tuple:
    """Per-config normalized (git_dir, common_dir, workdir) — static for
    the config's lifetime; normalizing them per EVENT wasted hot-path
    work during thousand-event bursts (checkout, branch switch)."""
    cached = _NORM_CACHE.get(id(cfg))
    if cached is None or cached[0] is not cfg:
        cached = (cfg,
                  os.path.abspath(cfg.git_dir),
                  os.path.abspath(cfg.common_dir),
                  os.path.abspath(cfg.workdir) if cfg.workdir else None)
        if len(_NORM_CACHE) > 64:
            _NORM_CACHE.clear()
        _NORM_CACHE[id(cfg)] = cached
    return cached


_NORM_CACHE: dict = {}


def classify_event(path: str, cfg: WatchConfig,
                   is_create_or_delete: bool = False) -> Optional[FsChangeKind]:
    """Classify an absolute event path (reference: watcher.rs:384-462)."""
    path = os.path.abspath(path)
    _, norm_git_dir, norm_common_dir, norm_workdir = _norm_cfg(cfg)
    # Worktree root create/delete is structural; an edit *inside* a linked
    # worktree is a working-tree change for that worktree.
    for root in cfg.worktree_roots:
        if path == root:
            return FsChangeKind.WORKTREE_STRUCTURE if is_create_or_delete \
                else FsChangeKind.WORKING_TREE
        if path.startswith(root + os.sep):
            inner = path[len(root) + 1:]
            if inner == ".git" or inner.startswith(".git" + os.sep):
                rel = inner[4:].lstrip(os.sep)
                return classify_git_path(rel) if rel else FsChangeKind.GIT_METADATA
            return FsChangeKind.WORKING_TREE
    # Inside the git dir / common dir?
    for gd in (norm_git_dir, norm_common_dir):
        if path == gd:
            return FsChangeKind.GIT_METADATA
        if path.startswith(gd + os.sep):
            return classify_git_path(path[len(gd) + 1:])
    # Submodule exclusion (invariant #4, second layer): events under a
    # submodule never count as parent working-tree changes.
    for sub in cfg.submodule_paths:
        if path == sub or path.startswith(sub + os.sep):
            return None
    if norm_workdir:
        wd = norm_workdir
        if path.startswith(wd + os.sep) or path == wd:
            inner = path[len(wd):].lstrip(os.sep)
            if inner == ".git" or inner.startswith(".git" + os.sep):
                rel = inner[4:].lstrip(os.sep)
                return classify_git_path(rel) if rel else FsChangeKind.GIT_METADATA
            return FsChangeKind.WORKING_TREE
    return None


# ---------------------------------------------------------------------------
# inotify backend (ctypes on libc).
# ---------------------------------------------------------------------------

_IN_MODIFY = 0x0002
_IN_ATTRIB = 0x0004
_IN_CLOSE_WRITE = 0x0008
_IN_MOVED_FROM = 0x0040
_IN_MOVED_TO = 0x0080
_IN_CREATE = 0x0100
_IN_DELETE = 0x0200
_IN_DELETE_SELF = 0x0400
_IN_MOVE_SELF = 0x0800
_IN_ISDIR = 0x40000000
_IN_Q_OVERFLOW = 0x4000
_IN_IGNORED = 0x8000

_MASK = (_IN_MODIFY | _IN_ATTRIB | _IN_CLOSE_WRITE | _IN_MOVED_FROM
         | _IN_MOVED_TO | _IN_CREATE | _IN_DELETE | _IN_DELETE_SELF
         | _IN_MOVE_SELF)

_IN_NONBLOCK = 0o4000


class _Inotify:
    def __init__(self):
        name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(name, use_errno=True)
        self.fd = self._libc.inotify_init1(_IN_NONBLOCK)
        if self.fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._wd_to_path: dict[int, str] = {}
        self._path_to_wd: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, path: str) -> None:
        wd = self._libc.inotify_add_watch(self.fd, path.encode(), _MASK)
        if wd >= 0:
            with self._lock:
                self._wd_to_path[wd] = path
                self._path_to_wd[path] = wd

    def remove(self, path: str) -> None:
        with self._lock:
            wd = self._path_to_wd.pop(path, None)
            if wd is not None:
                self._wd_to_path.pop(wd, None)
        if wd is not None:
            self._libc.inotify_rm_watch(self.fd, wd)

    def watched(self) -> set[str]:
        with self._lock:
            return set(self._path_to_wd)

    def read_events(self, timeout: float) -> list[tuple[str, bool, bool]]:
        """Returns [(abs_path, is_create_or_delete, overflow)]."""
        ready, _, _ = select.select([self.fd], [], [], timeout)
        if not ready:
            return []
        try:
            data = os.read(self.fd, 65536)
        except BlockingIOError:
            return []
        events: list[tuple[str, bool, bool]] = []
        offset = 0
        while offset + 16 <= len(data):
            wd, mask, _cookie, length = struct.unpack_from("iIII", data, offset)
            name = data[offset + 16: offset + 16 + length].split(b"\x00")[0].decode(
                "utf-8", "replace")
            offset += 16 + length
            if mask & _IN_Q_OVERFLOW:
                events.append(("", False, True))
                continue
            if mask & _IN_IGNORED:
                continue
            with self._lock:
                base = self._wd_to_path.get(wd)
            if base is None:
                continue
            path = os.path.join(base, name) if name else base
            structural = bool(mask & (_IN_CREATE | _IN_DELETE | _IN_MOVED_FROM
                                      | _IN_MOVED_TO | _IN_DELETE_SELF
                                      | _IN_MOVE_SELF))
            # New directory created under a recursive watch → extend.
            if mask & _IN_ISDIR and mask & (_IN_CREATE | _IN_MOVED_TO):
                self.add(path)
            events.append((path, structural, False))
        return events

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass


class Watcher:
    """Watches one repository (main workdir + git dirs + linked worktrees),
    classifying raw events onto `raw_queue`."""

    def __init__(self, cfg: WatchConfig,
                 raw_queue: "queue.Queue[FsChangeKind]",
                 proxy: Optional[EventLoopProxy] = None):
        self.cfg = cfg
        self.raw_queue = raw_queue
        self.proxy = proxy
        self._stop = threading.Event()
        self._sub_lock = threading.Lock()
        self._inotify = _Inotify()
        self._install_watches()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fs-watcher")
        self._thread.start()

    # -- watch installation (reference: watcher.rs:22 spawn_init notes the
    # recursive install can take hundreds of ms — hence spawn_init below) --

    def _add_recursive(self, root: str, skip_git: bool = True) -> None:
        if not os.path.isdir(root):
            return
        self._inotify.add(root)
        excluded = self._excluded_prefixes()
        for dirpath, dirnames, _files in os.walk(root):
            pruned = []
            for d in list(dirnames):
                full = os.path.join(dirpath, d)
                if skip_git and d == ".git":
                    pruned.append(d)
                elif any(full == e or full.startswith(e + os.sep) for e in excluded):
                    pruned.append(d)
                else:
                    self._inotify.add(full)
            for d in pruned:
                dirnames.remove(d)

    def _excluded_prefixes(self) -> tuple[str, ...]:
        with self._sub_lock:
            return self.cfg.submodule_paths

    def _install_watches(self) -> None:
        cfg = self.cfg
        if cfg.workdir:
            self._add_recursive(cfg.workdir)
        for gd in {cfg.git_dir, cfg.common_dir}:
            if os.path.isdir(gd):
                self._inotify.add(gd)  # non-recursive (HEAD, index, …)
                refs = os.path.join(gd, "refs")
                if os.path.isdir(refs):
                    self._add_recursive(refs, skip_git=False)
                logs = os.path.join(gd, "logs")
                if os.path.isdir(logs):
                    self._add_recursive(logs, skip_git=False)
                wt = os.path.join(gd, "worktrees")
                if os.path.isdir(wt):
                    self._add_recursive(wt, skip_git=False)
        for root in cfg.worktree_roots:
            if os.path.isdir(root):
                self._add_recursive(root)
                parent = os.path.dirname(root.rstrip(os.sep))
                if os.path.isdir(parent):
                    self._inotify.add(parent)

    # -- hot-swappable path sets (reference: watcher.rs:275,298) ------------

    def update_submodule_paths(self, abs_paths: list[str]) -> None:
        with self._sub_lock:
            self.cfg = WatchConfig(
                workdir=self.cfg.workdir, git_dir=self.cfg.git_dir,
                common_dir=self.cfg.common_dir,
                worktree_roots=self.cfg.worktree_roots,
                submodule_paths=tuple(os.path.abspath(p) for p in abs_paths))

    def update_worktree_watches(self, roots: list[str]) -> None:
        """Diff the desired worktree-root set against current watches."""
        new = tuple(os.path.abspath(r) for r in roots)
        old = set(self.cfg.worktree_roots)
        with self._sub_lock:
            self.cfg = WatchConfig(
                workdir=self.cfg.workdir, git_dir=self.cfg.git_dir,
                common_dir=self.cfg.common_dir, worktree_roots=new,
                submodule_paths=self.cfg.submodule_paths)
        for root in new:
            if root not in old and os.path.isdir(root):
                self._add_recursive(root)
        for root in old - set(new):
            for watched in list(self._inotify.watched()):
                if watched == root or watched.startswith(root + os.sep):
                    self._inotify.remove(watched)

    # -- event loop ---------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                events = self._inotify.read_events(timeout=0.2)
            except OSError:
                # Watcher loss → synthesize a full metadata refresh
                # (reference: watcher.rs:179-183) and stop.
                self.raw_queue.put(FsChangeKind.GIT_METADATA)
                if self.proxy:
                    self.proxy.send_event()
                return
            with self._sub_lock:
                cfg = self.cfg
            for path, structural, overflow in events:
                if overflow:
                    self.raw_queue.put(FsChangeKind.GIT_METADATA)
                    continue
                kind = classify_event(path, cfg, is_create_or_delete=structural)
                if kind is not None:
                    self.raw_queue.put(kind)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._inotify.close()


def spawn_init(cfg: WatchConfig,
               raw_queue: "queue.Queue[FsChangeKind]",
               proxy: Optional[EventLoopProxy] = None,
               ) -> "queue.Queue[Watcher]":
    """Async watcher construction (invariant #6): the recursive inotify
    install runs on a worker; the built Watcher lands on the returned queue."""
    rx: queue.Queue[Watcher] = queue.Queue(maxsize=1)

    def worker():
        try:
            watcher = Watcher(cfg, raw_queue, proxy)
            rx.put(watcher)
        except OSError:
            # No inotify: deliver nothing; the safety nets (30 s status,
            # 5 s fingerprint) keep the UI correct without a watcher.
            pass
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="watcher-init").start()
    return rx
