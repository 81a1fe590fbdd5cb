"""Per-entity dirty-check fanout (invariant #3).

Capability parity with reference src/git_async.rs:365-418: one worker thread
per submodule + one per linked worktree, so a 25k-file submodule never
head-of-line blocks the parent or its siblings. Every check excludes nested
submodules (invariant #4's third layer). Results land on a single *global*
queue routed by tab_id; the consumer drops results for closed tabs
(invariant #5 — reference: git_async.rs:334-354).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Optional

from ..gitcore import native as gnative
from ..gitcore import status as gstatus
from ..gitcore.repo import GitRepo
from .proxy import EventLoopProxy


@dataclass(frozen=True)
class DirtyCheckResult:
    tab_id: int
    kind: str           # "submodule" | "worktree"
    key: str            # submodule path (repo-relative) or worktree path
    dirty: bool
    error: Optional[str] = None


def check_dirty(repo: GitRepo) -> bool:
    """One entity's dirty verdict. Fast path: the native scanner
    (native/statusscan.cc) reads the index/object store/worktree directly —
    no subprocess, ~100x cheaper than porcelain for a clean tree, which is
    what makes the per-refresh fanout over dozens of submodules/worktrees
    cheap. Falls back to `git status` whenever the scanner declines to
    certify the repo (filters, sha256, v4 index, …)."""
    if repo.workdir is not None and os.environ.get(
            "WGIT_NATIVE_STATUS") != "0":  # same kill switch as status()
        bits = gnative.quick_dirty(repo.workdir, repo.git_dir, repo.common_dir)
        if bits is not None:
            return bits != 0
    st = gstatus.status(repo, exclude_submodules=True)
    return not st.is_clean()


def _check_one(tab_id: int, kind: str, key: str, path: str,
               out: "queue.Queue[DirtyCheckResult]",
               proxy: Optional[EventLoopProxy]) -> None:
    try:
        sub = GitRepo.open(path)
        result = DirtyCheckResult(tab_id, kind, key, dirty=check_dirty(sub))
    except Exception as exc:
        result = DirtyCheckResult(tab_id, kind, key, dirty=False, error=str(exc))
    out.put(result)
    if proxy is not None:
        proxy.send_event()


def spawn_dirty_checks(
    repo: GitRepo, tab_id: int,
    submodule_paths: list[str],
    worktree_paths: list[str],
    out: "queue.Queue[DirtyCheckResult]",
    proxy: Optional[EventLoopProxy] = None,
) -> int:
    """Fan out one thread per entity. Returns the number spawned."""
    count = 0
    root = repo.workdir or repo.root
    for sp in submodule_paths:
        full = os.path.join(root, sp)
        if not os.path.isdir(full):
            continue
        threading.Thread(
            target=_check_one, args=(tab_id, "submodule", sp, full, out, proxy),
            daemon=True, name=f"dirty-sub-{os.path.basename(sp)}").start()
        count += 1
    for wp in worktree_paths:
        if wp == repo.workdir or not os.path.isdir(wp):
            continue
        threading.Thread(
            target=_check_one, args=(tab_id, "worktree", wp, wp, out, proxy),
            daemon=True, name=f"dirty-wt-{os.path.basename(wp)}").start()
        count += 1
    return count
