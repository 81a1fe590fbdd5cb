"""Async refresh engine (L4).

Mirrors the reference's async architecture (src/git/async_ops.rs,
src/git_async.rs, src/watcher.rs) and its 11 load-bearing invariants
(docs/async-engine-redesign.md in the reference):

 1. three-tier watcher event classifier with dual-lane debounce
 2. two-tier refresh *spawn* (cheap status vs heavy repo state)
 3. per-entity dirty-check fanout (one worker per submodule/worktree)
 4. layered submodule exclusion
 5. tab_id stale-result rejection
 6. async watcher init
 7. repo handle reopen before metadata-triggered refreshes
 8. ref-fingerprint reconciliation (5 s)
 9. 30 s status safety net
10. stale-data guards in the apply step
11. WGIT_FRAME_DIAG timing diagnostics

Threads never share mutable state: each opens its own GitRepo and sends one
result over a Queue, then rings the EventLoopProxy doorbell.
"""

from .proxy import EventLoopProxy
from .async_ops import RemoteOpResult, classify_git_error, run_git_async
from .refresh import (
    MAX_COMMITS,
    RepoStateResult,
    StatusResult,
    spawn_repo_state_refresh,
    spawn_status_refresh,
)
from .dirty import DirtyCheckResult, spawn_dirty_checks
from .watcher import FsChangeKind, classify_git_path

__all__ = [
    "DirtyCheckResult",
    "EventLoopProxy",
    "FsChangeKind",
    "MAX_COMMITS",
    "RemoteOpResult",
    "RepoStateResult",
    "StatusResult",
    "classify_git_error",
    "classify_git_path",
    "run_git_async",
    "spawn_dirty_checks",
    "spawn_repo_state_refresh",
    "spawn_status_refresh",
]
