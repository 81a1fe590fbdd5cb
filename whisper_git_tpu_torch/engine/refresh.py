"""Two-tier refresh workers (invariant #2: different *spawns*, not just
different debounces).

Capability parity with reference src/git_async.rs: `spawn_status_refresh`
(cheap — main + per-worktree status only, :77-145) vs
`spawn_repo_state_refresh` (heavy — commit walk + branches + tags +
worktrees + remotes + submodules + stashes + ahead/behind + fingerprint +
pre-opened per-worktree repo handles + non-fatal error list, :190-323).
Results carry the tab_id they were spawned for (invariant #5).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..gitcore import status as gstatus
from ..gitcore.repo import MAX_COMMITS, GitRepo, ref_fingerprint
from ..gitcore.types import (
    BranchTip,
    CommitInfo,
    StashEntry,
    SubmoduleInfo,
    TagInfo,
    WorkingDirStatus,
    WorktreeInfo,
)
from .proxy import EventLoopProxy

__all__ = ["MAX_COMMITS", "StatusResult", "RepoStateResult",
           "spawn_status_refresh", "spawn_repo_state_refresh"]


@dataclass
class StatusResult:
    """Cheap refresh payload (reference: git_async.rs:58)."""

    tab_id: int
    # worktree path → status (the active worktree plus the staging-view one)
    statuses: dict[str, WorkingDirStatus] = field(default_factory=dict)
    working_diff_stats: Optional[tuple[int, int]] = None
    errors: list[str] = field(default_factory=list)


@dataclass
class RepoStateResult:
    """Heavy refresh payload (reference: git_async.rs:159).

    `partial=True` marks a STREAMING FIRST-PAINT result: the worker put
    a cheap head-of-history slice (first ~200 commits + branch tips +
    HEAD) on the queue before starting the full walk, so a 100k-commit
    repo paints its history in tens of ms instead of after the whole
    metadata pass (beyond-reference: the reference defers the first
    paint to the full walk, docs/async-engine-redesign.md:55-59). The
    full result always follows on the same queue."""

    tab_id: int
    partial: bool = False
    commits: list[CommitInfo] = field(default_factory=list)
    branch_tips: list[BranchTip] = field(default_factory=list)
    tags: list[TagInfo] = field(default_factory=list)
    worktrees: list[WorktreeInfo] = field(default_factory=list)
    submodules: list[SubmoduleInfo] = field(default_factory=list)
    stashes: list[StashEntry] = field(default_factory=list)
    remotes: list[str] = field(default_factory=list)
    remote_urls: dict[str, str] = field(default_factory=dict)
    current_branch: Optional[str] = None
    head_oid: Optional[str] = None
    repo_state: Optional[str] = None
    ref_fingerprint: str = ""
    # Pre-opened handles for linked worktrees so the UI thread never runs
    # discovery itself (reference pre-opens per-worktree GitRepo handles).
    worktree_repos: dict[str, GitRepo] = field(default_factory=dict)
    errors: list[str] = field(default_factory=list)
    elapsed_ms: float = 0.0


_CG_LOCK = threading.Lock()
_CG_LAST: dict = {}
_CG_MIN_INTERVAL_S = 300.0


def _maintain_commit_graph(repo: GitRepo) -> None:
    """Keep a commit-graph file fresh in the background (fire-and-
    forget, at most once per repo per 5 min). `git log --topo-order
    --max-count=N` must otherwise walk the ENTIRE history before
    emitting anything — 440 ms on a 100k-commit repo vs 44 ms with
    generation numbers (measured; the reference's libgit2 revwalk pays
    the same full-walk cost with no such escape). `--split` appends an
    incremental layer proportional to NEW commits, so steady-state
    maintenance is milliseconds.

    WGIT_COMMIT_GRAPH=0 disables it: this is the one place the viewer
    writes into a repository it was merely asked to display
    (.git/objects/info/ — the same maintenance `git gc`/fetch perform,
    but a shared checkout or externally-snapshotted .git may want the
    viewer strictly read-only)."""
    if os.environ.get("WGIT_COMMIT_GRAPH") in ("0", "off", "false"):
        return
    try:
        key = repo.common_dir
    except Exception:
        return
    now = time.monotonic()
    with _CG_LOCK:
        if now - _CG_LAST.get(key, 0.0) < _CG_MIN_INTERVAL_S:
            return
        while len(_CG_LAST) > 256:
            _CG_LAST.pop(next(iter(_CG_LAST)))
        _CG_LAST[key] = now

    def work():
        from ..gitcore.cli import run_git

        run_git(repo.root, "commit-graph", "write", "--reachable",
                "--split", check=False)

    threading.Thread(target=work, daemon=True,
                     name="wgit-commit-graph").start()


def spawn_status_refresh(
    repo: GitRepo, tab_id: int,
    worktree_paths: Optional[list[str]] = None,
    proxy: Optional[EventLoopProxy] = None,
) -> "queue.Queue[StatusResult]":
    """Cheap tier: working-dir status for the main workdir (+ named
    worktrees), nothing else. Never walks commits (invariant #2)."""
    rx: queue.Queue[StatusResult] = queue.Queue(maxsize=1)
    paths = list(worktree_paths or [])

    def worker():
        result = StatusResult(tab_id=tab_id)
        # Per-target isolation (the partial-failure design invariant #10
        # rests on): a transient main-workdir failure — e.g. racing an
        # index rewrite — must not abort the linked worktrees' scans.
        try:
            if repo.workdir:
                result.statuses[repo.workdir] = gstatus.status(repo)
                result.working_diff_stats = repo.working_tree_diff_stats()
        except Exception as exc:
            result.errors.append(f"status(main): {exc}")
        for p in paths:
            if p == repo.workdir or not os.path.isdir(p):
                continue
            try:
                result.statuses[p] = gstatus.status(GitRepo.open(p))
            except Exception as exc:
                result.errors.append(f"status({p}): {exc}")
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="status-refresh").start()
    return rx


STREAM_FIRST = 200  # commits in the streaming first-paint slice


def spawn_repo_state_refresh(
    repo: GitRepo, tab_id: int,
    proxy: Optional[EventLoopProxy] = None,
    max_commits: int = MAX_COMMITS,
    include_orphans: bool = True,
    stream_first: int = 0,
) -> "queue.Queue[RepoStateResult]":
    """Heavy tier: the full repo metadata walk. Partial failures are folded
    into `errors` without blanking the rest (invariant #10 feeds off this).

    stream_first > 0 (the orchestrator passes STREAM_FIRST on a tab's
    FIRST refresh only — a later partial would momentarily shrink an
    already-painted graph) puts a cheap head-of-history slice on the
    queue before the full walk; see RepoStateResult.partial."""
    rx: queue.Queue[RepoStateResult] = queue.Queue(maxsize=2)

    def worker():
        from ..services import crash_log

        t0 = time.monotonic()
        crash_log.breadcrumb(f"state refresh start (tab {tab_id})")

        if stream_first > 0:
            partial = RepoStateResult(tab_id=tab_id, partial=True)

            def pguard(name, fn, default):
                try:
                    return fn()
                except Exception:
                    return default  # full pass will surface the error

            # No orphan recovery in the slice (reflog BFS is the slow
            # part on big repos — exactly what streaming routes around).
            partial.commits = pguard(
                "commits", lambda: repo.commit_graph(stream_first), [])
            partial.branch_tips = pguard("branch_tips", repo.branch_tips,
                                         [])
            partial.current_branch = pguard("current_branch",
                                            repo.current_branch, None)
            partial.head_oid = pguard("head_oid", repo.head_oid, None)
            partial.repo_state = pguard("repo_state", repo.repo_state,
                                        None)
            partial.elapsed_ms = (time.monotonic() - t0) * 1000.0
            if partial.commits:
                crash_log.breadcrumb(
                    f"state refresh first-paint slice (tab {tab_id}, "
                    f"{len(partial.commits)} commits, "
                    f"{partial.elapsed_ms:.0f} ms)")
                rx.put(partial)
                if proxy is not None:
                    proxy.send_event()

        result = RepoStateResult(tab_id=tab_id)

        def guard(name, fn, default):
            try:
                return fn()
            except Exception as exc:
                result.errors.append(f"{name}: {exc}")
                return default

        result.commits = guard(
            "commits",
            lambda: (repo.commit_graph_with_orphans(max_commits)
                     if include_orphans else repo.commit_graph(max_commits)),
            [])
        result.branch_tips = guard("branch_tips", repo.branch_tips, [])
        result.tags = guard("tags", repo.tags, [])
        result.worktrees = guard("worktrees", repo.worktrees, [])
        result.submodules = guard("submodules", repo.submodules, [])
        result.stashes = guard("stashes", repo.stashes, [])
        result.remotes = guard("remotes", repo.remotes, [])
        for r in result.remotes:
            url = guard(f"remote_url({r})", lambda r=r: repo.remote_url(r), None)
            if url:
                result.remote_urls[r] = url
        result.current_branch = guard("current_branch", repo.current_branch, None)
        result.head_oid = guard("head_oid", repo.head_oid, None)
        result.repo_state = guard("repo_state", repo.repo_state, None)
        result.ref_fingerprint = guard(
            "ref_fingerprint",
            lambda: ref_fingerprint(repo.git_dir, repo.common_dir), "")
        for wt in result.worktrees:
            if wt.is_main or not os.path.isdir(wt.path):
                continue
            handle = guard(f"worktree_open({wt.name})",
                           lambda p=wt.path: GitRepo.open(p), None)
            if handle is not None:
                result.worktree_repos[wt.path] = handle
        result.elapsed_ms = (time.monotonic() - t0) * 1000.0
        crash_log.breadcrumb(
            f"state refresh done (tab {tab_id}, {len(result.commits)} "
            f"commits, {result.elapsed_ms:.0f} ms)")
        _maintain_commit_graph(repo)
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="state-refresh").start()
    return rx
