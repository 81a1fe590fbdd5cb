"""RepoTab — per-tab repository state.

Capability parity with reference src/repo_tab.rs: repo handle + metadata,
per-worktree WorktreeView map (status, drafts, selected diff file), four
async op slots + AI slot, refresh/watcher/diff-stats slots, history search,
submodule drill-down nav stack with pinned OIDs, CI receivers, and the
reducers with their stale-data guards (apply_state_result :790,
apply_status_result :897, apply_dirty_check_result :922,
merge_worktree_views :987).
"""

from __future__ import annotations

import os
import queue
import time
from dataclasses import dataclass, field
from typing import Optional

from ..engine import (
    EventLoopProxy,
    FsChangeKind,
    spawn_repo_state_refresh,
    spawn_status_refresh,
)
from ..engine.debounce import spawn_debounce_thread
from ..engine.refresh import RepoStateResult, StatusResult
from ..engine.watcher import WatchConfig, Watcher, spawn_init
from ..gitcore import GitRepo, refs as grefs
from ..gitcore.types import (
    CommitInfo,
    FullCommitInfo,
    WorkingDirStatus,
    insert_synthetics_sorted,
)
from ..ops.lanes import GraphLayout, RowSegment, decompose_edges

_NEXT_TAB_ID = [1]


def _alloc_tab_id() -> int:
    tid = _NEXT_TAB_ID[0]
    _NEXT_TAB_ID[0] += 1
    return tid


@dataclass
class TimedOp:
    """An in-flight async op slot (reference: repo_tab.rs:56): receiver +
    label + start stamp; the header renders '[spinner] label · Ns' and
    flips to a stall warning past 60 s."""

    rx: "queue.Queue"
    label: str
    verb: str = ""
    started: float = field(default_factory=time.monotonic)

    def elapsed(self) -> float:
        return time.monotonic() - self.started


@dataclass
class WorktreeView:
    """Per-worktree view state (reference: repo_tab.rs:196-286). Drafts
    survive refreshes (merge_worktree_views preserves them)."""

    path: str
    status: Optional[WorkingDirStatus] = None
    draft_subject: str = ""
    draft_body: str = ""
    amend_mode: bool = False
    selected_file: Optional[str] = None
    selected_staged: bool = False
    dirty: bool = False
    working_diff_stats: Optional[tuple] = None  # (+, −) vs HEAD


@dataclass
class StateApplyEffects:
    """What the orchestrator must do after a reducer ran (reference:
    repo_tab.rs:479)."""

    toast_errors: list[str] = field(default_factory=list)
    fetch_diff_stats: bool = False
    spawn_dirty_checks: bool = False
    update_watcher_paths: bool = False
    kept_stale_data: bool = False


class RepoTab:
    def __init__(self, repo: GitRepo, path: str):
        self.tab_id = _alloc_tab_id()
        self.repo = repo
        self.path = path
        self.title = repo.repo_name()

        # Metadata (filled by state refreshes).
        self.commits: list[CommitInfo] = []
        self.branch_tips = []
        self.tags = []
        self.worktrees = []
        self.submodules = []
        self.stashes = []
        self.remotes: list[str] = []
        self.remote_urls: dict[str, str] = {}
        self.current_branch: Optional[str] = None
        self.head_oid: Optional[str] = None
        self.repo_state: Optional[str] = None
        self.graph_layout: GraphLayout = GraphLayout()
        self.graph_segments: list[RowSegment] = []
        self.last_fingerprint: str = ""
        # Row Size setting (reference README.md:117 "Row Size: Normal or
        # Large (1.5×)"): scales history/sidebar/staging row pitch. The
        # app syncs this from Config and rebuilds the layout on toggle.
        self.row_scale: float = 1.0

        # Per-worktree views; the main workdir always has one.
        self.worktree_views: dict[str, WorktreeView] = {}
        self.active_worktree: Optional[str] = repo.workdir
        if repo.workdir:
            self.worktree_views[repo.workdir] = WorktreeView(path=repo.workdir)
        self.worktree_repos: dict[str, GitRepo] = {}
        self.submodule_dirty: dict[str, bool] = {}

        # Selection / detail.
        self.selected_oid: Optional[str] = None
        # Commit-range compare (design_feedback_feb2026.md:492: richer
        # selection model): anchor picked via Shift+click or context menu;
        # compare_range = (base_oid, head_oid) while the compare is open.
        self.range_anchor: Optional[str] = None
        self.compare_range: Optional[tuple] = None
        self.compare_set: frozenset = frozenset()  # exact base..head oids
        self.commit_detail: Optional[FullCommitInfo] = None
        self.detail_file: Optional[str] = None

        # Async op slots (reference: 4 per-tab slots + AI).
        self.fetch_op: Optional[TimedOp] = None
        self.push_op: Optional[TimedOp] = None
        self.pull_op: Optional[TimedOp] = None
        self.other_op: Optional[TimedOp] = None
        self.ai_op: Optional[TimedOp] = None

        # Refresh machinery.
        self.commit_limit = 1000  # grows as the user scrolls (infinite scroll)
        self.state_refresh_rx: Optional[queue.Queue] = None
        self.status_rx: Optional[queue.Queue] = None
        self.status_dirty = False       # event arrived mid-scan → replay
        self.initial_refresh_done = False
        self.diff_stats_rx: Optional[queue.Queue] = None
        self.diff_stats_cache: dict[str, tuple[int, int]] = {}

        # Watcher trio (invariant #6: async init).
        self.watcher: Optional[Watcher] = None
        self.watcher_init_rx: Optional[queue.Queue] = None
        self.watcher_raw_q: "queue.Queue[FsChangeKind]" = queue.Queue()
        self.watcher_events_q: "queue.Queue[FsChangeKind]" = queue.Queue()
        self.debounce_stop = None

        # Search.
        self.search_active = False
        self.search_query = ""

        # Scroll state.
        self.history_scroll = 0.0
        self.sidebar_scroll = 0.0
        self.diff_scroll = 0.0
        self.diff_hscroll = 0.0

        # Sidebar collapse state (reference: SidebarSection, repo_tab.rs:119).
        self.sidebar_collapsed: dict[str, bool] = {}
        self.selected_sidebar_key: Optional[str] = None

        # Submodule drill-down (reference: nav_stack, repo_tab.rs:450-469).
        self.nav_stack: list["RepoTab"] = []
        self.pinned_oid: Optional[str] = None
        self.pinned_path: Optional[str] = None

        # CI.
        self.ci_results: dict[str, object] = {}   # provider -> CiStatus
        self.ci_rollups: dict[str, object] = {}   # commit oid -> rollup
        self.ci_receivers: list = []
        self.last_push_time: float = 0.0
        self.last_ci_fetch: float = 0.0
        # Header "fetched Nm ago" chip (design_feedback_feb2026.md:67 —
        # the header should carry last-fetch/tracking/workdir info).
        self.last_fetch_time: float = 0.0
        # Project Rewind (services/rewind.py): lazy per-repo log, last
        # cadence stamp, and a pending label from a just-completed op.
        self.rewind_log = None
        self.last_rewind: float = 0.0
        self.pending_rewind_label: str = ""

        # Pull requests (beyond-reference: Deferred in user_needs.md).
        self.pr_by_branch: dict[str, object] = {}  # branch -> PullRequestInfo
        self.pr_receivers: list = []
        self.pr_error: Optional[str] = None

        # AI worktree taglines (user_needs.md "LLM-Generated Descriptions").
        self.worktree_taglines: dict[str, str] = {}   # path -> tagline
        self.tagline_rx: list = []                    # (path, fp, rx)
        self.tagline_stamps: dict[str, str] = {}      # path -> handled fp
        # AI branch intent (design_feedback_feb2026.md:423).
        self.intent_rx = None                          # (branch, rx)

        # Safety-net stamps.
        self.last_status_query: float = 0.0
        self.last_fingerprint_check: float = 0.0

    # -- open ---------------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "RepoTab":
        """Async-init open (reference: repo_tab.rs:509): only discovery runs
        here — no data loads; the first state refresh fills everything."""
        return cls(GitRepo.open(path), path)

    # -- triggers -----------------------------------------------------------

    def trigger_state_refresh(self, proxy: Optional[EventLoopProxy] = None,
                              ) -> None:
        """Heavy refresh — idempotent while one is in flight
        (reference: repo_tab.rs:653 state_refresh_rx.is_some()). The
        FIRST refresh streams a head-of-history slice so a huge repo
        paints in tens of ms (engine/refresh.py STREAM_FIRST)."""
        if self.state_refresh_rx is not None:
            return
        from ..engine.refresh import STREAM_FIRST
        self.state_refresh_rx = spawn_repo_state_refresh(
            self.repo, self.tab_id, proxy, max_commits=self.commit_limit,
            stream_first=(STREAM_FIRST if not self.initial_refresh_done
                          else 0))

    def trigger_status_refresh(self, proxy: Optional[EventLoopProxy] = None,
                               ) -> None:
        if self.status_rx is not None:
            self.status_dirty = True  # replay after the in-flight scan lands
            return
        paths = [wt.path for wt in self.worktrees if not wt.is_main]
        self.status_rx = spawn_status_refresh(self.repo, self.tab_id,
                                              paths, proxy)
        self.last_status_query = time.monotonic()

    def trigger_watcher_init(self, proxy: Optional[EventLoopProxy] = None,
                             ) -> None:
        if self.watcher is not None or self.watcher_init_rx is not None:
            return
        cfg = WatchConfig(
            workdir=self.repo.workdir, git_dir=self.repo.git_dir,
            common_dir=self.repo.common_dir,
            worktree_roots=tuple(wt.path for wt in self.worktrees
                                 if not wt.is_main),
            submodule_paths=tuple(
                os.path.join(self.repo.workdir, s.path)
                for s in self.submodules) if self.repo.workdir else ())
        self.watcher_init_rx = spawn_init(cfg, self.watcher_raw_q, proxy)
        self.debounce_stop = spawn_debounce_thread(
            self.watcher_raw_q, self.watcher_events_q, proxy)

    def reopen_repo_handles(self) -> None:
        """Cache-bypass reopen before metadata-triggered refreshes
        (invariant #7; reference: repo_tab.rs:725)."""
        try:
            self.repo = self.repo.reopen()
        except Exception:
            pass
        for path in list(self.worktree_repos):
            try:
                self.worktree_repos[path] = self.worktree_repos[path].reopen()
            except Exception:
                self.worktree_repos.pop(path, None)

    # -- reducers -----------------------------------------------------------

    def apply_state_result(self, result: RepoStateResult) -> StateApplyEffects:
        """Fold a heavy refresh result (reference: repo_tab.rs:790-890)."""
        t0 = time.monotonic()
        effects = StateApplyEffects()
        if result.partial:
            # Streaming first-paint slice: fill ONLY the graph essentials
            # and keep the receiver open — the full result follows. Never
            # applied over existing content (it would momentarily shrink
            # the graph); the full apply replaces it without flicker
            # because it is a superset of the slice.
            if self.commits:
                return effects
            self.branch_tips = result.branch_tips
            self.current_branch = result.current_branch
            self.head_oid = result.head_oid
            self.repo_state = result.repo_state
            self.commits = insert_synthetics_sorted(
                list(result.commits), self._build_synthetics())
            self._rebuild_layout()
            effects.fetch_diff_stats = True  # ± chips on the first paint
            return effects
        self.state_refresh_rx = None
        effects.toast_errors = list(result.errors)

        # Invariant #10: stale-data guard — an empty result with existing
        # data keeps what we had rather than blanking the graph.
        if not result.commits and self.commits:
            effects.kept_stale_data = True
            return effects

        self.branch_tips = result.branch_tips
        self.tags = result.tags
        self.worktrees = result.worktrees
        self.submodules = result.submodules
        self.stashes = result.stashes
        self.remotes = result.remotes
        self.remote_urls = result.remote_urls
        self.current_branch = result.current_branch
        self.head_oid = result.head_oid
        self.repo_state = result.repo_state
        self.last_fingerprint = result.ref_fingerprint
        self.worktree_repos = dict(result.worktree_repos)

        # Merge worktree views preserving drafts (reference: :987).
        new_views: dict[str, WorktreeView] = {}
        paths = ([self.repo.workdir] if self.repo.workdir else [])
        paths += [wt.path for wt in result.worktrees if not wt.is_main]
        for p in paths:
            if p is None:
                continue
            old = self.worktree_views.get(p)
            if old is not None:
                new_views[p] = old
            else:
                new_views[p] = WorktreeView(path=p)
        self.worktree_views = new_views
        if self.active_worktree not in new_views:
            self.active_worktree = self.repo.workdir or next(iter(new_views), None)

        # Rebuild commit rows with synthetic dirty-worktree rows (:861).
        commits = list(result.commits)
        synthetics = self._build_synthetics()
        self.commits = insert_synthetics_sorted(commits, synthetics)

        # Re-apply cached diff stats by OID so the ± chips don't flicker
        # during a refresh (:804-817).
        if self.diff_stats_cache:
            self.commits = [
                c.with_stats(*self.diff_stats_cache[c.oid])
                if c.oid in self.diff_stats_cache else c
                for c in self.commits]

        self._rebuild_layout()
        self.initial_refresh_done = True
        effects.fetch_diff_stats = True
        effects.spawn_dirty_checks = True
        effects.update_watcher_paths = True
        if os.environ.get("WGIT_FRAME_DIAG"):
            import sys
            print(f"apply_state_result(tab={self.tab_id}): "
                  f"{len(self.commits)} commits, "
                  f"{len(self.worktree_views)} worktrees, "
                  f"{(time.monotonic() - t0) * 1000:.1f} ms",
                  file=sys.stderr)
        return effects

    def _build_synthetics(self) -> list[CommitInfo]:
        now = int(time.time())
        synthetics = []
        for p, view in self.worktree_views.items():
            dirty = view.dirty or (view.status is not None
                                   and not view.status.is_clean())
            if not dirty:
                continue
            # AI tagline becomes the row summary when available
            # (user_needs.md "LLM-Generated Descriptions").
            tag = self.worktree_taglines.get(p)
            if p == self.repo.workdir:
                synthetics.append(CommitInfo.synthetic_for_working_dir(
                    now, summary=tag or "Uncommitted changes"))
            else:
                name = os.path.basename(p.rstrip(os.sep))
                synthetics.append(CommitInfo.synthetic_for_worktree(
                    name, now, tagline=tag))
        return synthetics

    def rebuild_synthetics(self) -> None:
        """Re-derive synthetic rows (e.g. after a tagline lands)."""
        if not self.commits:
            return
        base = [c for c in self.commits if not c.is_synthetic]
        self.commits = insert_synthetics_sorted(base,
                                                self._build_synthetics())
        self._rebuild_layout()

    def status_fingerprint(self, path: str) -> str:
        """Stable key for one worktree's dirty file-set — taglines
        regenerate only when this changes."""
        view = self.worktree_views.get(path)
        if view is None:
            return ""
        st = view.status
        if st is None:
            return f"dirty={view.dirty}"
        return "|".join(
            ",".join(sorted(f.path for f in bucket))
            for bucket in (st.staged, st.unstaged, st.untracked,
                           st.conflicted))

    def _rebuild_layout(self) -> None:
        from ..ops.lanes import ROW_HEIGHT

        self.graph_layout = GraphLayout.build(
            self.commits, base=ROW_HEIGHT * self.row_scale)
        self.graph_segments = decompose_edges(self.graph_layout)
        # Monotonic version for row cache keys (id() could be recycled).
        self.layout_version = getattr(self, "layout_version", 0) + 1

    def apply_status_result(self, result: StatusResult) -> None:
        """Fold a cheap status result — routed to the *reported* worktree,
        not the active view (reference: repo_tab.rs:897; its test asserts
        exactly this routing)."""
        self.status_rx = None
        changed_dirty = False
        for path, status in result.statuses.items():
            view = self.worktree_views.get(path)
            if view is None:
                view = WorktreeView(path=path)
                self.worktree_views[path] = view
            was = view.dirty
            view.status = status
            view.dirty = not status.is_clean()
            changed_dirty |= (was != view.dirty)
        if result.working_diff_stats is not None and self.repo.workdir:
            view = self.worktree_views.get(self.repo.workdir)
            if view is not None:
                view.working_diff_stats = result.working_diff_stats
        if changed_dirty and self.commits:
            base = [c for c in self.commits if not c.is_synthetic]
            self.commits = insert_synthetics_sorted(
                base, self._build_synthetics())
            self._rebuild_layout()

    def apply_dirty_check_result(self, kind: str, key: str, dirty: bool
                                 ) -> None:
        """Fold one per-entity dirty check (reference: repo_tab.rs:922)."""
        if kind == "submodule":
            self.submodule_dirty[key] = dirty
        else:
            view = self.worktree_views.get(key)
            if view is None:
                view = WorktreeView(path=key)
                self.worktree_views[key] = view
            if view.dirty != dirty:
                view.dirty = dirty
                if self.commits:
                    base = [c for c in self.commits if not c.is_synthetic]
                    self.commits = insert_synthetics_sorted(
                        base, self._build_synthetics())
                    self._rebuild_layout()

    def apply_diff_stats(self, stats: dict[str, tuple[int, int]]) -> None:
        self.diff_stats_cache.update(stats)
        self.commits = [
            c.with_stats(*stats[c.oid]) if c.oid in stats else c
            for c in self.commits]
        # Row content changed without a relayout: bump the stats
        # generation so per-row static-key memos (views/commit_graph)
        # rebuild their chips.
        self.stats_version = getattr(self, "stats_version", 0) + 1

    # -- sync refresh (headless / screenshot path) ---------------------------

    def refresh_sync(self, include_orphans: bool = True) -> None:
        """Synchronous full refresh for the headless path (reference:
        repo_tab.rs:568 refresh_with_orphans, used by screenshot mode)."""
        rx = spawn_repo_state_refresh(self.repo, self.tab_id,
                                      max_commits=self.commit_limit,
                                      include_orphans=include_orphans)
        result = rx.get(timeout=60)
        self.apply_state_result(result)
        srx = spawn_status_refresh(
            self.repo, self.tab_id,
            [wt.path for wt in self.worktrees if not wt.is_main])
        self.apply_status_result(srx.get(timeout=60))
        stats = self.repo.diff_stats_for_commits(
            [c.oid for c in self.commits if not c.is_synthetic][:100])
        self.apply_diff_stats(stats)

    # -- selection ----------------------------------------------------------

    def select_commit(self, oid: Optional[str]) -> None:
        """Synthetic rows are unselectable (reference: repo_tab.rs:1264)."""
        if oid is None:
            self.selected_oid = None
            self.commit_detail = None
            self.detail_file = None
            return
        commit = next((c for c in self.commits if c.oid == oid), None)
        if commit is None or commit.is_synthetic:
            return
        self.selected_oid = oid
        self.detail_file = None
        try:
            self.commit_detail = grefs.full_commit_info(self.repo, oid)
        except Exception:
            self.commit_detail = None

    def select_worktree(self, path: str) -> None:
        """reference: repo_tab.rs:1184."""
        if path in self.worktree_views:
            self.active_worktree = path

    def active_view(self) -> Optional[WorktreeView]:
        if self.active_worktree is None:
            return None
        return self.worktree_views.get(self.active_worktree)

    def active_repo(self) -> GitRepo:
        """Repo handle for the focused worktree — async ops run in the
        *focused* worktree's workdir (reference: prepare_remote_op,
        ui_app.rs:3864)."""
        if (self.active_worktree and self.active_worktree != self.repo.workdir
                and self.active_worktree in self.worktree_repos):
            return self.worktree_repos[self.active_worktree]
        return self.repo

    # -- submodule drill-down -------------------------------------------------

    def enter_submodule(self, sub_path: str) -> Optional["RepoTab"]:
        """Push the current tab onto the nav stack and descend
        (reference: repo_tab.rs:1354)."""
        if self.repo.workdir is None:
            return None
        full = os.path.join(self.repo.workdir, sub_path)
        if not os.path.isdir(full):
            return None
        try:
            child = RepoTab.open(full)
        except Exception:
            return None
        sub = next((s for s in self.submodules if s.path == sub_path), None)
        child.pinned_oid = sub.head_oid if sub else None
        child.pinned_path = sub_path
        child.nav_stack = self.nav_stack + [self]
        return child

    def exit_submodule(self) -> Optional["RepoTab"]:
        if not self.nav_stack:
            return None
        parent = self.nav_stack[-1]
        self.stop_workers()
        return parent

    def exit_to_depth(self, depth: int) -> Optional["RepoTab"]:
        """reference: repo_tab.rs:1390 — jump to a breadcrumb level."""
        if depth < 0 or depth >= len(self.nav_stack):
            return None
        target = self.nav_stack[depth]
        self.stop_workers()
        return target

    def switch_sibling_submodule(self, sub_path: str) -> Optional["RepoTab"]:
        """reference: repo_tab.rs:1404."""
        if not self.nav_stack:
            return None
        parent = self.nav_stack[-1]
        child = parent.enter_submodule(sub_path)
        if child is not None:
            self.stop_workers()
        return child

    @property
    def drill_depth(self) -> int:
        return len(self.nav_stack)

    # -- lifecycle ------------------------------------------------------------

    def stop_workers(self) -> None:
        if self.watcher is not None:
            try:
                self.watcher.stop()
            except Exception:
                pass
            self.watcher = None
        if self.debounce_stop is not None:
            self.debounce_stop.set()
            self.debounce_stop = None

    def busy_slots(self) -> list[tuple[str, TimedOp]]:
        out = []
        for name in ("fetch_op", "push_op", "pull_op", "other_op", "ai_op"):
            op = getattr(self, name)
            if op is not None:
                out.append((name, op))
        return out
