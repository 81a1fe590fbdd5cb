"""Value types for the git backend.

Capability parity with the reference's value types (reference:
src/git/mod.rs:246-1218) — CommitInfo incl. synthetic/orphan rows with
sentinel OIDs, branch/tag/worktree/submodule/stash records, working-dir
status buckets, diff model, and the time-formatting helpers the history
view renders with.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Optional

# Sentinel OID prefixes for synthetic (non-object) rows in the history view.
# Reference: src/git/mod.rs:330,381 — 0xFFFE = dirty linked worktree,
# 0xFFFD = dirty working directory of the checked-out worktree.
SYNTHETIC_WORKTREE_PREFIX = "fffe"
SYNTHETIC_WORKDIR_PREFIX = "fffd"


class FileStatus(Enum):
    """Classification of one path in a working-dir status bucket."""

    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"
    RENAMED = "renamed"
    TYPECHANGE = "typechange"
    UNTRACKED = "untracked"
    CONFLICTED = "conflicted"


@dataclass(frozen=True)
class StatusEntry:
    path: str
    status: FileStatus
    orig_path: Optional[str] = None  # for renames


@dataclass
class WorkingDirStatus:
    """Four-bucket status classification (reference: src/git/status.rs:11)."""

    staged: list[StatusEntry] = field(default_factory=list)
    unstaged: list[StatusEntry] = field(default_factory=list)
    untracked: list[StatusEntry] = field(default_factory=list)
    conflicted: list[StatusEntry] = field(default_factory=list)

    def is_clean(self) -> bool:
        return not (self.staged or self.unstaged or self.untracked or self.conflicted)

    def total(self) -> int:
        return len(self.staged) + len(self.unstaged) + len(self.untracked) + len(self.conflicted)


@dataclass
class CommitInfo:
    """One row of the history view (reference: src/git/mod.rs:246)."""

    oid: str
    short: str
    summary: str
    author_name: str
    author_email: str
    timestamp: int  # unix seconds, author time
    parents: list[str] = field(default_factory=list)
    # Synthetic rows: dirty worktree / working-dir placeholders that sort into
    # the timeline but are not selectable and carry no real object.
    is_synthetic: bool = False
    synthetic_worktree: Optional[str] = None  # worktree name for 0xFFFE rows
    # Orphan rows recovered from reflogs (unreachable from any ref).
    is_orphan: bool = False
    # Diff stats, filled asynchronously in chunks (reference: mod.rs:783).
    additions: Optional[int] = None
    deletions: Optional[int] = None

    @staticmethod
    def synthetic_for_working_dir(timestamp: int, summary: str = "Uncommitted changes") -> "CommitInfo":
        oid = SYNTHETIC_WORKDIR_PREFIX + "0" * 36
        return CommitInfo(
            oid=oid, short=oid[:7], summary=summary, author_name="", author_email="",
            timestamp=timestamp, is_synthetic=True,
        )

    @staticmethod
    def synthetic_for_worktree(name: str, timestamp: int,
                               tagline: Optional[str] = None) -> "CommitInfo":
        # Distinct sentinel per worktree: prefix + hash of the name.
        suffix = f"{abs(hash(name)) % (16 ** 8):08x}"
        oid = SYNTHETIC_WORKTREE_PREFIX + suffix + "0" * (36 - len(suffix))
        summary = (f"{tagline} ({name})" if tagline
                   else f"Uncommitted changes ({name})")
        return CommitInfo(
            oid=oid, short=oid[:7], summary=summary,
            author_name="", author_email="", timestamp=timestamp,
            is_synthetic=True, synthetic_worktree=name,
        )

    def with_stats(self, additions: int, deletions: int) -> "CommitInfo":
        return replace(self, additions=additions, deletions=deletions)


def insert_synthetics_sorted(commits: list[CommitInfo], synthetics: list[CommitInfo]) -> list[CommitInfo]:
    """Insert synthetic rows into a (newest-first) commit list by timestamp.

    Reference: src/git/mod.rs:234 — synthetic rows slot in at the position
    their timestamp dictates, ahead of equal-timestamp real commits so a
    just-now dirty worktree shows above HEAD.
    """
    out = list(commits)
    for syn in sorted(synthetics, key=lambda c: -c.timestamp):
        idx = 0
        while idx < len(out) and out[idx].timestamp > syn.timestamp:
            idx += 1
        out.insert(idx, syn)
    return out


@dataclass(frozen=True)
class BranchTip:
    """reference: src/git/mod.rs:1192."""

    name: str
    oid: str
    is_remote: bool = False
    is_head: bool = False
    upstream: Optional[str] = None
    ahead: int = 0
    behind: int = 0


@dataclass(frozen=True)
class TagInfo:
    """reference: src/git/mod.rs:1204."""

    name: str
    oid: str  # peeled target commit
    message: Optional[str] = None


@dataclass(frozen=True)
class WorktreeInfo:
    """reference: src/git/mod.rs:1173."""

    name: str
    path: str
    branch: Optional[str]  # None when detached
    head_oid: Optional[str]
    is_main: bool = False
    is_bare: bool = False
    is_detached: bool = False
    locked: bool = False
    prunable: bool = False


@dataclass(frozen=True)
class SubmoduleInfo:
    """reference: src/git/mod.rs:1150."""

    name: str
    path: str
    url: Optional[str]
    head_oid: Optional[str]  # pinned gitlink OID in the index/HEAD
    workdir_oid: Optional[str] = None  # what the submodule workdir actually has
    initialized: bool = True


@dataclass(frozen=True)
class StashEntry:
    """reference: src/git/mod.rs:1185 (listed via CLI %gd%x00%s%x00%ct)."""

    index: int
    ref_name: str  # e.g. stash@{0}
    summary: str
    timestamp: int


@dataclass(frozen=True)
class RemoteOpResult:
    """Outcome of an async `git` subprocess op (reference: mod.rs:1211)."""

    success: bool
    stderr: str = ""
    stdout: str = ""


@dataclass(frozen=True)
class DiffLine:
    """One line of a hunk. origin is '+', '-', or ' '."""

    origin: str
    content: str
    old_lineno: Optional[int]
    new_lineno: Optional[int]
    # Word-level highlight byte ranges within content (reference:
    # src/git/diff.rs:135 compute_intra_line_highlights).
    highlights: tuple[tuple[int, int], ...] = ()
    # True when git followed this line with "\ No newline at end of
    # file" — the hunk patch builder must re-emit the marker or `git
    # apply` rejects the patch for files without a trailing newline.
    no_newline: bool = False


@dataclass(frozen=True)
class DiffHunk:
    header: str
    old_start: int
    old_lines: int
    new_start: int
    new_lines: int
    lines: tuple[DiffLine, ...] = ()


@dataclass(frozen=True)
class DiffFile:
    path: str
    old_path: Optional[str]
    status: FileStatus
    hunks: tuple[DiffHunk, ...] = ()
    is_binary: bool = False
    additions: int = 0
    deletions: int = 0


@dataclass(frozen=True)
class FullCommitInfo:
    """Commit-details pane payload (reference: src/git/mod.rs:1218)."""

    oid: str
    parents: tuple[str, ...]
    author_name: str
    author_email: str
    committer_name: str
    committer_email: str
    author_time: int
    commit_time: int
    message: str
    files: tuple[DiffFile, ...] = ()  # per-file ± stats, no hunks


# ---------------------------------------------------------------------------
# Time formatting (reference: src/git/mod.rs:34 format_relative_time and
# :55 format_absolute_time, which uses Hinnant civil-calendar math — we use
# the stdlib equivalent).
# ---------------------------------------------------------------------------

def format_relative_time(timestamp: int, now: Optional[int] = None) -> str:
    now = int(_time.time()) if now is None else now
    delta = now - int(timestamp)
    if delta < 0:
        delta = 0
    if delta < 60:
        return "just now"
    minutes = delta // 60
    if minutes < 60:
        return f"{minutes}m ago"
    hours = minutes // 60
    if hours < 24:
        return f"{hours}h ago"
    days = hours // 24
    if days < 30:
        return f"{days}d ago"
    months = days // 30
    if months < 12:
        return f"{months}mo ago"
    years = days // 365
    return f"{max(years, 1)}y ago"


_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]


def format_absolute_time(timestamp: int) -> str:
    t = _time.localtime(int(timestamp))
    return (f"{t.tm_year}-{t.tm_mon:02d}-{t.tm_mday:02d} "
            f"{t.tm_hour:02d}:{t.tm_min:02d} "
            f"({_MONTHS[t.tm_mon - 1]} {t.tm_mday})")


def repo_state_label(state: str) -> Optional[str]:
    """Human label for an in-progress repo state (reference: mod.rs:82).

    `state` is the raw state token derived from .git state files.
    """
    labels = {
        "merge": "Merging",
        "revert": "Reverting",
        "cherry-pick": "Cherry-picking",
        "rebase": "Rebasing",
        "rebase-interactive": "Rebasing (interactive)",
        "rebase-merge": "Rebasing",
        "apply-mailbox": "Applying mailbox",
        "bisect": "Bisecting",
    }
    return labels.get(state)
