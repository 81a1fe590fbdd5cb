"""Git backend: value types + GitRepo over `git` CLI plumbing.

Mirrors the reference's L3 layer (src/git/ in the reference tree): a
synchronous, per-call-safe wrapper that higher layers only ever invoke from
worker threads. Every public entry point opens its own plumbing subprocess,
so handles are trivially `reopen`-able (no libgit2-style ref caching).
"""

from .types import (
    BranchTip,
    CommitInfo,
    DiffFile,
    DiffHunk,
    DiffLine,
    FullCommitInfo,
    RemoteOpResult,
    StashEntry,
    SubmoduleInfo,
    TagInfo,
    WorkingDirStatus,
    WorktreeInfo,
    FileStatus,
    format_absolute_time,
    format_relative_time,
    insert_synthetics_sorted,
    repo_state_label,
)
from .repo import GitRepo, ref_fingerprint

__all__ = [
    "BranchTip",
    "CommitInfo",
    "DiffFile",
    "DiffHunk",
    "DiffLine",
    "FileStatus",
    "FullCommitInfo",
    "GitRepo",
    "RemoteOpResult",
    "StashEntry",
    "SubmoduleInfo",
    "TagInfo",
    "WorkingDirStatus",
    "WorktreeInfo",
    "format_absolute_time",
    "format_relative_time",
    "insert_synthetics_sorted",
    "ref_fingerprint",
    "repo_state_label",
]
