"""Working-dir status classification + stage/unstage.

Capability parity with reference src/git/status.rs: the four-bucket
`WorkingDirStatus`, a pure classifier over raw status records, and the
stage/unstage ops with their new-file/deleted-file special cases.
"""

from __future__ import annotations

import os

from . import native
from .cli import run_git
from .repo import GitRepo
from .types import FileStatus, StatusEntry, WorkingDirStatus

_STATUS_MAP = {
    "M": FileStatus.MODIFIED,
    "A": FileStatus.ADDED,
    "D": FileStatus.DELETED,
    "R": FileStatus.RENAMED,
    "C": FileStatus.RENAMED,
    "T": FileStatus.TYPECHANGE,
}


def working_dir_status_from_porcelain(records: list[str]) -> WorkingDirStatus:
    """Pure classifier over `status --porcelain=v2 -z` records (the free-fn
    analog of reference status.rs:75 so it unit-tests without a repo)."""
    st = WorkingDirStatus()
    i = 0
    while i < len(records):
        rec = records[i]
        i += 1
        if not rec:
            continue
        kind = rec[0]
        if kind == "?":
            st.untracked.append(StatusEntry(rec[2:], FileStatus.UNTRACKED))
        elif kind == "!":
            pass  # ignored
        elif kind == "u":
            parts = rec.split(" ", 10)
            if len(parts) >= 11:
                st.conflicted.append(StatusEntry(parts[10], FileStatus.CONFLICTED))
        elif kind == "1":
            parts = rec.split(" ", 8)
            if len(parts) < 9:
                continue
            xy, path = parts[1], parts[8]
            x, y = xy[0], xy[1]
            if x != ".":
                st.staged.append(StatusEntry(path, _STATUS_MAP.get(x, FileStatus.MODIFIED)))
            if y != ".":
                st.unstaged.append(StatusEntry(path, _STATUS_MAP.get(y, FileStatus.MODIFIED)))
        elif kind == "2":
            # Rename: record is "2 XY sub mH mI mW hH hI Xscore path", the
            # original path follows as the next NUL-separated record.
            parts = rec.split(" ", 9)
            if len(parts) < 10:
                continue
            xy, path = parts[1], parts[9]
            orig = records[i] if i < len(records) else None
            i += 1
            x, y = xy[0], xy[1]
            if x != ".":
                st.staged.append(StatusEntry(path, FileStatus.RENAMED, orig_path=orig))
            if y != ".":
                # Worktree-side renames carry orig too (the native
                # scanner attaches it to every bucket — the two paths
                # must produce identically-shaped entries).
                st.unstaged.append(StatusEntry(
                    path,
                    FileStatus.RENAMED if y == "R"
                    else _STATUS_MAP.get(y, FileStatus.MODIFIED),
                    orig_path=orig if y == "R" else None))
    return st


_NATIVE_LETTER = {
    "A": FileStatus.ADDED, "M": FileStatus.MODIFIED, "D": FileStatus.DELETED,
    "R": FileStatus.RENAMED, "T": FileStatus.TYPECHANGE,
    "U": FileStatus.CONFLICTED, "?": FileStatus.UNTRACKED,
}


def _native_status(repo: GitRepo,
                   include_untracked: bool) -> WorkingDirStatus | None:
    """Subprocess-free full status via native/statusscan.cc (None → caller
    falls back to porcelain). Semantics certified against `git status` by
    tests/test_statusscan.py's differential suite."""
    if repo.workdir is None or os.environ.get("WGIT_NATIVE_STATUS") == "0":
        return None
    records = native.status_scan(repo.workdir, repo.git_dir, repo.common_dir)
    if records is None:
        return None
    st = WorkingDirStatus()
    buckets = (st.staged, st.unstaged, st.untracked, st.conflicted)
    for bucket, letter, path, orig in records:
        if bucket == 2 and not include_untracked:
            continue
        buckets[bucket].append(StatusEntry(
            path, _NATIVE_LETTER.get(letter, FileStatus.MODIFIED),
            orig_path=orig or None))
    return st


def status(repo: GitRepo, exclude_submodules: bool = True,
           include_untracked: bool = True) -> WorkingDirStatus:
    """Full status query (reference: status.rs:131 — include_untracked +
    recurse_untracked_dirs + exclude_submodules). exclude_submodules is the
    load-bearing default: it is one of the three layers keeping a giant
    submodule from stalling the parent (SURVEY §5 invariant #4).

    Fast path: the native scanner answers without a subprocess whenever it
    can certify the repo; `git status` remains the source of truth for
    everything it declines (filters, similarity renames, sha256, …)."""
    if exclude_submodules:
        st = _native_status(repo, include_untracked)
        if st is not None:
            return st
    args = ["status", "--porcelain=v2", "-z"]
    args.append("--untracked-files=all" if include_untracked else "--untracked-files=no")
    if exclude_submodules:
        args.append("--ignore-submodules=all")
    out = run_git(repo.root, *args, check=False)
    if not out.ok:
        # A failed `git status` (index corruption, repo vanished, hung
        # mount) must SURFACE, not read as "clean tree" — the refresh
        # workers fold the raise into their errors list (invariant #10)
        # instead of silently blanking the staging well.
        from .cli import GitError
        raise GitError(args, out.returncode,
                       out.stderr.strip() or "git status failed")
    return working_dir_status_from_porcelain(out.stdout.split("\x00"))


def stage_file(repo: GitRepo, path: str) -> None:
    """Stage one path — `add` for edits/new files, removal staged for
    deletions (reference: status.rs:153; `git add -A` covers both)."""
    run_git(repo.root, "add", "-A", "--", path)


def stage_all(repo: GitRepo) -> None:
    run_git(repo.root, "add", "-A", ".")


def unstage_file(repo: GitRepo, path: str) -> None:
    """Unstage one path — newly-added files are removed from the index,
    others reset to HEAD (reference: status.rs:181)."""
    if run_git(repo.root, "rev-parse", "--verify", "-q", "HEAD", check=False).ok:
        run_git(repo.root, "reset", "-q", "HEAD", "--", path, check=False)
    else:
        run_git(repo.root, "rm", "--cached", "-q", "--", path, check=False)


def unstage_all(repo: GitRepo) -> None:
    if run_git(repo.root, "rev-parse", "--verify", "-q", "HEAD", check=False).ok:
        run_git(repo.root, "reset", "-q", "HEAD", "--", ".", check=False)
    else:
        run_git(repo.root, "rm", "--cached", "-q", "-r", "--", ".", check=False)
