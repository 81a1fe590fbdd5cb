"""Hunk-level staging: build a minimal unified patch for one hunk and apply
it to the index (or reverse it in the worktree for discard).

Capability parity with reference src/git/hunk.rs: `build_hunk_patch`
(hunk.rs:114), `apply_hunk_patch` via `git apply --cached [--reverse]
--unidiff-zero -` (hunk.rs:22), and `discard_hunk` applying the reverse to
the worktree without `--cached` (hunk.rs:74).
"""

from __future__ import annotations

from .cli import run_git
from .repo import GitRepo
from .types import DiffHunk, RemoteOpResult


def build_hunk_patch(path: str, hunk: DiffHunk) -> str:
    """Minimal unified patch containing exactly one hunk. (Renamed files
    are not hunk-staged through this path: a rename-form header without
    'rename from/to' lines is rejected by `git apply --cached`, and no
    caller ever supplied one — the UI stages renames whole-file.)"""
    lines = [f"--- a/{path}", f"+++ b/{path}",
             f"@@ -{hunk.old_start},{hunk.old_lines} +{hunk.new_start},{hunk.new_lines} @@"]
    for dl in hunk.lines:
        lines.append(f"{dl.origin}{dl.content}")
        if dl.no_newline:
            lines.append("\\ No newline at end of file")
    return "\n".join(lines) + "\n"


def apply_hunk_patch(repo: GitRepo, patch: str, reverse: bool = False) -> RemoteOpResult:
    """Stage (or unstage with reverse=True) one hunk in the index."""
    args = ["apply", "--cached", "--unidiff-zero"]
    if reverse:
        args.append("--reverse")
    args.append("-")
    out = run_git(repo.root, *args, input_text=patch, check=False)
    return RemoteOpResult(success=out.ok, stderr=out.stderr, stdout=out.stdout)


def stage_hunk(repo: GitRepo, path: str, hunk: DiffHunk) -> RemoteOpResult:
    return apply_hunk_patch(repo, build_hunk_patch(path, hunk))


def unstage_hunk(repo: GitRepo, path: str, hunk: DiffHunk) -> RemoteOpResult:
    return apply_hunk_patch(repo, build_hunk_patch(path, hunk), reverse=True)


def discard_hunk(repo: GitRepo, path: str, hunk: DiffHunk) -> RemoteOpResult:
    """Apply the reverse patch to the worktree (no --cached)."""
    patch = build_hunk_patch(path, hunk)
    out = run_git(repo.root, "apply", "--reverse", "--unidiff-zero", "-",
                  input_text=patch, check=False)
    return RemoteOpResult(success=out.ok, stderr=out.stderr, stdout=out.stdout)
