"""Subprocess plumbing for `git`.

Every backend call shells to `git` with a pinned environment
(`GIT_TERMINAL_PROMPT=0`, like the reference forces on all children —
reference: src/git/async_ops.rs:26 — plus stable locale so parse formats
never vary).
"""

from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass
from typing import Optional, Sequence


class GitError(RuntimeError):
    def __init__(self, args: Sequence[str], returncode: int, stderr: str):
        super().__init__(f"git {' '.join(args)} failed ({returncode}): {stderr.strip()}")
        self.args_list = list(args)
        self.returncode = returncode
        self.stderr = stderr


@dataclass(frozen=True)
class GitOutput:
    returncode: int
    stdout: str
    stderr: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def git_env(extra: Optional[dict] = None) -> dict:
    env = dict(os.environ)
    env["GIT_TERMINAL_PROMPT"] = "0"
    env["LC_ALL"] = "C"
    # Background refresh threads run `git status` concurrently with user
    # write ops (commit/stage).  Optional locks make `status` grab
    # index.lock to refresh the stat cache, which races the write op into
    # "Unable to create index.lock: File exists".  Disable them: queries
    # stay lock-free, writes still take the (mandatory) lock.
    env["GIT_OPTIONAL_LOCKS"] = "0"
    # Never let user config rewrite our plumbing output formats.
    env.setdefault("GIT_PAGER", "cat")
    if extra:
        env.update(extra)
    return env


def run_git(
    workdir: Optional[str],
    *args: str,
    check: bool = True,
    input_text: Optional[str] = None,
    timeout: Optional[float] = 120.0,
    binary: bool = False,
) -> GitOutput:
    """Run one git command. `workdir=None` runs without -C (e.g. clone)."""
    # quotepath=false: never C-quote non-ASCII paths in diff/status output
    # (our parsers want raw UTF-8 paths).
    cmd = ["git", "-c", "core.quotepath=false"]
    if workdir is not None:
        cmd += ["-C", workdir]
    cmd += list(args)
    # A concurrent writer (another worktree handle, an IDE, a pre-commit
    # hook) can hold index.lock for a moment; retry briefly rather than
    # surfacing a spurious failure to the user.
    for attempt in range(4):
        try:
            proc = subprocess.run(
                cmd,
                capture_output=True,
                env=git_env(),
                input=(input_text.encode() if input_text is not None
                       else None),
                timeout=timeout,
            )
        except (subprocess.TimeoutExpired, FileNotFoundError, OSError) as exc:
            # check=False promises "never raises": a hung NFS mount
            # (timeout) or git missing from PATH must degrade like any
            # failed command, not crash no-raise-style call sites.
            if check:
                raise GitError(list(args), -1, str(exc)) from exc
            return GitOutput(returncode=-1,
                             stdout=(b"" if binary else ""),
                             stderr=f"git did not run: {exc}")
        if proc.returncode == 0:
            break
        err_snippet = proc.stderr.decode("utf-8", "replace")
        if "index.lock" not in err_snippet or attempt == 3:
            break
        time.sleep(0.05 * (attempt + 1))
    if binary:
        stdout = proc.stdout
        stderr = proc.stderr.decode("utf-8", "replace")
    else:
        stdout = proc.stdout.decode("utf-8", "replace")
        stderr = proc.stderr.decode("utf-8", "replace")
    out = GitOutput(proc.returncode, stdout, stderr)
    if check and proc.returncode != 0:
        raise GitError(args, proc.returncode, stderr)
    return out


def git_lines(workdir: str, *args: str, sep: str = "\n") -> list[str]:
    out = run_git(workdir, *args).stdout
    if not out:
        return []
    parts = out.split(sep)
    if parts and parts[-1] == "":
        parts.pop()
    return parts
