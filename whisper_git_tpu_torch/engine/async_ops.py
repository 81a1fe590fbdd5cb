"""Async git CLI operations: one worker thread per op, result over a queue,
doorbell wake on completion.

Capability parity with reference src/git/async_ops.rs: the generated op set
(:69-146,278-294), the hand-rolled multi-step ops (:151-497), and the
stderr classifier (:504-611).
"""

from __future__ import annotations

import os
import queue
import subprocess
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

from ..gitcore.cli import git_env
from ..gitcore.types import RemoteOpResult
from .proxy import EventLoopProxy


def _run(workdir: str, args: Sequence[str], input_text: Optional[str] = None,
         ) -> RemoteOpResult:
    proc = subprocess.run(
        ["git", "-c", "core.quotepath=false", "-C", workdir, *args],
        capture_output=True, env=git_env(),
        input=(input_text.encode() if input_text is not None else None))
    return RemoteOpResult(
        success=proc.returncode == 0,
        stderr=proc.stderr.decode("utf-8", "replace"),
        stdout=proc.stdout.decode("utf-8", "replace"))


def run_git_async(workdir: str, args: Sequence[str],
                  proxy: Optional[EventLoopProxy] = None,
                  ) -> "queue.Queue[RemoteOpResult]":
    """Spawn one worker thread running one git subprocess; the result lands
    on the returned queue and the proxy is rung (reference: async_ops.rs:13)."""
    rx: queue.Queue[RemoteOpResult] = queue.Queue(maxsize=1)

    def worker():
        from ..services import crash_log

        crash_log.breadcrumb(f"git op start: {' '.join(args[:3])}")
        try:
            result = _run(workdir, args)
        except Exception as exc:  # worker must never die silently
            result = RemoteOpResult(success=False, stderr=f"worker error: {exc}")
        crash_log.breadcrumb(
            f"git op done: {' '.join(args[:3])} ok={result.success}")
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True,
                     name=f"git-{args[0] if args else 'op'}").start()
    return rx


def _chain_async(workdir: str, steps: list[list[str]],
                 proxy: Optional[EventLoopProxy]
                 ) -> "queue.Queue[RemoteOpResult]":
    """Run several git commands sequentially in one worker; stop on the
    first failure. (Chains needing non-fatal follow-up steps fold their
    own warnings — see create_worktree_with_post_steps_async.)"""
    rx: queue.Queue[RemoteOpResult] = queue.Queue(maxsize=1)

    def worker():
        result = RemoteOpResult(success=True)
        for step in steps:
            result = _run(workdir, step)
            if not result.success:
                break
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="git-chain").start()
    return rx


# ---------------------------------------------------------------------------
# The generated op set (reference: define_async_git_op! macro, rs:55-146).
# ---------------------------------------------------------------------------

def fetch_async(wd, proxy=None):
    return run_git_async(wd, ["fetch"], proxy)

def fetch_all_prune_async(wd, proxy=None):
    return run_git_async(wd, ["fetch", "--all", "--prune"], proxy)

def push_remote_async(wd, remote, branch, proxy=None):
    return run_git_async(wd, ["push", remote, branch], proxy)

def push_force_with_lease_async(wd, remote, branch, proxy=None):
    return run_git_async(wd, ["push", "--force-with-lease", remote, branch], proxy)

def push_refspec_async(wd, remote, refspec, proxy=None):
    return run_git_async(wd, ["push", remote, refspec], proxy)

def push_tags_async(wd, remote, proxy=None):
    return run_git_async(wd, ["push", remote, "--tags"], proxy)

def pull_async(wd, proxy=None):
    return run_git_async(wd, ["pull"], proxy)

def pull_rebase_async(wd, proxy=None):
    return run_git_async(wd, ["pull", "--rebase"], proxy)

def submodule_update_async(wd, path=None, proxy=None):
    args = ["submodule", "update", "--init", "--recursive"]
    if path:
        args += ["--", path]
    return run_git_async(wd, args, proxy)

def submodule_reset_async(wd, path, proxy=None):
    return run_git_async(wd, ["submodule", "update", "--force", "--", path], proxy)

def worktree_add_async(wd, path, branch, proxy=None):
    return run_git_async(wd, ["worktree", "add", "-b", branch, path], proxy)

def worktree_add_detached_async(wd, path, oid, proxy=None):
    return run_git_async(wd, ["worktree", "add", "--detach", path, oid], proxy)

def worktree_remove_async(wd, path, force=False, proxy=None):
    args = ["worktree", "remove"]
    if force:
        args.append("--force")
    args.append(path)
    return run_git_async(wd, args, proxy)

def merge_async(wd, branch, proxy=None):
    return run_git_async(wd, ["merge", branch], proxy)

def merge_no_ff_async(wd, branch, proxy=None):
    return run_git_async(wd, ["merge", "--no-ff", branch], proxy)

def merge_ff_only_async(wd, branch, proxy=None):
    return run_git_async(wd, ["merge", "--ff-only", branch], proxy)

def merge_squash_async(wd, branch, proxy=None):
    return run_git_async(wd, ["merge", "--squash", branch], proxy)

def stash_push_async(wd, message=None, proxy=None):
    args = ["stash", "push"]
    if message:
        args += ["-m", message]
    return run_git_async(wd, args, proxy)

def stash_pop_async(wd, proxy=None):
    return run_git_async(wd, ["stash", "pop"], proxy)

def cherry_pick_async(wd, oid, proxy=None):
    return run_git_async(wd, ["cherry-pick", oid], proxy)

def revert_async(wd, oid, proxy=None):
    return run_git_async(wd, ["revert", "--no-edit", oid], proxy)


# ---------------------------------------------------------------------------
# Hand-rolled multi-step ops (reference: async_ops.rs:151-497).
# ---------------------------------------------------------------------------

def delete_remote_branch_async(wd, remote, branch, proxy=None):
    """Push --delete then prune the local tracking ref (rs:151)."""
    return _chain_async(wd, [
        ["push", remote, "--delete", branch],
        ["fetch", remote, "--prune"],
    ], proxy)


@dataclass(frozen=True)
class PushOptions:
    remote: str
    branch: str
    force_with_lease: bool = False
    set_upstream: bool = False
    push_tags: bool = False


def push_with_options_async(wd, opts: PushOptions, proxy=None):
    """reference: rs:203."""
    args = ["push"]
    if opts.force_with_lease:
        args.append("--force-with-lease")
    if opts.set_upstream:
        args.append("--set-upstream")
    if opts.push_tags:
        args.append("--tags")
    args += [opts.remote, opts.branch]
    return run_git_async(wd, args, proxy)


def clone_async(url: str, dest: str, proxy: Optional[EventLoopProxy] = None,
                ) -> "queue.Queue[RemoteOpResult]":
    """Clone without a workdir; stdout carries the dest path on success
    (reference: rs:231)."""
    rx: queue.Queue[RemoteOpResult] = queue.Queue(maxsize=1)

    def worker():
        proc = subprocess.run(["git", "clone", "--recurse-submodules", url, dest],
                              capture_output=True, env=git_env())
        ok = proc.returncode == 0
        rx.put(RemoteOpResult(
            success=ok,
            stderr=proc.stderr.decode("utf-8", "replace"),
            stdout=dest if ok else proc.stdout.decode("utf-8", "replace")))
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="git-clone").start()
    return rx


@dataclass(frozen=True)
class RebaseOptions:
    onto: str
    autostash: bool = False
    rebase_merges: bool = False


def rebase_with_options_async(wd, opts: RebaseOptions, proxy=None):
    """reference: rs:260."""
    args = ["rebase"]
    if opts.autostash:
        args.append("--autostash")
    if opts.rebase_merges:
        args.append("--rebase-merges")
    args.append(opts.onto)
    return run_git_async(wd, args, proxy)


def stash_apply_async(wd, stash_ref, proxy=None):
    return run_git_async(wd, ["stash", "apply", stash_ref], proxy)

def stash_drop_async(wd, stash_ref, proxy=None):
    return run_git_async(wd, ["stash", "drop", stash_ref], proxy)

def stash_pop_index_async(wd, stash_ref, proxy=None):
    return run_git_async(wd, ["stash", "pop", stash_ref], proxy)


def remove_submodule_async(wd, path, proxy=None):
    """deinit -f + rm -f chain (reference: rs:347)."""
    return _chain_async(wd, [
        ["submodule", "deinit", "-f", "--", path],
        ["rm", "-f", "--", path],
    ], proxy)


def create_worktree_with_post_steps_async(wd, path, branch, proxy=None,
                                          base: Optional[str] = None):
    """worktree add → submodule update --init --recursive → lfs checkout,
    non-fatal step failures folded into warnings (reference: rs:399)."""
    add = ["worktree", "add", "-b", branch, path]
    if base:
        add.append(base)
    rx: queue.Queue[RemoteOpResult] = queue.Queue(maxsize=1)

    def worker():
        result = _run(wd, add)
        warnings: list[str] = []
        if result.success:
            for step in (["submodule", "update", "--init", "--recursive"],
                         ["lfs", "checkout"]):
                sub = _run(path, step)
                if not sub.success and sub.stderr.strip():
                    # lfs not installed — silently fine. git prints
                    # "git: 'lfs' is not a git command" (no "git-lfs"!);
                    # keep both spellings matched.
                    if step[0] == "lfs" and (
                            "'lfs' is not a git command" in sub.stderr
                            or "git-lfs" in sub.stderr):
                        continue
                    warnings.append(sub.stderr.strip())
            result = RemoteOpResult(success=True, stderr="\n".join(warnings),
                                    stdout=path)
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="git-worktree-create").start()
    return rx


# ---------------------------------------------------------------------------
# Error classifier (reference: async_ops.rs:504-611) — stderr → friendly
# message + retryable flag (retryable means "offer force-push").
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClassifiedError:
    message: str
    retryable: bool = False  # rejected/non-fast-forward → offer force push


def classify_git_error(stderr: str) -> ClassifiedError:
    s = stderr.lower()
    if ("authentication failed" in s or "could not read username" in s
            or "could not read password" in s or "invalid credentials" in s
            or "terminal prompts disabled" in s):
        return ClassifiedError(
            "Authentication failed. Check your credentials or access token.")
    if "permission denied" in s and ("publickey" in s or "(publickey" in s):
        return ClassifiedError(
            "SSH key rejected. Check that your key is added to the remote host.")
    if "permission" in s and "denied" in s:
        return ClassifiedError("Permission denied by the remote.")
    if "host key verification failed" in s:
        return ClassifiedError(
            "Host key verification failed. Connect once via ssh to trust the host.")
    if "repository not found" in s or ("404" in s and "not found" in s):
        return ClassifiedError("Repository not found (check the URL and your access).")
    if ("could not resolve host" in s or "network is unreachable" in s
            or "connection refused" in s or "connection timed out" in s
            or "operation timed out" in s or "unable to access" in s):
        return ClassifiedError("Network error: could not reach the remote.")
    if "would be overwritten by" in s or "overwritten by checkout" in s or "overwritten by merge" in s:
        return ClassifiedError(
            "Local changes would be overwritten. Commit or stash them first.")
    if ("non-fast-forward" in s or "fetch first" in s
            or ("rejected" in s and "push" in s) or "stale info" in s):
        return ClassifiedError(
            "Push rejected: the remote has newer commits. Pull first, or force-push.",
            retryable=True)
    if "conflict" in s and ("merge" in s or "cherry-pick" in s or "rebase" in s or "automatic" in s):
        return ClassifiedError(
            "Conflicts detected. Resolve them, then continue or abort the operation.")
    if "you have unstaged changes" in s or "cannot rebase" in s:
        return ClassifiedError("Unstaged changes present. Commit or stash them first.")
    first_line = next((l for l in stderr.splitlines() if l.strip()), "git operation failed")
    return ClassifiedError(first_line.strip())


# -- in-progress operation control (beyond-reference: the reference shows
# the MERGING/REBASING state pill but offers no way out in-app) ---------------

def merge_abort_async(wd, proxy=None):
    return run_git_async(wd, ["merge", "--abort"], proxy)


def merge_continue_async(wd, proxy=None):
    # core.editor=true accepts the prepared message without an editor.
    return run_git_async(wd, ["-c", "core.editor=true", "merge",
                              "--continue"], proxy)


def rebase_abort_async(wd, proxy=None):
    return run_git_async(wd, ["rebase", "--abort"], proxy)


def rebase_continue_async(wd, proxy=None):
    return run_git_async(wd, ["-c", "core.editor=true", "rebase",
                              "--continue"], proxy)


def cherry_pick_abort_async(wd, proxy=None):
    return run_git_async(wd, ["cherry-pick", "--abort"], proxy)


def cherry_pick_continue_async(wd, proxy=None):
    return run_git_async(wd, ["-c", "core.editor=true", "cherry-pick",
                              "--continue"], proxy)


def revert_abort_async(wd, proxy=None):
    return run_git_async(wd, ["revert", "--abort"], proxy)


def revert_continue_async(wd, proxy=None):
    return run_git_async(wd, ["-c", "core.editor=true", "revert",
                              "--continue"], proxy)


# -- interactive rebase (beyond-reference: "Interactive rebase" sits on the
# reference's Deferred list, docs/user_needs.md) ------------------------------

def interactive_rebase_async(wd, onto: str, todo_lines: Sequence[str],
                             proxy=None):
    """Run `git rebase -i <onto>` with a pre-authored todo list.

    The UI edits the plan (pick/squash/fixup/drop + reorder); here the
    todo is written to a temp file and GIT_SEQUENCE_EDITOR (`cp <file>`)
    replaces git's generated list with it — no terminal editor ever
    opens. core.editor=true accepts squash/fixup messages as-is.
    """
    import shlex
    import tempfile

    fd, todo_path = tempfile.mkstemp(prefix="wgit-rebase-todo-",
                                     suffix=".txt")
    with os.fdopen(fd, "w") as f:
        f.write("\n".join(todo_lines) + "\n")
    # git runs the sequence editor through the shell: the path MUST be
    # quoted or a TMPDIR with spaces word-splits the command and git
    # proceeds with its own todo list — a different rebase than the one
    # the UI showed.
    rx = run_git_async(wd, ["-c",
                            f"sequence.editor=cp {shlex.quote(todo_path)}",
                            "-c", "core.editor=true",
                            "rebase", "-i", onto], proxy)

    # Clean the temp file up after the op lands without blocking the
    # caller: wrap the queue so the first get also unlinks.
    out: "queue.Queue[RemoteOpResult]" = queue.Queue(maxsize=1)

    def relay():
        result = rx.get()
        try:
            os.unlink(todo_path)
        except OSError:
            pass
        out.put(result)

    threading.Thread(target=relay, daemon=True).start()
    return out
