"""Ref / branch / tag / remote / reset operations.

Capability parity with reference src/git/refs.rs: safe checkout, detached
checkout, remote-branch checkout with tracking, branch delete/rename, reset
soft/mixed/hard, branch/tag creation at an OID, amend, per-file discard,
full commit info, submodule-pin queries, remote CRUD, and LFS detection.
"""

from __future__ import annotations

import configparser
import os
import re
from typing import Optional

from .cli import run_git
from .diff import parse_name_status
from .repo import GitRepo, _FIELD_SEP
from .types import FullCommitInfo, SubmoduleInfo


# -- checkout ---------------------------------------------------------------

def checkout_branch(repo: GitRepo, branch: str) -> None:
    """Safe checkout of a local branch (reference: refs.rs:94 — tree checkout
    with conflict safety, then set_head)."""
    run_git(repo.root, "checkout", branch)


def checkout_detached(repo: GitRepo, oid: str) -> None:
    """reference: refs.rs:124."""
    run_git(repo.root, "checkout", "--detach", oid)


def checkout_remote_branch(repo: GitRepo, remote_branch: str) -> None:
    """Create a local tracking branch from `remote/branch` and check it out
    (reference: refs.rs:146)."""
    local = remote_branch.split("/", 1)[1] if "/" in remote_branch else remote_branch
    run_git(repo.root, "checkout", "-b", local, "--track", remote_branch)


def set_head_to(repo: GitRepo, branch: str) -> None:
    """Point HEAD at a branch without touching the tree (reference: refs.rs:197)."""
    run_git(repo.root, "symbolic-ref", "HEAD", f"refs/heads/{branch}")


# -- branch / tag CRUD ------------------------------------------------------

def delete_branch(repo: GitRepo, branch: str, force: bool = False) -> None:
    run_git(repo.root, "branch", "-D" if force else "-d", branch)


def rename_branch(repo: GitRepo, old: str, new: str) -> None:
    run_git(repo.root, "branch", "-m", old, new)


def create_branch_at(repo: GitRepo, name: str, oid: str) -> None:
    """reference: refs.rs:256."""
    run_git(repo.root, "branch", name, oid)


def create_tag_at(repo: GitRepo, name: str, oid: str, message: Optional[str] = None) -> None:
    """reference: refs.rs:268 (annotated when a message is given)."""
    if message:
        run_git(repo.root, "tag", "-a", name, "-m", message, oid)
    else:
        run_git(repo.root, "tag", name, oid)


def delete_tag(repo: GitRepo, name: str) -> None:
    run_git(repo.root, "tag", "-d", name)


# -- reset / amend / discard ------------------------------------------------

def reset(repo: GitRepo, oid: str, mode: str = "mixed") -> None:
    """reference: refs.rs:244. mode in {soft, mixed, hard}."""
    assert mode in ("soft", "mixed", "hard"), mode
    run_git(repo.root, "reset", f"--{mode}", oid)


def amend_commit(repo: GitRepo, message: str) -> None:
    """reference: refs.rs:326."""
    run_git(repo.root, "commit", "--amend", "-m", message)


def discard_file(repo: GitRepo, path: str) -> None:
    """Discard one file's unstaged changes: delete if untracked, else force
    checkout from the index (reference: refs.rs:368)."""
    tracked = run_git(repo.root, "ls-files", "--error-unmatch", "--", path, check=False)
    if not tracked.ok:
        full = os.path.join(repo.workdir or repo.root, path)
        if os.path.isdir(full) and not os.path.islink(full):
            import shutil
            shutil.rmtree(full, ignore_errors=True)
        elif os.path.lexists(full):
            os.unlink(full)
        return
    run_git(repo.root, "checkout-index", "--force", "--", path)


# -- commit detail ----------------------------------------------------------

def full_commit_info(repo: GitRepo, oid: str) -> Optional[FullCommitInfo]:
    """Full metadata + per-file ± stats for the details pane
    (reference: refs.rs:403)."""
    fmt = _FIELD_SEP.join(["%H", "%P", "%an", "%ae", "%cn", "%ce", "%at", "%ct", "%B"])
    out = run_git(repo.root, "log", "-z", "-1", f"--format={fmt}", oid, "--", check=False)
    if not out.ok or not out.stdout:
        return None
    rec = out.stdout.split("\x00")[0]
    # maxsplit=8: %B is last and may contain 0x1f — an unbounded split
    # would silently truncate the message at the first separator byte.
    parts = rec.split(_FIELD_SEP, 8)
    if len(parts) < 9:
        return None
    h, parents, an, ae, cn, ce, at, ct, message = parts[:9]
    files = parse_name_status(repo, oid)
    return FullCommitInfo(
        oid=h, parents=tuple(parents.split()) if parents else (),
        author_name=an, author_email=ae, committer_name=cn, committer_email=ce,
        author_time=int(at or 0), commit_time=int(ct or 0),
        message=message.rstrip("\n"), files=tuple(files),
    )


# -- submodule pin queries --------------------------------------------------

def submodules_at_commit(repo: GitRepo, oid: str) -> list[SubmoduleInfo]:
    """Gitlink entries in a commit's tree + .gitmodules metadata at that
    commit, with a changed-vs-parent flag folded into `workdir_oid=None`
    semantics (reference: refs.rs:478-587 — tree walk for ObjectType::Commit
    entries + .gitmodules INI parse)."""
    ls = run_git(repo.root, "ls-tree", "-r", "-z", oid, check=False)
    if not ls.ok:
        return []
    pins: dict[str, str] = {}
    for rec in ls.stdout.split("\x00"):
        if rec.startswith("160000 "):
            meta, path = rec.split("\t", 1)
            pins[path] = meta.split()[2]
    if not pins:
        return []
    gm_blob = run_git(repo.root, "show", f"{oid}:.gitmodules", check=False)
    names: dict[str, tuple[str, Optional[str]]] = {}
    if gm_blob.ok:
        cp = configparser.ConfigParser()
        try:
            cp.read_string(gm_blob.stdout)
            for section in cp.sections():
                m = re.match(r'submodule "(.*)"', section)
                if not m:
                    continue
                path = cp.get(section, "path", fallback=None)
                url = cp.get(section, "url", fallback=None)
                if path:
                    names[path] = (m.group(1), url)
        except configparser.Error:
            pass
    subs: list[SubmoduleInfo] = []
    for path, pin in sorted(pins.items()):
        name, url = names.get(path, (path, None))
        subs.append(SubmoduleInfo(name=name, path=path, url=url, head_oid=pin))
    return subs


def submodule_pin_changed(repo: GitRepo, oid: str, sub_path: str) -> bool:
    """Whether a commit changed the pin of `sub_path` vs its first parent.

    -m + --first-parent: a plain diff-tree prints NOTHING for merge
    commits (false negative); --root covers root commits; -z + exact
    per-record compare handles paths containing whitespace."""
    out = run_git(repo.root, "diff-tree", "--no-commit-id", "--name-only",
                  "-r", "-z", "-m", "--first-parent", "--root", oid,
                  "--", sub_path, check=False)
    return out.ok and sub_path in out.stdout.split("\x00")


def local_branches_with_submodule_pin(repo: GitRepo, sub_path: str, pin: str) -> list[str]:
    """Local branches whose tip tree pins `sub_path` at `pin`
    (reference: refs.rs:431)."""
    matches: list[str] = []
    out = run_git(repo.root, "for-each-ref", "--format=%(refname:short)%00%(objectname)",
                  "refs/heads", check=False)
    if not out.ok:
        return []
    for line in out.stdout.splitlines():
        if "\x00" not in line:
            continue
        name, tip = line.split("\x00", 1)
        ls = run_git(repo.root, "ls-tree", tip, "--", sub_path, check=False)
        if ls.ok and ls.stdout.startswith("160000 ") and pin in ls.stdout:
            matches.append(name)
    return matches


# -- remotes ----------------------------------------------------------------

def add_remote(repo: GitRepo, name: str, url: str) -> None:
    run_git(repo.root, "remote", "add", name, url)


def remove_remote(repo: GitRepo, name: str) -> None:
    run_git(repo.root, "remote", "remove", name)


def rename_remote(repo: GitRepo, old: str, new: str) -> None:
    run_git(repo.root, "remote", "rename", old, new)


def set_remote_url(repo: GitRepo, name: str, url: str) -> None:
    run_git(repo.root, "remote", "set-url", name, url)


def remote_missing_fetch_refspec(repo: GitRepo, name: str) -> bool:
    """Detect remotes configured without a fetch refspec (reference:
    refs.rs:600 — happens after `remote add -t` style setups)."""
    out = run_git(repo.root, "config", "--get-all", f"remote.{name}.fetch", check=False)
    return not (out.ok and out.stdout.strip())


def add_default_fetch_refspec(repo: GitRepo, name: str) -> None:
    """reference: refs.rs:615."""
    run_git(repo.root, "config", "--add", f"remote.{name}.fetch",
            f"+refs/heads/*:refs/remotes/{name}/*")


def has_lfs(repo: GitRepo) -> bool:
    """Whether the repo uses git-lfs (reference: refs.rs:40 — checks
    .gitattributes for lfs filters)."""
    if repo.workdir is None:
        return False
    ga = os.path.join(repo.workdir, ".gitattributes")
    try:
        with open(ga, "r", encoding="utf-8", errors="replace") as f:
            return "filter=lfs" in f.read()
    except OSError:
        return False


# -- conflict resolution (beyond-reference: the reference defers "Merge
# conflict resolution", docs/user_needs.md Deferred list) --------------------

def resolve_conflict_side(repo: GitRepo, path: str, side: str) -> None:
    """Resolve a conflicted path by taking one side wholesale, then stage
    it. side: "ours" (current branch) | "theirs" (incoming)."""
    if side not in ("ours", "theirs"):
        raise ValueError(f"side must be ours|theirs, got {side!r}")
    run_git(repo.root, "checkout", f"--{side}", "--", path)
    run_git(repo.root, "add", "--", path)


def rebase_plan(repo: GitRepo, onto: str) -> list[tuple[str, str]]:
    """(oid, subject) pairs for `onto..HEAD`, oldest first — the todo
    order `git rebase -i` expects."""
    out = run_git(repo.root, "log", "--reverse", "--format=%H%x00%s",
                  f"{onto}..HEAD")
    plan = []
    for line in out.stdout.splitlines():
        if "\x00" in line:
            oid, _, subject = line.partition("\x00")
            plan.append((oid, subject))
    return plan
