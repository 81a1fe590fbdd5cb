"""GitRepo — synchronous git backend core.

Capability parity with the reference's `GitRepo` (reference:
src/git/mod.rs:423-1232): discover/open/reopen, bare detection, capped
commit walk over all branch tips, orphan recovery from reflogs, chunked
diff-stat computation, branch/tag/worktree/submodule/stash enumeration,
ahead/behind, ref fingerprinting, and repo-state labels.

All methods are safe to call from worker threads; each spawns its own
plumbing subprocess (no shared mutable handle state), which also gives us
`reopen` semantics for free (there is no ref cache to bypass — but the
method is kept so the engine's invariant #7 call sites read the same).
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional

from .cli import git_lines, run_git
from .types import (
    BranchTip,
    CommitInfo,
    StashEntry,
    SubmoduleInfo,
    TagInfo,
    WorktreeInfo,
    repo_state_label,
)

MAX_COMMITS = 1000          # reference: src/git_async.rs:49
ORPHAN_CAP = 100            # reference: src/git/mod.rs:765
ORPHAN_PARENT_DEPTH = 10    # reference: src/git/mod.rs:729
DIFF_STATS_CHUNK = 50       # reference: src/git/mod.rs:31

_FIELD_SEP = "\x1f"
_LOG_FORMAT = _FIELD_SEP.join(["%H", "%h", "%P", "%an", "%ae", "%at", "%s"])


class GitRepo:
    """A discovered git repository (possibly a linked worktree)."""

    def __init__(self, workdir: Optional[str], git_dir: str, common_dir: str, bare: bool):
        self.workdir = workdir
        self.git_dir = git_dir
        self.common_dir = common_dir
        self.bare = bare

    # -- open / reopen ------------------------------------------------------

    @classmethod
    def open(cls, path: str) -> "GitRepo":
        """Discover the repository containing `path` (reference: mod.rs:450
        uses Repository::discover)."""
        path = os.path.abspath(path)
        probe = path if os.path.isdir(path) else os.path.dirname(path)
        out = run_git(probe, "rev-parse", "--path-format=absolute",
                      "--git-dir", "--git-common-dir", "--is-bare-repository")
        git_dir, common_dir, bare_s = out.stdout.splitlines()[:3]
        bare = bare_s.strip() == "true"
        workdir = None
        if not bare:
            top = run_git(probe, "rev-parse", "--show-toplevel", check=False)
            if top.ok and top.stdout.strip():
                workdir = top.stdout.strip()
            else:
                bare = True
        return cls(workdir, git_dir, common_dir, bare)

    def reopen(self) -> "GitRepo":
        """Fresh handle bypassing any cache (reference: mod.rs:460). With CLI
        plumbing every call is already fresh; re-discover anyway so a moved
        or re-created repo is picked up."""
        return GitRepo.open(self.workdir or self.git_dir)

    @property
    def root(self) -> str:
        """Directory to run git commands in."""
        return self.workdir if self.workdir else self.git_dir

    def is_effectively_bare(self) -> bool:
        """Bare, or a gitdir without a usable workdir (reference: mod.rs:431)."""
        return self.bare or self.workdir is None

    def repo_name(self) -> str:
        """Human repo name heuristic (reference: mod.rs:850): workdir basename,
        or the gitdir's parent basename for bare repos, stripping `.git`."""
        if self.workdir:
            return os.path.basename(self.workdir.rstrip(os.sep))
        base = os.path.basename(self.common_dir.rstrip(os.sep))
        if base in (".git", ".bare"):
            # The bare-repo-with-worktrees layout (reference README:
            # 365-377: proj/.bare + proj/.git pointer): the project name
            # is the PARENT directory, not the hidden store's.
            return os.path.basename(
                os.path.dirname(self.common_dir.rstrip(os.sep)))
        return base[:-4] if base.endswith(".git") else base

    # -- HEAD / state -------------------------------------------------------

    def head_oid(self) -> Optional[str]:
        out = run_git(self.root, "rev-parse", "--verify", "-q", "HEAD", check=False)
        return out.stdout.strip() or None if out.ok else None

    def current_branch(self) -> Optional[str]:
        """Checked-out branch short name; None when detached/unborn
        (reference: mod.rs:871 with bare-repo fallbacks)."""
        out = run_git(self.root, "symbolic-ref", "-q", "--short", "HEAD", check=False)
        if out.ok and out.stdout.strip():
            return out.stdout.strip()
        return None

    def unborn_branch(self) -> Optional[str]:
        """Branch name HEAD points at when no commit exists yet."""
        if self.head_oid() is None:
            out = run_git(self.root, "symbolic-ref", "-q", "--short", "HEAD", check=False)
            if out.ok and out.stdout.strip():
                return out.stdout.strip()
        return None

    def repo_state(self) -> Optional[str]:
        """In-progress operation label, e.g. 'Merging' (reference: mod.rs:82)."""
        gd = self.git_dir
        if os.path.isdir(os.path.join(gd, "rebase-merge")):
            interactive = os.path.exists(os.path.join(gd, "rebase-merge", "interactive"))
            return repo_state_label("rebase-interactive" if interactive else "rebase-merge")
        if os.path.isdir(os.path.join(gd, "rebase-apply")):
            rebasing = os.path.exists(os.path.join(gd, "rebase-apply", "rebasing"))
            return repo_state_label("rebase" if rebasing else "apply-mailbox")
        for marker, state in [("MERGE_HEAD", "merge"), ("CHERRY_PICK_HEAD", "cherry-pick"),
                              ("REVERT_HEAD", "revert"), ("BISECT_LOG", "bisect")]:
            if os.path.exists(os.path.join(gd, marker)):
                return repo_state_label(state)
        return None

    # -- commit walk --------------------------------------------------------

    def _parse_log_records(self, blob: str) -> list[CommitInfo]:
        commits: list[CommitInfo] = []
        for rec in blob.split("\x00"):
            if not rec:
                continue
            # maxsplit=6: the SUBJECT is the last field and may itself
            # contain the 0x1f separator (legal in git) — an unbounded
            # split would make the commit silently vanish from the graph.
            parts = rec.split(_FIELD_SEP, 6)
            if len(parts) != 7:
                continue
            oid, short, parents, an, ae, at, subject = parts
            commits.append(CommitInfo(
                oid=oid, short=short, summary=subject,
                author_name=an, author_email=ae,
                timestamp=int(at or 0),
                parents=parents.split() if parents else [],
            ))
        return commits

    def commit_graph(self, max_commits: int = MAX_COMMITS) -> list[CommitInfo]:
        """Topo|time walk over all branch tips + HEAD, capped
        (reference: mod.rs:570)."""
        out = run_git(
            self.root, "log", "-z", "--topo-order",
            f"--max-count={max_commits}", f"--format={_LOG_FORMAT}",
            "--branches", "--remotes", "HEAD", "--", check=False)
        if not out.ok:
            # Unborn HEAD / empty repo: try branches only, else empty.
            out = run_git(self.root, "log", "-z", "--topo-order",
                          f"--max-count={max_commits}", f"--format={_LOG_FORMAT}",
                          "--branches", "--remotes", "--", check=False)
            if not out.ok:
                return []
        return self._parse_log_records(out.stdout)

    def orphaned_commits_from_reflogs(
        self, reachable: set[str],
        cap: int = ORPHAN_CAP, parent_depth: int = ORPHAN_PARENT_DEPTH,
    ) -> list[CommitInfo]:
        """Recover commits only reachable from reflogs (reference:
        mod.rs:629-758): collect reflog OIDs, drop reachable ones, then walk
        parent chains up to `parent_depth`, capped at `cap` rows."""
        out = run_git(self.root, "reflog", "show", "--all", "--format=%H", check=False)
        candidates: list[str] = []
        seen: set[str] = set()
        if out.ok:
            for line in out.stdout.splitlines():
                oid = line.strip()
                if oid and oid not in seen:
                    seen.add(oid)
                    candidates.append(oid)
        head_rl = run_git(self.root, "reflog", "show", "HEAD", "--format=%H", check=False)
        if head_rl.ok:
            for line in head_rl.stdout.splitlines():
                oid = line.strip()
                if oid and oid not in seen:
                    seen.add(oid)
                    candidates.append(oid)

        orphans: list[CommitInfo] = []
        visited: set[str] = set(reachable)
        frontier = [oid for oid in candidates if oid not in reachable]
        depth = 0
        # Breadth-first over parent chains, one batched `git log --no-walk`
        # per depth level instead of one subprocess per commit.
        while frontier and len(orphans) < cap and depth <= parent_depth:
            batch = [o for o in frontier if o not in visited][:cap]
            if not batch:
                break
            visited.update(batch)
            rec = run_git(self.root, "log", "-z", "--no-walk=unsorted",
                          f"--format={_LOG_FORMAT}", *batch, "--",
                          check=False)
            if not rec.ok:
                # A gc'd candidate fails the whole batch: filter to commits
                # that still exist (one cat-file --batch-check call).
                chk = run_git(self.root, "cat-file", "--batch-check",
                              check=False,
                              input_text="\n".join(batch) + "\n")
                valid = [line.split()[0] for line in chk.stdout.splitlines()
                         if " commit " in line] if chk.ok else []
                rec = run_git(self.root, "log", "-z", "--no-walk=unsorted",
                              f"--format={_LOG_FORMAT}", *valid, "--",
                              check=False) if valid else rec
            next_frontier: list[str] = []
            if rec.ok and rec.stdout:
                for info in self._parse_log_records(rec.stdout):
                    if len(orphans) >= cap:
                        break
                    info.is_orphan = True
                    orphans.append(info)
                    next_frontier.extend(p for p in info.parents
                                         if p not in visited)
            frontier = next_frontier
            depth += 1
        return orphans

    def commit_graph_with_orphans(self, max_commits: int = MAX_COMMITS) -> list[CommitInfo]:
        """reference: mod.rs:761 — walk + reflog-orphan recovery, merged by
        timestamp into the newest-first list."""
        commits = self.commit_graph(max_commits)
        reachable = {c.oid for c in commits}
        orphans = self.orphaned_commits_from_reflogs(reachable)
        if not orphans:
            return commits
        merged = commits + orphans
        merged.sort(key=lambda c: -c.timestamp)
        return merged

    # -- diff stats ---------------------------------------------------------

    def diff_stats_for_commits(self, oids: list[str]) -> dict[str, tuple[int, int]]:
        """(+adds, -dels) per commit vs its first parent. Batched over one
        `git log --numstat` invocation per chunk (reference computes these in
        a chunked worker, mod.rs:783; chunk size DIFF_STATS_CHUNK)."""
        stats: dict[str, tuple[int, int]] = {}
        for i in range(0, len(oids), DIFF_STATS_CHUNK):
            chunk = oids[i:i + DIFF_STATS_CHUNK]
            # -m --first-parent: without it git emits NO numstat for
            # merge commits, so every merge showed +0 −0 (the documented
            # contract is "vs its first parent"). This spelling — unlike
            # --diff-merges=first-parent — also works on git < 2.31,
            # where the newer flag would fail the whole chunk and drop
            # stats for EVERY commit.
            out = run_git(self.root, "log", "--no-walk=unsorted", "--numstat",
                          "-m", "--first-parent",
                          "--format=\x01%H", *chunk, "--", check=False)
            if not out.ok:
                continue
            cur: Optional[str] = None
            adds = dels = 0
            for line in out.stdout.splitlines():
                if line.startswith("\x01"):
                    if cur is not None:
                        stats[cur] = (adds, dels)
                    cur = line[1:].strip()
                    adds = dels = 0
                elif line.strip():
                    m = re.match(r"^(\d+|-)\t(\d+|-)\t", line)
                    if m:
                        if m.group(1) != "-":
                            adds += int(m.group(1))
                        if m.group(2) != "-":
                            dels += int(m.group(2))
            if cur is not None:
                stats[cur] = (adds, dels)
        return stats

    def working_tree_diff_stats(self) -> tuple[int, int]:
        """Total (+, −) of the working tree vs HEAD (reference: mod.rs:503)."""
        adds = dels = 0
        out = run_git(self.root, "diff", "HEAD", "--numstat", check=False)
        if not out.ok:
            out = run_git(self.root, "diff", "--numstat", check=False)
        for line in out.stdout.splitlines() if out.ok else []:
            m = re.match(r"^(\d+|-)\t(\d+|-)\t", line)
            if m:
                if m.group(1) != "-":
                    adds += int(m.group(1))
                if m.group(2) != "-":
                    dels += int(m.group(2))
        return adds, dels

    # -- refs enumeration ---------------------------------------------------

    def branch_tips(self) -> list[BranchTip]:
        """All local + remote branch tips with upstream + ahead/behind
        (reference: mod.rs:1073 and all_branches_ahead_behind :922)."""
        head_branch = self.current_branch()
        fmt = "%00".join(["%(refname)", "%(objectname)",
                          "%(upstream:short)", "%(upstream:track,nobracket)"])
        tips: list[BranchTip] = []
        for line in git_lines(self.root, "for-each-ref", f"--format={fmt}",
                              "refs/heads", "refs/remotes"):
            refname, oid, upstream, track = (line.split("\x00") + ["", "", "", ""])[:4]
            is_remote = refname.startswith("refs/remotes/")
            short = refname[len("refs/remotes/"):] if is_remote else refname[len("refs/heads/"):]
            if is_remote and short.endswith("/HEAD"):
                continue
            ahead = behind = 0
            if track and track != "gone":
                m = re.search(r"ahead (\d+)", track)
                if m:
                    ahead = int(m.group(1))
                m = re.search(r"behind (\d+)", track)
                if m:
                    behind = int(m.group(1))
            tips.append(BranchTip(
                name=short, oid=oid, is_remote=is_remote,
                is_head=(not is_remote and short == head_branch),
                upstream=upstream or None, ahead=ahead, behind=behind,
            ))
        return tips

    def tags(self) -> list[TagInfo]:
        """Tags with peeled commit targets (reference: mod.rs:1120)."""
        fmt = "%00".join(["%(refname:short)", "%(objectname)", "%(*objectname)",
                          "%(contents:subject)"])
        out: list[TagInfo] = []
        for line in git_lines(self.root, "for-each-ref", f"--format={fmt}", "refs/tags"):
            name, oid, peeled, subject = (line.split("\x00") + [""] * 4)[:4]
            out.append(TagInfo(name=name, oid=peeled or oid, message=subject or None))
        return out

    def worktrees(self) -> list[WorktreeInfo]:
        """reference: mod.rs:1031 — via `git worktree list --porcelain`."""
        out = run_git(self.root, "worktree", "list", "--porcelain", check=False)
        if not out.ok:
            return []
        entries: list[WorktreeInfo] = []
        cur: dict = {}
        blocks = out.stdout.split("\n\n")
        for block in blocks:
            if not block.strip():
                continue
            cur = {"locked": False, "prunable": False, "bare": False,
                   "detached": False, "branch": None, "head": None, "path": None}
            for line in block.splitlines():
                if line.startswith("worktree "):
                    cur["path"] = line[len("worktree "):]
                elif line.startswith("HEAD "):
                    cur["head"] = line[len("HEAD "):]
                elif line.startswith("branch "):
                    b = line[len("branch "):]
                    cur["branch"] = b[len("refs/heads/"):] if b.startswith("refs/heads/") else b
                elif line == "bare":
                    cur["bare"] = True
                elif line == "detached":
                    cur["detached"] = True
                elif line.startswith("locked"):
                    cur["locked"] = True
                elif line.startswith("prunable"):
                    cur["prunable"] = True
            if cur["path"] is None:
                continue
            entries.append(WorktreeInfo(
                name=os.path.basename(cur["path"].rstrip(os.sep)),
                path=cur["path"], branch=cur["branch"], head_oid=cur["head"],
                is_main=(len(entries) == 0), is_bare=cur["bare"],
                is_detached=cur["detached"], locked=cur["locked"],
                prunable=cur["prunable"],
            ))
        return entries

    def submodules(self) -> list[SubmoduleInfo]:
        """Lazy submodule enumeration, no dirty scan (reference: mod.rs:983):
        .gitmodules entries + index gitlink pins."""
        if self.workdir is None:
            return []
        gm = os.path.join(self.workdir, ".gitmodules")
        if not os.path.exists(gm):
            return []
        cfg = run_git(self.root, "config", "-f", gm, "--get-regexp",
                      r"^submodule\..*\.(path|url)$", check=False)
        if not cfg.ok:
            return []
        paths: dict[str, str] = {}
        urls: dict[str, str] = {}
        for line in cfg.stdout.splitlines():
            if " " not in line:
                continue
            key, val = line.split(" ", 1)
            m = re.match(r"^submodule\.(.+)\.(path|url)$", key)
            if not m:
                continue
            name, kind = m.group(1), m.group(2)
            (paths if kind == "path" else urls)[name] = val
        # Gitlink pins from the index.
        pins: dict[str, str] = {}
        ls = run_git(self.root, "ls-files", "-s", "-z", check=False)
        if ls.ok:
            for rec in ls.stdout.split("\x00"):
                if rec.startswith("160000 "):
                    meta, path = rec.split("\t", 1)
                    pins[path] = meta.split()[1]
        subs: list[SubmoduleInfo] = []
        for name, path in sorted(paths.items()):
            sub_git = os.path.join(self.workdir, path, ".git")
            initialized = os.path.exists(sub_git)
            workdir_oid = None
            if initialized:
                ho = run_git(os.path.join(self.workdir, path), "rev-parse",
                             "--verify", "-q", "HEAD", check=False)
                if ho.ok:
                    workdir_oid = ho.stdout.strip() or None
            subs.append(SubmoduleInfo(
                name=name, path=path, url=urls.get(name),
                head_oid=pins.get(path), workdir_oid=workdir_oid,
                initialized=initialized,
            ))
        return subs

    def stashes(self) -> list[StashEntry]:
        """reference: refs.rs:288 — `git stash list` with %gd%x00%s%x00%ct
        (the reference also uses the CLI for this)."""
        out = run_git(self.root, "stash", "list", "--format=%gd%x00%s%x00%ct",
                      check=False)
        if not out.ok:
            return []
        entries: list[StashEntry] = []
        for line in out.stdout.splitlines():
            parts = line.split("\x00")
            if len(parts) != 3:
                continue
            ref_name, summary, ts = parts
            m = re.match(r"stash@\{(\d+)\}", ref_name)
            entries.append(StashEntry(
                index=int(m.group(1)) if m else len(entries),
                ref_name=ref_name, summary=summary,
                timestamp=int(ts) if ts.isdigit() else 0,
            ))
        return entries

    def remotes(self) -> list[str]:
        return git_lines(self.root, "remote")

    def remote_url(self, remote: str) -> Optional[str]:
        out = run_git(self.root, "remote", "get-url", remote, check=False)
        return out.stdout.strip() or None if out.ok else None

    # -- commit creation ----------------------------------------------------

    def commit(self, message: str) -> str:
        """Create a commit from the index (reference: mod.rs:954)."""
        run_git(self.root, "commit", "-m", message)
        return self.head_oid() or ""

    def commit_count(self) -> int:
        out = run_git(self.root, "rev-list", "--count", "HEAD", check=False)
        return int(out.stdout.strip()) if out.ok and out.stdout.strip().isdigit() else 0


# ---------------------------------------------------------------------------
# ref_fingerprint — cheap staleness hash (reference: src/git/mod.rs:99-127,
# "~0.5 ms"): hash HEAD + every ref name/target, reading the ref store files
# directly so no subprocess is spawned. The native C++ gitcore accelerates
# this; this is the pure-Python fallback with identical output.
# ---------------------------------------------------------------------------

def _hash_file_into(h, path: str) -> None:
    try:
        with open(path, "rb") as f:
            h.update(path.encode())
            h.update(b"\x00")
            h.update(f.read())
            h.update(b"\x00")
    except OSError:
        pass


def ref_fingerprint(git_dir: str, common_dir: Optional[str] = None) -> str:
    from . import native as _native
    common = common_dir or git_dir
    fp = _native.ref_fingerprint(git_dir, common)
    if fp is not None:
        return fp
    h = hashlib.blake2b(digest_size=16)
    _hash_file_into(h, os.path.join(git_dir, "HEAD"))
    _hash_file_into(h, os.path.join(common, "packed-refs"))
    refs_root = os.path.join(common, "refs")
    files: list[str] = []
    for root, _dirs, names in os.walk(refs_root):
        for n in names:
            files.append(os.path.join(root, n))
    for path in sorted(files):
        _hash_file_into(h, path)
    return h.hexdigest()
