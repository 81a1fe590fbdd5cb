"""Project Rewind: a silent timeline of repository state snapshots.

The reference's design review calls this "The 10x Feature"
(reference: docs/design_feedback_feb2026.md:368-414) but never built
it: capture working-directory status, branch positions, stash contents,
and index state on a cadence; let the user scrub through time to see past
states and get back to one. Per its implementation notes, snapshots store
STATE (paths + positions), never file contents, and "Restore" generates
git commands rather than mutating anything silently.

Adaptations to this codebase (honest deltas):
- storage is JSON-lines under $XDG_STATE_HOME/whisper-git/rewind/ (one
  file per repo identity) instead of SQLite — same durability, no
  dependency, trivially greppable;
- snapshots are taken from the app's already-refreshed in-memory state on
  the existing 30 s safety-net cadence (zero extra git work) and
  immediately after each completed async op, labeled by it ("after pull");
- deduplication by content fingerprint: an idle repo appends nothing.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

MAX_SNAPSHOTS = 480          # ≈ 4 h at the 30 s cadence
CADENCE_SECS = 30.0          # reference spec: "every 30 seconds"


@dataclass(frozen=True)
class RewindSnapshot:
    ts: float                              # wall-clock seconds
    head_oid: str
    branch: str
    branch_tips: tuple = ()                # ((name, oid), ...) local only
    stashes: tuple = ()                    # (message, ...)
    staged: tuple = ()                     # paths
    unstaged: tuple = ()
    untracked: tuple = ()
    conflicted: tuple = ()
    label: str = ""                        # "after pull", "" for cadence
    # Per-worktree dirty summary — the spec's mockup lists every working
    # tree's state per timeline entry ("main-app/ dirty(2)", :390-394).
    worktree_state: tuple = ()             # ((name, n_dirty), ...)

    def fingerprint(self) -> tuple:
        """Identity of the STATE (not the time or label): two snapshots
        with equal fingerprints describe the same repository situation."""
        return (self.head_oid, self.branch, self.branch_tips, self.stashes,
                self.staged, self.unstaged, self.untracked, self.conflicted,
                self.worktree_state)

    def dirty_summary(self) -> str:
        parts = []
        if self.staged:
            parts.append(f"{len(self.staged)} staged")
        if self.unstaged:
            parts.append(f"{len(self.unstaged)} modified")
        if self.untracked:
            parts.append(f"{len(self.untracked)} untracked")
        if self.conflicted:
            parts.append(f"{len(self.conflicted)} conflicted")
        return " · ".join(parts) if parts else "clean"


def snapshot_of_tab(tab, label: str = "") -> RewindSnapshot | None:
    """Build a snapshot from a RepoTab's in-memory state (None until the
    first refresh has populated it)."""
    if not tab.initial_refresh_done:
        return None
    view = tab.active_view()
    st = view.status if view is not None else None
    wt_state = []
    if len(tab.worktrees) > 1:
        for w in tab.worktrees:
            v = tab.worktree_views.get(w.path)
            wst = v.status if v is not None else None
            n = (len(wst.staged) + len(wst.unstaged) + len(wst.untracked)
                 + len(wst.conflicted)) if wst is not None else 0
            wt_state.append((w.name, n))
    return RewindSnapshot(
        ts=time.time(),
        head_oid=tab.head_oid or "",
        branch=tab.current_branch or "",
        branch_tips=tuple(sorted((t.name, t.oid) for t in tab.branch_tips
                                 if not t.is_remote)),
        stashes=tuple(s.summary for s in tab.stashes),
        # PATH strings, not StatusEntry objects: entries don't sort
        # (TypeError at 2+ items) and don't JSON-serialize — either
        # silently broke persistence of dirty-tree snapshots.
        staged=tuple(sorted(e.path for e in st.staged)) if st else (),
        unstaged=tuple(sorted(e.path for e in st.unstaged)) if st else (),
        untracked=tuple(sorted(e.path for e in st.untracked))
        if st else (),
        conflicted=tuple(sorted(e.path for e in st.conflicted))
        if st else (),
        label=label,
        worktree_state=tuple(sorted(wt_state)),
    )


class RewindLog:
    """Append-only, capped JSONL log of snapshots for ONE repository."""

    def __init__(self, repo_key: str, root: str | None = None):
        if root is None:
            base = os.environ.get(
                "XDG_STATE_HOME", os.path.expanduser("~/.local/state"))
            root = os.path.join(base, "whisper-git", "rewind")
        # Tail-truncated slug + a hash of the FULL key: two repos whose
        # sanitized paths share an 80-char tail must not interleave
        # timelines in one file.
        import hashlib
        safe = "".join(c if c.isalnum() else "_" for c in repo_key)[-80:]
        digest = hashlib.sha1(repo_key.encode()).hexdigest()[:8]
        self.path = os.path.join(root, f"{safe}-{digest}.jsonl")
        # Migration: adopt a pre-digest timeline rather than orphaning
        # months of snapshots on upgrade (collision risk only existed
        # between different repos, so a same-slug file is this repo's).
        legacy = os.path.join(root, f"{safe}.jsonl")
        if not os.path.exists(self.path) and os.path.exists(legacy):
            try:
                os.replace(legacy, self.path)
            except OSError:
                pass
        self._snaps: list[RewindSnapshot] = self._load()

    # -- persistence -----------------------------------------------------

    def _load(self) -> list[RewindSnapshot]:
        out: list[RewindSnapshot] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    try:
                        d = json.loads(line)
                        d = {k: (tuple(tuple(x) if isinstance(x, list)
                                       else x for x in v)
                                 if isinstance(v, list) else v)
                             for k, v in d.items()}
                        out.append(RewindSnapshot(**d))
                    except (ValueError, TypeError):
                        continue  # one corrupt line never loses the log
        except OSError:
            pass
        return out[-MAX_SNAPSHOTS:]

    def _rewrite(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for s in self._snaps:
                f.write(json.dumps(s.__dict__) + "\n")
        os.replace(tmp, self.path)

    # -- API -------------------------------------------------------------

    @property
    def snapshots(self) -> list[RewindSnapshot]:
        return self._snaps

    def record(self, snap: RewindSnapshot) -> bool:
        """Append unless the state is unchanged (an idle repo appends
        nothing); a labeled snapshot upgrades an unlabeled duplicate.
        Returns True when the log changed."""
        if self._snaps:
            last = self._snaps[-1]
            if last.fingerprint() == snap.fingerprint():
                if snap.label and not last.label:
                    self._snaps[-1] = RewindSnapshot(
                        **{**last.__dict__, "label": snap.label})
                    self._rewrite()
                    return True
                return False
        self._snaps.append(snap)
        if len(self._snaps) > MAX_SNAPSHOTS:
            self._snaps = self._snaps[-MAX_SNAPSHOTS:]
            self._rewrite()
        else:
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(snap.__dict__) + "\n")
            except OSError:
                pass  # snapshotting must never break the app
        return True


def diff_to_now(past: RewindSnapshot, now: RewindSnapshot) -> list[str]:
    """Human-readable 'what changed since then' lines ("View Diff to
    Now" panel in the spec's mockup)."""
    lines: list[str] = []
    if past.branch != now.branch:
        lines.append(f"branch: {past.branch or '(detached)'} → "
                     f"{now.branch or '(detached)'}")
    if past.head_oid != now.head_oid:
        lines.append(f"HEAD: {past.head_oid[:8]} → {now.head_oid[:8]}")
    p_tips, n_tips = dict(past.branch_tips), dict(now.branch_tips)
    for name in sorted(set(p_tips) | set(n_tips)):
        a, b = p_tips.get(name), n_tips.get(name)
        if a == b:
            continue
        if a is None:
            lines.append(f"branch {name}: created @ {b[:8]}")
        elif b is None:
            lines.append(f"branch {name}: deleted (was {a[:8]})")
        else:
            lines.append(f"branch {name}: {a[:8]} → {b[:8]}")
    if past.stashes != now.stashes:
        lines.append(f"stashes: {len(past.stashes)} → {len(now.stashes)}")
    for kind in ("staged", "unstaged", "untracked", "conflicted"):
        a, b = set(getattr(past, kind)), set(getattr(now, kind))
        gone, new = sorted(a - b), sorted(b - a)
        if gone:
            lines.append(f"{kind} then, not now: " + ", ".join(gone[:4])
                         + ("…" if len(gone) > 4 else ""))
        if new:
            lines.append(f"{kind} now, not then: " + ", ".join(new[:4])
                         + ("…" if len(new) > 4 else ""))
    return lines or ["no differences — this is the current state"]


def restore_commands(past: RewindSnapshot, now: RewindSnapshot) -> list[str]:
    """Generate the git commands that get back to the snapshot's POSITIONS
    (branch + HEAD); per the spec's implementation notes, Rewind stores no
    file contents, so dirty working-tree files are surfaced as comments
    rather than silently discarded."""
    cmds: list[str] = []
    n_tips = dict(now.branch_tips)
    if past.branch and past.branch not in n_tips:
        # The branch was deleted since the snapshot: recreate it at the
        # snapshot commit (a plain `git checkout` would fail).
        cmds.append(f"git checkout -b {past.branch} {past.head_oid[:12]}"
                    "  # branch was deleted since")
    elif past.branch:
        if past.branch != now.branch:
            cmds.append(f"git checkout {past.branch}")
        if n_tips.get(past.branch, past.head_oid) != past.head_oid:
            cmds.append(f"git reset --soft {past.head_oid[:12]}"
                        f"  # move {past.branch} back (keeps files)")
    elif past.head_oid and past.head_oid != now.head_oid:
        cmds.append(f"git checkout --detach {past.head_oid[:12]}")
    then_dirty = set(past.staged) | set(past.unstaged) | set(past.untracked)
    now_dirty = set(now.staged) | set(now.unstaged) | set(now.untracked)
    lost = sorted(then_dirty - now_dirty)
    if lost:
        cmds.append("# dirty then but not now (contents not snapshotted): "
                    + ", ".join(lost[:6]) + ("…" if len(lost) > 6 else ""))
    if not cmds:
        cmds.append("# already at this state")
    return cmds


@dataclass
class RewindState:
    """Modal state: the loaded timeline + scrub position."""
    snapshots: list = field(default_factory=list)
    index: int = 0            # selected snapshot (len(snapshots)-1 = NOW)
    show_commands: bool = False
