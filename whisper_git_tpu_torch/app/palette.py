"""Command palette: fuzzy command search over the app's action router.

The reference planned this but never shipped it (the feature appears as
"Command Palette | Planned | Fuzzy command search" in the reference's
docs/ux-design-2026-02.md:50); this rebuild implements it on top of the
same string-keyed action routes the rest of the app uses. Ctrl+P (or
Ctrl+K) opens it; typing filters with a subsequence fuzzy matcher;
Enter / click runs the selected command through `handle_action`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

MAX_RESULTS = 10


@dataclass
class PaletteCommand:
    label: str           # what the row shows, e.g. "Checkout: feature/x"
    route: str           # action route run on activation
    hint: str = ""       # dimmed right-aligned detail (shortcut / kind)


@dataclass
class PaletteState:
    query: str = ""
    selected: int = 0
    # Commands are snapshotted when the palette opens so scoring stays
    # stable while the user types (a background refresh mid-keystroke
    # must not reshuffle rows under the cursor).
    commands: List[PaletteCommand] = field(default_factory=list)

    def matches(self) -> List[Tuple[PaletteCommand, List[int]]]:
        return filter_commands(self.commands, self.query)


def fuzzy_score(query: str, target: str) -> Optional[Tuple[float, List[int]]]:
    """Subsequence fuzzy match of `query` against `target`.

    Returns (score, matched character indices) or None when `query` is
    not a subsequence of `target` (case-insensitive). Scoring favors:
    consecutive runs, matches at word starts (after space/:/-//), an
    exact-prefix match, and shorter targets.
    """
    if not query:
        return (0.0, [])
    q = query.lower()
    t = target.lower()
    positions: List[int] = []
    score = 0.0
    ti = 0
    prev = -2
    for qc in q:
        found = t.find(qc, ti)
        if found < 0:
            return None
        positions.append(found)
        if found == prev + 1:
            score += 3.0          # consecutive run
        if found == 0 or (found > 0 and t[found - 1] in " :-/"):
            score += 2.0          # word start
        score += 1.0
        prev = found
        ti = found + 1
    if t.startswith(q):
        score += 4.0
    score -= 0.01 * len(target)   # tie-break: shorter label wins
    return (score, positions)


def filter_commands(commands: List[PaletteCommand], query: str
                    ) -> List[Tuple[PaletteCommand, List[int]]]:
    """Rank `commands` against `query`; empty query keeps registry order."""
    if not query:
        return [(c, []) for c in commands[:MAX_RESULTS]]
    scored = []
    for i, cmd in enumerate(commands):
        hit = fuzzy_score(query, cmd.label)
        if hit is not None:
            scored.append((-hit[0], i, cmd, hit[1]))
    scored.sort(key=lambda s: (s[0], s[1]))
    return [(cmd, pos) for _, _, cmd, pos in scored[:MAX_RESULTS]]


def build_commands(app) -> List[PaletteCommand]:
    """Snapshot the command registry from the live app state.

    Static entries mirror the header/keyboard surface; dynamic entries
    cover checkout / worktree / tab switching so the palette can reach
    anything the sidebar can.
    """
    cmds: List[PaletteCommand] = []
    tab = app.current()

    if tab is not None:
        cmds += [
            PaletteCommand("Fetch", "fetch"),
            PaletteCommand("Pull…", "open-pull-dialog"),
            PaletteCommand("Push", "push"),
            PaletteCommand("Push with Options…", "open-push-dialog"),
            PaletteCommand("Merge…", "open-merge-dialog"),
            PaletteCommand("Rebase…", "open-rebase-dialog"),
            PaletteCommand("Commit", "commit", "Ctrl+Enter"),
            PaletteCommand("Toggle Amend Mode", "toggle-amend",
                           "Ctrl+Shift+A"),
            PaletteCommand("Stash Push", "stash-push", "Ctrl+S"),
            PaletteCommand("Stash Pop", "stash-pop", "Ctrl+Shift+S"),
            PaletteCommand("Stage All", "stage-all"),
            PaletteCommand("Unstage All", "unstage-all"),
            PaletteCommand("Create Branch…", "open-branch-dialog"),
            PaletteCommand("Create Tag…", "open-tag-dialog"),
            PaletteCommand("New Worktree…", "open-worktree-dialog"),
            PaletteCommand("Manage Worktrees…", "open-worktrees-manage"),
            PaletteCommand("Search History", "search-history",
                           "/ or Ctrl+F"),
            PaletteCommand("Generate Commit Message (AI)", "ai-generate"),
            PaletteCommand("Project Rewind…", "open-rewind"),
        ]
        for b in tab.branch_tips:
            if b.is_remote or b.is_head:
                continue
            cmds.append(PaletteCommand(f"Checkout: {b.name}",
                                       f"checkout-branch:{b.name}",
                                       "branch"))
        for w in tab.worktrees:
            cmds.append(PaletteCommand(f"Switch Worktree: {w.name}",
                                       f"select-worktree:{w.path}",
                                       w.branch or "detached"))
        if tab.selected_oid:
            cmds.append(PaletteCommand("Copy Commit SHA",
                                       f"copy-sha:{tab.selected_oid}"))
    for i, t in enumerate(app.tabs):
        if i != app.active_tab:
            cmds.append(PaletteCommand(f"Switch Tab: {t.title}",
                                       f"tab-select:{i}", "tab"))
    cmds += [
        PaletteCommand("Open Repository…", "open-repo-dialog", "Ctrl+O"),
        PaletteCommand("Clone Repository…", "open-clone-dialog"),
        PaletteCommand("Settings…", "open-settings"),
        PaletteCommand("Keyboard Shortcuts…", "open-help"),
        PaletteCommand("Add CI Token…", "open-token-dialog"),
        PaletteCommand("Toggle Shortcut Bar", "toggle-shortcut-bar"),
        PaletteCommand("Toggle Split Diff", "toggle-diff-mode"),
    ]
    if app.tabs:
        cmds.append(PaletteCommand("Close Tab",
                                   f"tab-close:{app.active_tab}", "Ctrl+W"))
    return cmds
