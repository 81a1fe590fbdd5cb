"""App chrome: tab bar (with CI pips), header bar (branch pill, remote-op
buttons with live spinner/elapsed/stall-warning rows, Commit, Settings),
submodule breadcrumb + parent-context strip + sibling strip, and the
context-sensitive shortcut bar.

Capability parity with reference ui_app.rs chrome builders (tab bar
:4811-4911, breadcrumb :5070, parent-context strip :4925-4991, sibling
strip :5004, header + status rows :5103-5316).
"""

from __future__ import annotations

import os

from ...ui import El, column, rect, row, spacer, text
from ...ui.memo import memo_el
from ...ui.theme import DARK as T

STALL_WARN_SECS = 60.0  # reference: ui_app.rs:5103


def tab_bar(app) -> El:
    key = ("tab-bar", app.active_tab,
           tuple((t.title, app.ci_overall_state(t)) for t in app.tabs))
    return memo_el(key, lambda: _tab_bar_impl(app))


def _tab_bar_impl(app) -> El:
    cells: list[El] = []
    for i, tab in enumerate(app.tabs):
        active = i == app.active_tab
        ci_pip = None
        overall = app.ci_overall_state(tab)
        if overall:
            color = {"success": T.success, "failure": T.danger,
                     "pending": T.warning}.get(overall, T.text_muted)
            ci_pip = rect(width=7, height=7, radius=3.5, fill=color)
        inner = [text(tab.title[:18], font_size=T.font_size,
                      color=T.text_bright if active else T.text_muted,
                      bold=active)]
        if ci_pip is not None:
            inner.append(ci_pip)
        inner.append(rect(text("✕", font_size=10, color=T.text_muted),
                          route=f"tab-close:{i}", radius=3,
                          padding=(0, 4, 0, 4),
                          hover_fill=T.surface_hover))
        cells.append(rect(
            row(*inner, gap=6, align="center", height="fill"),
            fill=T.surface if active else None,
            hover_fill=T.surface_hover,
            radius=6, padding=(4, 10, 4, 12), height=30,
            route=f"tab-select:{i}", key=f"tab:{i}"))
    cells.append(rect(text("+", font_size=14, color=T.text_muted),
                      route="open-repo-dialog", radius=6,
                      padding=(2, 8, 2, 8), height=30,
                      hover_fill=T.surface_hover, key="tab-new"))
    cells.append(spacer())
    return rect(row(*cells, gap=4, align="center", width="fill",
                    height="fill", padding=(4, 8, 0, 8)),
                fill=T.surface_raised, width="fill", height=36,
                key="tab-bar")


def _op_button(label: str, route: str, primary: bool = False,
               busy: bool = False) -> El:
    return rect(text("…" if busy else label, font_size=T.font_size,
                     bold=primary,
                     color=T.text_bright if primary else T.text),
                fill=T.accent if primary else T.surface_raised,
                radius=5, padding=(4, 12, 4, 12), height=26,
                hover_fill=None if primary else T.surface_hover,
                route=None if busy else route, key=f"btn:{route}")


def _workdir_counts(tab) -> tuple[int, int, int, int]:
    """(staged, unstaged, untracked, conflicted) of the focused worktree."""
    view = tab.active_view()
    st = view.status if view is not None else None
    if st is None:
        return (0, 0, 0, 0)
    return (len(st.staged), len(st.unstaged), len(st.untracked),
            len(st.conflicted))


def _fetch_age_label(tab) -> str | None:
    """'fetched Nm ago' (None before any fetch) — same formatter as
    commit times (gitcore.types.format_relative_time), fed a wall-clock
    timestamp synthesized from the monotonic stamp."""
    import time as _time

    from ...gitcore.types import format_relative_time

    if not tab.last_fetch_time:
        return None
    secs = _time.monotonic() - tab.last_fetch_time
    return "fetched " + format_relative_time(int(_time.time() - secs))


def header_bar(app, tab) -> El:
    local = next((t for t in tab.branch_tips
                  if not t.is_remote and t.is_head), None)
    pr = tab.pr_by_branch.get(tab.current_branch or "")
    counts = _workdir_counts(tab)
    # While dirty, the pulse dot's opacity must track wall clock: key the
    # memo on a quantized phase so the header El rebuilds at animation
    # cadence (cheap — ~30 elements) while everything below it (layout,
    # scene, compose chrome) still caches; the dot itself is volatile.
    phase = None
    if counts[0] or counts[1] or counts[2]:
        from .widgets import pulse_alpha

        phase = round(pulse_alpha(counts[0] + counts[1] + counts[2]), 2)
    key = ("header", tab.tab_id, tab.current_branch, tab.head_oid,
           tab.repo_state,
           (local.ahead, local.behind) if local is not None else None,
           (pr.number, pr.draft) if pr is not None else None,
           counts, phase, _fetch_age_label(tab),
           tuple((name, op.label, int(op.elapsed()))
                 for name, op in tab.busy_slots()))
    return memo_el(key, lambda: _header_bar_impl(app, tab))


def _header_bar_impl(app, tab) -> El:
    branch = tab.current_branch or (
        f"detached @ {tab.head_oid[:8]}" if tab.head_oid else "no branch")
    cells: list[El] = [
        rect(row(text("", font_size=11), text(branch, font_size=T.font_size,
                                              bold=True, color=T.text_bright),
                 gap=4, align="center"),
             fill=T.surface_hover, radius=T.radius_pill,
             padding=(3, 10, 3, 10), key="branch-pill"),
    ]
    pr = tab.pr_by_branch.get(tab.current_branch or "")
    if pr is not None:
        # Current branch's open PR, clickable → browser (beyond-reference:
        # PR integration is Deferred in the reference's user_needs.md).
        label = f"{'Draft ' if pr.draft else ''}PR #{pr.number} ↗"
        cells.append(rect(text(label, font_size=11, bold=True,
                               color=T.text_bright),
                          fill=(T.info[0], T.info[1], T.info[2], 0.35),
                          radius=T.radius_pill, padding=(3, 8, 3, 8),
                          route=f"open-url:{pr.url}",
                          hover_fill=T.surface_hover, key="pr-pill"))
    if tab.repo_state:
        # Clickable: Continue/Abort menu for the in-progress operation
        # (beyond-reference — the reference pill is inert).
        cells.append(rect(text(tab.repo_state + " ▾", font_size=11,
                               bold=True, color=T.text_bright),
                          fill=T.warning, radius=T.radius_pill,
                          padding=(3, 8, 3, 8), route="menu-repo-state",
                          hover_fill=T.surface_hover,
                          key="repo-state-pill"))
    # Working-directory summary + last-fetch age: the reference's design
    # review calls the header "80% empty gray space — should show tracking
    # status, last fetch time, working directory summary"
    # (design_feedback_feb2026.md:67). Tracking status already rides the
    # Pull (−N) / Push (+N) buttons; these chips add the other two.
    staged, unstaged, untracked, conflicted = _workdir_counts(tab)
    if conflicted:
        cells.append(rect(
            text(f"⚠ {conflicted} conflict{'s' if conflicted > 1 else ''}",
                 font_size=11, bold=True, color=T.text_bright),
            fill=(T.danger[0], T.danger[1], T.danger[2], 0.45),
            radius=T.radius_pill, padding=(3, 8, 3, 8),
            route="focus-staging", hover_fill=T.surface_hover,
            key="conflict-chip"))
    if staged or unstaged or untracked:
        parts = []
        if staged:
            parts.append(f"{staged} staged")
        if unstaged:
            parts.append(f"{unstaged} modified")
        if untracked:
            parts.append(f"{untracked} untracked")
        n_dirty = staged + unstaged + untracked
        from .widgets import pulse_alpha

        # "The Pulse" (design_feedback_feb2026.md:339): the dirty dot
        # breathes, faster with more dirty files, shifting to orange when
        # urgent. volatile=True keeps it on the per-frame dynamic tail so
        # the chrome compose caches stay warm while it animates.
        pc = T.warning if n_dirty > 20 else (0.92, 0.75, 0.25, 1.0)
        dot = rect(width=7, height=7, radius=3.5,
                   fill=(pc[0], pc[1], pc[2], pulse_alpha(n_dirty)),
                   volatile=True)
        cells.append(rect(row(dot,
                              text(" · ".join(parts), font_size=11,
                                   color=T.text_muted),
                              gap=6, align="center"),
                          radius=T.radius_pill, padding=(3, 8, 3, 8),
                          route="focus-staging",
                          hover_fill=T.surface_hover, key="workdir-chip"))
    age = _fetch_age_label(tab)
    if age is not None:
        cells.append(text(age, font_size=11, color=T.text_muted,
                          key="fetch-age"))
    cells.append(spacer())

    local = next((t for t in tab.branch_tips
                  if not t.is_remote and t.is_head), None)
    pull_label = "Pull"
    push_label = "Push"
    if local is not None:
        if local.behind:
            pull_label = f"Pull (−{local.behind})"
        if local.ahead:
            push_label = f"Push (+{local.ahead})"
    cells.append(_op_button("Fetch", "fetch", busy=tab.fetch_op is not None))
    cells.append(_op_button(pull_label, "open-pull-dialog",
                            busy=tab.pull_op is not None))
    cells.append(_op_button(push_label, "push",
                            busy=tab.push_op is not None))
    cells.append(_op_button("Commit", "focus-staging-commit", primary=True))
    cells.append(_op_button("?", "open-help"))
    cells.append(_op_button("⚙", "open-settings"))
    header = rect(row(*cells, gap=8, align="center", width="fill",
                      height="fill", padding=(0, 10, 0, 10)),
                  fill=T.surface_raised, width="fill", height=40,
                  shadow=True, key="header")

    # Per-op spinner rows with elapsed time + 60 s stall warning
    # (reference: status_row, ui_app.rs:5294).
    status_rows: list[El] = []
    for name, op in tab.busy_slots():
        secs = int(op.elapsed())
        stalled = op.elapsed() > STALL_WARN_SECS
        label = f"⟳ {op.label} · {secs}s"
        if stalled:
            label += " (still running)"
        status_rows.append(rect(
            text(label, font_size=11,
                 color=T.danger if stalled else T.text_muted),
            width="fill", height=20, padding=(2, 12, 2, 12),
            fill=(0.94, 0.27, 0.27, 0.08) if stalled else T.surface,
            key=f"op-status:{name}"))
    if not status_rows:
        return header
    return column(header, *status_rows, width="fill")


def breadcrumb(app, tab) -> El | None:
    """Submodule drill-down breadcrumb + parent pin-drift badge + sibling
    strip (reference: ui_app.rs:4925-5070)."""
    if not tab.nav_stack:
        return None
    key = ("breadcrumb", tab.tab_id, tab.title, tab.pinned_oid,
           tab.head_oid, tab.pinned_path,
           tuple(a.title for a in tab.nav_stack),
           tuple((s.name, s.path) for s in tab.nav_stack[-1].submodules[:6]))
    return memo_el(key, lambda: _breadcrumb_impl(app, tab))


def _breadcrumb_impl(app, tab) -> El:
    crumbs: list[El] = []
    for depth, ancestor in enumerate(tab.nav_stack):
        crumbs.append(rect(
            text(ancestor.title, font_size=11, color=T.accent),
            route=f"exit-to-depth:{depth}", radius=3,
            padding=(1, 5, 1, 5), hover_fill=T.surface_hover))
        crumbs.append(text("›", font_size=11, color=T.text_muted))
    crumbs.append(text(tab.title, font_size=11, bold=True, color=T.text))

    # Pin-drift badge: the parent pins this submodule at pinned_oid; if our
    # HEAD differs, surface the drift.
    if tab.pinned_oid and tab.head_oid and tab.pinned_oid != tab.head_oid:
        crumbs.append(rect(
            text(f"drifted from pin {tab.pinned_oid[:8]}", font_size=10,
                 bold=True, color=T.text_bright),
            fill=T.warning, radius=T.radius_pill, padding=(1, 7, 1, 7)))
    crumbs.append(spacer())

    # Sibling-submodule quick switch strip.
    parent = tab.nav_stack[-1]
    for sub in parent.submodules[:6]:
        active = sub.path == tab.pinned_path
        crumbs.append(rect(
            text(sub.name[:14], font_size=10,
                 color=T.text_bright if active else T.text_muted,
                 bold=active),
            fill=T.surface_hover if active else None,
            hover_fill=T.surface_hover, radius=T.radius_pill,
            padding=(1, 7, 1, 7),
            route=None if active else f"switch-sibling:{sub.path}"))
    return rect(row(*crumbs, gap=6, align="center", width="fill",
                    height="fill", padding=(0, 10, 0, 10)),
                fill=T.surface, width="fill", height=26, key="breadcrumb")


_SHORTCUTS = {
    "graph": [("j/k", "navigate"), ("Enter", "select"), ("/", "search"),
              ("Tab", "cycle focus")],
    "sidebar": [("j/k", "navigate"), ("Enter", "checkout"), ("d", "delete"),
                ("Tab", "cycle focus")],
    "staging": [("Tab", "next field"), ("Ctrl+Enter", "commit"),
                ("Ctrl+Shift+A", "amend"), ("Ctrl+S", "stash")],
}


def shortcut_bar(focus: str) -> El:
    return memo_el(("shortcut-bar", focus), lambda: _shortcut_bar_impl(focus))


def _shortcut_bar_impl(focus: str) -> El:
    pills: list[El] = []
    for key, label in _SHORTCUTS.get(focus, _SHORTCUTS["graph"]):
        pills.append(row(
            rect(text(key, font_size=10, color=T.text), fill=T.surface_hover,
                 radius=3, padding=(0, 5, 0, 5)),
            text(label, font_size=10, color=T.text_muted),
            gap=4, align="center"))
    return rect(row(*pills, gap=14, align="center", width="fill",
                    height="fill", padding=(0, 12, 0, 12)),
                fill=T.surface, width="fill", height=22, key="shortcut-bar")
