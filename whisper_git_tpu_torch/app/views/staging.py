"""Staging well: commit subject/body editors, staged/unstaged/untracked/
conflicted lists, stage/unstage/discard affordances, AI generate button,
amend mode, and the worktree selector (pill bar ≤4 worktrees, else
dropdown picker).

Capability parity with reference src/staging.rs (WORKTREE_PILL_LIMIT :24,
worktree_selector :45, worktree_picker_overlay :91) and the README staging
feature list (72-char subject limit, Ctrl+Enter commit, amend pre-fill).
"""

from __future__ import annotations

import os

from ...gitcore.types import FileStatus, StatusEntry
from ...ui import El, column, insert_caret, rect, row, spacer, text
from ...ui.memo import memo_el
from ...ui.theme import DARK as T

WORKTREE_PILL_LIMIT = 4  # reference: staging.rs:24
SUBJECT_LIMIT = 72

_STATUS_DOTS = {
    FileStatus.ADDED: T.success,
    FileStatus.MODIFIED: T.warning,
    FileStatus.DELETED: T.danger,
    FileStatus.RENAMED: T.info,
    FileStatus.TYPECHANGE: T.info,
    FileStatus.UNTRACKED: T.text_muted,
    FileStatus.CONFLICTED: T.danger,
}


def worktree_selector(tab, picker_open: bool = False) -> El | None:
    """Pill bar for ≤4 worktrees, dropdown trigger beyond
    (reference: staging.rs:45)."""
    if len(tab.worktrees) <= 1:
        return None
    if len(tab.worktrees) <= WORKTREE_PILL_LIMIT:
        pills = []
        for wt in tab.worktrees:
            active = wt.path == tab.active_worktree
            view = tab.worktree_views.get(wt.path)
            label = wt.name
            pills.append(rect(
                row(text(label[:14], font_size=11,
                         color=T.text_bright if active else T.text_muted,
                         bold=active),
                    *((rect(width=6, height=6, radius=3, fill=T.warning),)
                      if view and view.dirty else ()),
                    gap=4, align="center"),
                fill=T.accent if active else T.surface_raised,
                radius=T.radius_pill, padding=(3, 8, 3, 8),
                route=f"select-worktree:{wt.path}",
                key=f"wt-pill:{wt.path}"))
        return row(*pills, gap=4, width="fill", key="worktree-pills")
    active_name = os.path.basename((tab.active_worktree or "?").rstrip(os.sep))
    return rect(
        row(text(f"Worktree: {active_name} ▾", font_size=11, color=T.text)),
        fill=T.surface_raised, radius=4, padding=(3, 8, 3, 8),
        route="open-worktree-picker", key="worktree-dropdown")


def worktree_picker_overlay(tab) -> El:
    """Dropdown picker (reference: staging.rs:91)."""
    rows = []
    for wt in tab.worktrees:
        view = tab.worktree_views.get(wt.path)
        rows.append(rect(
            row(text(wt.name, color=T.text),
                *((rect(width=6, height=6, radius=3, fill=T.warning),)
                  if view and view.dirty else ()),
                spacer(),
                text(wt.branch or "detached", font_size=10,
                     color=T.text_muted),
                gap=6, align="center", width="fill"),
            width="fill", height=26, padding=(2, 8, 2, 8), radius=4,
            hover_fill=T.surface_hover,
            route=f"pick-worktree:{wt.path}", key=f"wt-pick:{wt.path}"))
    return rect(column(*rows, gap=2, width=260, padding=(6, 6, 6, 6)),
                fill=T.surface_raised, border=T.border_light, border_width=1,
                radius=8, shadow=True, key="worktree-picker")


def _cursor_visible() -> bool:
    """~1 Hz cursor blink (reference: continuous redraw drives blink; our
    frame loop ticks often enough while focused)."""
    from .widgets import cursor_visible

    return cursor_visible()


def _input(value: str, placeholder: str, key: str, focused: bool,
           multiline: bool = False, over_limit: bool = False,
           cursor=None, anchor=None) -> El:
    caret_on = focused and _cursor_visible()
    color = T.danger if over_limit else (T.text if value else T.text_muted)
    if value and not multiline:
        from .widgets import input_text_el

        content = input_text_el(value, cursor, anchor if focused else None,
                                caret_on, color, T.font_size)
    else:
        if value:
            shown = insert_caret(value, cursor) if caret_on else value
        else:
            shown = placeholder + ("▏" if caret_on else "")
        content = text(shown, color=color,
                       font_size=T.font_size, wrap=multiline)
    return rect(content, fill=T.background,
                border=T.accent if focused else T.border, border_width=1,
                radius=4, padding=(5, 8, 5, 8), width="fill",
                height=56 if multiline else 26,
                route=f"focus-input:{key}", key=f"input:{key}", clip=True)


def _file_row(entry: StatusEntry, bucket: str, selected: bool,
              row_h: float = 22.0) -> El:
    dot = _STATUS_DOTS.get(entry.status, T.text_muted)
    return rect(
        row(rect(width=7, height=7, radius=3.5, fill=dot),
            text(entry.path[-44:], font_size=T.font_size_small, color=T.text),
            spacer(), gap=6, align="center", width="fill", height="fill"),
        width="fill", height=row_h, radius=3, padding=(1, 6, 1, 6),
        fill=T.surface_hover if selected else None,
        hover_fill=T.surface_hover,
        route=f"view-file:{bucket}:{entry.path}",
        route_right=f"menu-file:{bucket}:{entry.path}",
        route_double=f"toggle-stage:{bucket}:{entry.path}",
        key=f"file:{bucket}:{entry.path}")


def _file_section(title: str, entries: list, bucket: str,
                  selected_file, action_label: str, action_route: str,
                  focused: bool = False, row_scale: float = 1.0) -> list[El]:
    if not entries:
        return []
    header = rect(
        row(text(title, font_size=10, bold=True,
                 color=T.accent if focused else T.text_muted),
            rect(text(str(len(entries)), font_size=9, color=T.text_muted),
                 fill=(1, 1, 1, 0.08), radius=6, padding=(0, 4, 0, 4)),
            spacer(),
            rect(text(action_label, font_size=10, color=T.accent),
                 route=action_route, radius=3, padding=(0, 4, 0, 4),
                 hover_fill=T.surface_hover),
            gap=6, align="center", width="fill"),
        width="fill", height=20, padding=(1, 4, 1, 4))
    rows = [header]
    for e in entries[:200]:
        rows.append(_file_row(e, bucket, selected_file == (bucket, e.path),
                              row_h=22.0 * row_scale))
    return rows


def _selected_tuple(view, status):
    """(bucket, path) of the selected file, with the REAL bucket — the
    view model only stores a staged/unstaged bool, so untracked and
    conflicted selections used to compare against the wrong bucket name
    and never rendered the highlight (worst exactly in the
    merge-conflict flow)."""
    if not (view and view.selected_file):
        return None
    p = view.selected_file
    if view.selected_staged:
        return ("staged", p)
    if status is not None:
        for bucket, entries in (("conflicted", status.conflicted),
                                ("unstaged", status.unstaged),
                                ("untracked", status.untracked)):
            if any(e.path == p for e in entries):
                return (bucket, p)
    return ("unstaged", p)


def _staging_key(tab, focused_input: str, ai_busy: bool,
                 cursor=None, anchor=None) -> tuple:
    """Every pixel-affecting input of the staging panel. The cursor-blink
    phase enters only while an editor is focused, so steady-state frames
    alternate between two cached variants (~1 Hz)."""
    view = tab.active_view()
    status = view.status if view else None

    def bucket(entries):
        # len() included: the key truncates at 200 entries, but badges
        # render len(entries) — a change past the 200th file must still
        # invalidate the memo.
        return (len(entries),) + tuple(
            (e.path, e.status) for e in entries[:200])

    return (
        "staging", tab.tab_id,
        view.draft_subject if view else "",
        view.draft_body if view else "",
        bool(view and view.amend_mode),
        focused_input if focused_input in ("subject", "body",
                                           "staged-list",
                                           "unstaged-list") else "",
        (_cursor_visible(), cursor, anchor)
        if focused_input in ("subject", "body") else (True, None, None),
        ai_busy,
        (bucket(status.staged), bucket(status.unstaged),
         bucket(status.untracked), bucket(status.conflicted))
        if status is not None else None,
        _selected_tuple(view, status),
        tuple((w.name, w.path, w.branch,
               bool(tab.worktree_views.get(w.path)
                    and tab.worktree_views[w.path].dirty))
              for w in tab.worktrees),
        tab.active_worktree, getattr(tab, "row_scale", 1.0),
    )


def staging_well(tab, focused_input: str = "", ai_busy: bool = False,
                 cursor=None, anchor=None) -> El:
    """reference: staging.rs — the full staging pane. Memoized (ui.memo)."""
    return memo_el(_staging_key(tab, focused_input, ai_busy, cursor, anchor),
                   lambda: _staging_impl(tab, focused_input, ai_busy, cursor,
                                         anchor))


def _staging_impl(tab, focused_input: str = "", ai_busy: bool = False,
                  cursor=None, anchor=None) -> El:
    view = tab.active_view()
    parts: list[El] = []

    selector = worktree_selector(tab)
    if selector is not None:
        parts.append(selector)

    subject = view.draft_subject if view else ""
    body = view.draft_body if view else ""
    amend = bool(view and view.amend_mode)

    header_row = [text("COMMIT" + (" (amend)" if amend else ""),
                       font_size=10, bold=True, color=T.text_muted),
                  spacer()]
    header_row.append(rect(
        text("✓ AI" if not ai_busy else "…", font_size=10, color=T.accent),
        route="ai-generate", radius=3, padding=(1, 6, 1, 6),
        hover_fill=T.surface_hover, key="ai-generate"))
    parts.append(row(*header_row, align="center", width="fill"))

    parts.append(_input(subject, "Commit subject", "subject",
                        focused_input == "subject",
                        over_limit=len(subject) > SUBJECT_LIMIT,
                        cursor=cursor, anchor=anchor))
    if len(subject) > SUBJECT_LIMIT:
        parts.append(text(f"{len(subject)}/{SUBJECT_LIMIT}", font_size=9,
                          color=T.danger))
    parts.append(_input(body, "Description (optional)", "body",
                        focused_input == "body", multiline=True,
                        cursor=cursor))

    can_commit = bool(view and view.status and view.status.staged) or amend
    parts.append(rect(
        text("Amend" if amend else "Commit", font_size=T.font_size,
             bold=True,
             color=T.text_bright if can_commit else T.text_muted),
        fill=T.accent if can_commit else T.surface_raised,
        radius=5, height=28, width="fill", align="center",
        route="commit" if can_commit else None, key="commit-button"))

    status = view.status if view else None
    selected = _selected_tuple(view, view.status if view else None)
    if status is not None:
        rs = getattr(tab, "row_scale", 1.0)
        file_rows: list[El] = []
        file_rows += _file_section("STAGED", status.staged, "staged",
                                   selected, "Unstage all", "unstage-all",
                                   focused=focused_input == "staged-list",
                                   row_scale=rs)
        file_rows += _file_section("CONFLICTS", status.conflicted,
                                   "conflicted", selected, "", "noop",
                                   row_scale=rs)
        file_rows += _file_section("UNSTAGED", status.unstaged, "unstaged",
                                   selected, "Stage all", "stage-all",
                                   focused=focused_input == "unstaged-list",
                                   row_scale=rs)
        file_rows += _file_section("UNTRACKED", status.untracked, "untracked",
                                   selected, "Stage all", "stage-all",
                                   focused=focused_input == "unstaged-list",
                                   row_scale=rs)
        if not file_rows:
            file_rows = [rect(
                row(text("✓", color=T.success, font_size=14),
                    text("Working tree clean", color=T.text_muted),
                    gap=6, align="center"),
                width="fill", height=40, align="center")]
        parts.append(column(*file_rows, gap=1, width="fill", flex=1,
                            clip=True))
    else:
        parts.append(rect(text("Loading status…", color=T.text_muted),
                          width="fill", flex=1, align="center"))

    return rect(column(*parts, gap=6, width="fill", height="fill",
                       padding=(8, 8, 8, 8)),
                fill=T.surface, width="fill", height="fill", clip=True,
                key="staging", route="focus-staging")
