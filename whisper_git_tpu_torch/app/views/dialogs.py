"""Modal dialogs: Settings, OpenRepo, Confirm, Error, Clone, Token (GitHub
+ per-host GitLab), Branch, Tag, PullPicker, PushPicker, MergeOptions,
RebaseOptions, Worktree create, Worktrees manage.

Capability parity with reference src/dialogs.rs:14-27 (the 14 modal keys)
and its form structs (CloneForm/TokenForm/BranchForm/TagForm/PullForm/
PushForm/MergeForm+MergeStrategy/RebaseForm/WorktreeForm).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ...ui import El, column, insert_caret, rect, row, spacer, text
from ...ui.theme import DARK as T


# -- form state --------------------------------------------------------------

@dataclass
class CloneForm:
    url: str = ""
    dest: str = ""
    focused: str = "url"


@dataclass
class TokenForm:
    provider: str = "github"   # github | gitlab
    host: str = ""             # for self-hosted gitlab
    token: str = ""
    focused: str = "token"
    editing: bool = False


@dataclass
class BranchForm:
    name: str = ""
    at_oid: Optional[str] = None


@dataclass
class TagForm:
    name: str = ""
    message: str = ""
    at_oid: Optional[str] = None
    focused: str = "name"


@dataclass
class PullForm:
    rebase: bool = False


@dataclass
class PushForm:
    remote: str = "origin"
    force_with_lease: bool = False
    set_upstream: bool = False
    push_tags: bool = False


@dataclass
class MergeForm:
    branch: str = ""
    strategy: str = "default"  # default | no-ff | ff-only | squash


@dataclass
class RebaseForm:
    onto: str = ""
    autostash: bool = True
    rebase_merges: bool = False


@dataclass
class WorktreeForm:
    path: str = ""
    branch: str = ""
    base: str = ""
    focused: str = "branch"


@dataclass
class OpenRepoForm:
    path: str = ""


@dataclass
class ConfirmState:
    action: str               # the ConfirmAction key
    title: str
    message: str
    confirm_label: str = "Confirm"
    destructive: bool = True
    payload: dict = field(default_factory=dict)


@dataclass
class ErrorState:
    title: str
    message: str


# -- building blocks ---------------------------------------------------------

def _modal_frame(title: str, body: list[El], width: float = 420,
                 key: str = "modal") -> El:
    header = row(text(title, font_size=T.font_size_large, bold=True,
                      color=T.text_bright),
                 spacer(),
                 rect(text("✕", color=T.text_muted),
                      route="close-modal", radius=3, padding=(0, 6, 0, 6),
                      hover_fill=T.surface_hover),
                 align="center", width="fill")
    # The card must ABSORB every pointer gesture — hit-testing returns
    # the topmost node carrying the looked-up attribute, and each
    # gesture (click, double, right, drag) is looked up independently:
    # without all four, a click on the dialog's message text falls
    # through to the scrim's close-modal, and a double/right/drag on
    # the card reaches staging rows / commit menus / scrollbars BEHIND
    # the open modal.
    card = rect(column(header, *body, gap=10, width="fill",
                       padding=(14, 16, 14, 16)),
                fill=T.surface_raised, border=T.border_light, border_width=1,
                radius=10, width=width, shadow=True, key=key,
                route="noop", route_double="noop", route_right="noop",
                route_drag="noop")
    return rect(card, width="fill", height="fill", align="center",
                fill=(0, 0, 0, 0.45), route="close-modal",
                key="modal-scrim")


def _field(label: str, value: str, input_key: str, focused: str,
           placeholder: str = "", secret: bool = False,
           cursor=None) -> El:
    shown = ("•" * len(value)) if (secret and value) else value
    is_focused = focused == input_key
    if is_focused:
        shown = insert_caret(shown, cursor) if value else placeholder + "▏"
    else:
        shown = shown or placeholder
    return column(
        text(label, font_size=10, bold=True, color=T.text_muted),
        rect(text(shown,
                  color=T.text if value else T.text_muted,
                  font_size=T.font_size),
             fill=T.background, radius=4, padding=(5, 8, 5, 8),
             border=T.accent if is_focused else T.border, border_width=1,
             width="fill", height=27, clip=True,
             route=f"focus-input:{input_key}"),
        gap=3, width="fill")


def _buttons(confirm_label: str, confirm_route: str,
             destructive: bool = False, enabled: bool = True) -> El:
    return row(
        spacer(),
        rect(text("Cancel", color=T.text), fill=T.surface_hover, radius=5,
             padding=(5, 12, 5, 12), route="close-modal"),
        rect(text(confirm_label, bold=True,
                  color=T.text_bright if enabled else T.text_muted),
             fill=(T.danger if destructive else T.accent) if enabled
             else T.surface_raised,
             radius=5, padding=(5, 12, 5, 12),
             route=confirm_route if enabled else None,
             key="modal-confirm"),
        gap=8, width="fill")


def _checkbox(label: str, checked: bool, route: str) -> El:
    box = rect(text("✓" if checked else "", font_size=10, bold=True,
                    color=T.text_bright),
               width=16, height=16, radius=3,
               fill=T.accent if checked else T.background,
               border=T.border_light, border_width=1, align="center")
    return rect(row(box, text(label, color=T.text, font_size=T.font_size),
                    gap=8, align="center"),
                route=route, padding=(2, 2, 2, 2), radius=4,
                hover_fill=(1, 1, 1, 0.04))


def _radio(label: str, selected: bool, route: str) -> El:
    dot = rect(rect(width=8, height=8, radius=4,
                    fill=T.accent if selected else (0, 0, 0, 0)),
               width=16, height=16, radius=8, align="center",
               border=T.accent if selected else T.border_light,
               border_width=1)
    return rect(row(dot, text(label, color=T.text, font_size=T.font_size),
                    gap=8, align="center"),
                route=route, padding=(2, 2, 2, 2), radius=4,
                hover_fill=(1, 1, 1, 0.04))


# -- the modals --------------------------------------------------------------

def settings_modal(config) -> El:
    body = [
        _checkbox("Show avatars", config.show_avatars, "toggle-avatars"),
        _checkbox("Fast scroll (2×)", config.scroll_speed_fast,
                  "toggle-scroll-speed"),
        _checkbox("Large rows (1.5×)", config.row_size_large,
                  "toggle-row-size"),
        _checkbox("Show shortcut bar", config.show_shortcut_bar,
                  "toggle-shortcut-bar"),
        _checkbox("AI worktree taglines (claude CLI)", config.ai_taglines,
                  "toggle-ai-taglines"),
        _checkbox("Project Rewind snapshots", config.rewind_enabled,
                  "toggle-rewind"),
        text("Settings are saved to ~/.config/whisper-git/settings.json",
             font_size=10, color=T.text_muted),
    ]
    return _modal_frame("Settings", body, key="modal-settings")


def open_repo_modal(form: OpenRepoForm, cursor=None) -> El:
    body = [
        _field("Repository path", form.path, "path", "path",
               placeholder="/path/to/repo", cursor=cursor),
        _buttons("Open", "do-open-repo", enabled=bool(form.path)),
    ]
    return _modal_frame("Open Repository", body, key="modal-open-repo")


def confirm_modal(state: ConfirmState) -> El:
    body = [
        text(state.message, color=T.text, wrap=True, width="fill"),
        _buttons(state.confirm_label, "do-confirm",
                 destructive=state.destructive),
    ]
    return _modal_frame(state.title, body, key="modal-confirm-dialog")


def error_modal(state: ErrorState) -> El:
    body = [
        text(state.message, color=T.text, wrap=True, width="fill"),
        row(spacer(),
            rect(text("OK", bold=True, color=T.text_bright), fill=T.accent,
                 radius=5, padding=(5, 14, 5, 14), route="close-modal"),
            width="fill"),
    ]
    return _modal_frame(state.title or "Error", body, key="modal-error")


def clone_modal(form: CloneForm, busy: bool = False,
                cursor=None) -> El:
    body = [
        _field("Repository URL", form.url, "url", form.focused,
               placeholder="https://github.com/user/repo.git",
               cursor=cursor),
        _field("Destination", form.dest, "dest", form.focused,
               placeholder="~/src/repo", cursor=cursor),
        (text("Cloning…", color=T.accent) if busy else
         _buttons("Clone", "do-clone",
                  enabled=bool(form.url and form.dest))),
    ]
    return _modal_frame("Clone Repository", body, key="modal-clone")


def token_modal(form: TokenForm, cursor=None) -> El:
    body = [
        row(_radio("GitHub", form.provider == "github",
                   "token-provider:github"),
            _radio("GitLab", form.provider == "gitlab",
                   "token-provider:gitlab"),
            gap=14),
    ]
    if form.provider == "gitlab":
        body.append(_field("Host", form.host, "host", form.focused,
                           placeholder="gitlab.com", cursor=cursor))
    body += [
        _field("Access token", form.token, "token", form.focused,
               secret=True, placeholder="ghp_… / glpat-…", cursor=cursor),
        text("Stored in the system keychain.", font_size=10,
             color=T.text_muted),
        _buttons("Save token", "do-save-token",
                 enabled=bool(form.token)),
    ]
    title = "Edit CI Token" if form.editing else "Add CI Token"
    return _modal_frame(title, body, key="modal-token")


def branch_modal(form: BranchForm, cursor=None) -> El:
    at = f" at {form.at_oid[:8]}" if form.at_oid else ""
    body = [
        _field("Branch name", form.name, "name", "name", cursor=cursor,
               placeholder="feature/thing"),
        _buttons("Create" + at, "do-create-branch",
                 enabled=bool(form.name)),
    ]
    return _modal_frame("Create Branch", body, key="modal-branch")


def tag_modal(form: TagForm, cursor=None) -> El:
    at = f" at {form.at_oid[:8]}" if form.at_oid else ""
    body = [
        _field("Tag name", form.name, "name", form.focused, cursor=cursor,
               placeholder="v1.0.0"),
        _field("Message (annotated if set)", form.message, "message",
               form.focused, cursor=cursor),
        _buttons("Create" + at, "do-create-tag", enabled=bool(form.name)),
    ]
    return _modal_frame("Create Tag", body, key="modal-tag")


def pull_modal(form: PullForm) -> El:
    body = [
        _checkbox("Rebase instead of merge", form.rebase, "toggle-pull-rebase"),
        _buttons("Pull", "do-pull", destructive=False),
    ]
    return _modal_frame("Pull Options", body, key="modal-pull")


def push_modal(form: PushForm, remotes: list[str]) -> El:
    body: list[El] = []
    if len(remotes) > 1:
        body.append(row(*[_radio(r, form.remote == r, f"push-remote:{r}")
                          for r in remotes[:4]], gap=12))
    body += [
        _checkbox("Force with lease", form.force_with_lease,
                  "toggle-push-force"),
        _checkbox("Set upstream", form.set_upstream, "toggle-push-upstream"),
        _checkbox("Include tags", form.push_tags, "toggle-push-tags"),
        _buttons("Push", "do-push-options",
                 destructive=form.force_with_lease),
    ]
    return _modal_frame("Push Options", body, key="modal-push")


def merge_modal(form: MergeForm) -> El:
    body = [
        text(f"Merge {form.branch!r} into the current branch", color=T.text),
        _radio("Default (fast-forward when possible)",
               form.strategy == "default", "merge-strategy:default"),
        _radio("Always create a merge commit (--no-ff)",
               form.strategy == "no-ff", "merge-strategy:no-ff"),
        _radio("Fast-forward only (--ff-only)",
               form.strategy == "ff-only", "merge-strategy:ff-only"),
        _radio("Squash", form.strategy == "squash", "merge-strategy:squash"),
        _buttons("Merge", "do-merge", destructive=False),
    ]
    return _modal_frame("Merge Options", body, key="modal-merge")


def rebase_modal(form: RebaseForm) -> El:
    body = [
        text(f"Rebase the current branch onto {form.onto!r}", color=T.text),
        _checkbox("Autostash", form.autostash, "toggle-rebase-autostash"),
        _checkbox("Preserve merges (--rebase-merges)", form.rebase_merges,
                  "toggle-rebase-merges"),
        _buttons("Rebase", "do-rebase"),
    ]
    return _modal_frame("Rebase Options", body, key="modal-rebase")


def worktree_modal(form: WorktreeForm, cursor=None) -> El:
    body = [
        _field("New branch", form.branch, "branch", form.focused, cursor=cursor,
               placeholder="feature/thing"),
        _field("Path", form.path, "path", form.focused, cursor=cursor,
               placeholder="../repo-feature"),
        _field("Base (optional)", form.base, "base", form.focused, cursor=cursor,
               placeholder="main"),
        _buttons("Create worktree", "do-create-worktree",
                 enabled=bool(form.branch and form.path)),
    ]
    return _modal_frame("New Worktree", body, key="modal-worktree")


def worktrees_manage_modal(tab) -> El:
    body: list[El] = []
    for wt in tab.worktrees:
        view = tab.worktree_views.get(wt.path)
        cells = [text(wt.name, color=T.text, bold=wt.is_main),
                 text(wt.branch or "detached", font_size=10,
                      color=T.text_muted)]
        if view and view.dirty:
            cells.append(rect(width=7, height=7, radius=3.5, fill=T.warning))
        cells.append(spacer())
        if not wt.is_main:
            cells.append(rect(text("Remove", font_size=10, color=T.danger),
                              route=f"confirm-remove-worktree:{wt.path}",
                              radius=3, padding=(1, 6, 1, 6),
                              hover_fill=T.surface_hover))
        body.append(rect(row(*cells, gap=8, align="center", width="fill",
                             height="fill"),
                         width="fill", height=28, radius=4,
                         padding=(2, 8, 2, 8),
                         hover_fill=T.surface_hover))
    body.append(row(spacer(),
                    rect(text("New worktree…", color=T.accent),
                         route="open-worktree-dialog", radius=4,
                         padding=(3, 8, 3, 8), hover_fill=T.surface_hover),
                    width="fill"))
    return _modal_frame("Worktrees", body, width=480,
                        key="modal-worktrees-manage")


# -- interactive rebase (beyond-reference: Deferred in the reference's
# docs/user_needs.md) ---------------------------------------------------------

@dataclass
class RebaseIEntry:
    action: str   # pick | squash | fixup | drop
    oid: str
    subject: str


@dataclass
class RebaseIForm:
    onto: str                 # exclusive base commit
    entries: list = field(default_factory=list)  # oldest first (todo order)


def rebase_interactive_modal(form: RebaseIForm) -> El:
    action_tint = {"pick": T.success, "squash": T.info,
                   "fixup": T.info, "drop": T.danger}
    rows: list[El] = [
        text(f"Rebase {len(form.entries)} commits onto "
             f"{form.onto[:8]} — click the action to cycle "
             "pick → squash → fixup → drop; ↑/↓ reorder.",
             font_size=10, color=T.text_muted, wrap=True, width="fill"),
    ]
    for i, e in enumerate(form.entries):
        tint = action_tint.get(e.action, T.text_muted)
        dropped = e.action == "drop"
        cells = [
            rect(text(e.action.ljust(6), font_size=11, bold=True,
                      color=T.text_bright),
                 fill=(tint[0], tint[1], tint[2], 0.35), radius=4,
                 padding=(2, 6, 2, 6), width=64,
                 route=f"rebase-i-action:{i}",
                 hover_fill=T.surface_hover,
                 key=f"rebase-i-action:{i}"),
            text(e.oid[:8], font_size=11, color=T.text_muted),
            text(e.subject[:52], font_size=T.font_size,
                 color=T.text_muted if dropped else T.text),
            spacer(),
            rect(text("↑", font_size=11, color=T.text_muted),
                 route=f"rebase-i-move:{i}:-1" if i > 0 else None,
                 radius=3, padding=(0, 5, 0, 5),
                 hover_fill=T.surface_hover),
            rect(text("↓", font_size=11, color=T.text_muted),
                 route=(f"rebase-i-move:{i}:1"
                        if i < len(form.entries) - 1 else None),
                 radius=3, padding=(0, 5, 0, 5),
                 hover_fill=T.surface_hover),
        ]
        rows.append(rect(
            row(*cells, gap=8, align="center", width="fill",
                height="fill"),
            width="fill", height=26, radius=4, padding=(2, 6, 2, 6),
            opacity=0.55 if dropped else 1.0,
            fill=T.background, key=f"rebase-i-row:{i}"))
    kept = [e for e in form.entries if e.action != "drop"]
    valid = bool(kept) and kept[0].action == "pick"
    if kept and kept[0].action != "pick":
        rows.append(text("The first kept commit must be a pick "
                         "(squash/fixup meld into the previous one).",
                         font_size=10, color=T.danger))
    rows.append(_buttons("Start rebase", "do-rebase-i", enabled=valid))
    return _modal_frame("Interactive Rebase", rows, width=560,
                        key="modal-rebase-i")


# Keyboard map shown by the Help modal (reference header bar includes a
# Help button — docs/ux-design-2026-02.md header-bar row; content mirrors
# README "Keyboard Shortcuts").
_HELP_SECTIONS = (
    ("GLOBAL", (
        ("Ctrl+O / Ctrl+W", "Open / close repository tab"),
        ("Ctrl+Tab / Ctrl+Shift+Tab", "Next / previous tab"),
        ("Tab", "Cycle focus: graph → staging → sidebar"),
        ("Ctrl+P / Ctrl+K", "Command palette (incl. Project Rewind)"),
        ("Ctrl+S / Ctrl+Shift+S", "Stash push / pop"),
        ("Middle-click", "Paste PRIMARY into clicked input"),
        ("Escape", "Close topmost surface, then exit"),
    )),
    ("COMMIT GRAPH", (
        ("j / k, PageUp / PageDown", "Navigate commits"),
        ("Enter", "Select commit (details + diff)"),
        ("/ or Ctrl+F", "Search (dims non-matches)"),
        ("Shift+click / Shift+J/K", "Compare commits (range diff)"),
        ("Right-click", "Commit context menu"),
    )),
    ("SIDEBAR", (
        ("j / k, Enter", "Navigate + checkout / apply"),
        ("d", "Delete selected branch"),
        ("Right-click", "Context menu per item type"),
    )),
    ("STAGING", (
        ("Tab", "Cycle subject → body → lists"),
        ("Ctrl+Enter", "Commit"),
        ("Ctrl+Shift+A", "Toggle amend"),
        ("Double-click file", "Stage / unstage"),
        ("Shift+arrows, Ctrl+A/C", "Select / copy in inputs"),
    )),
    ("DIFF", (
        ("Left / Right, Shift+wheel", "Horizontal scroll"),
        ("Hunk buttons", "Stage / Unstage / Discard"),
    )),
)


def help_modal() -> El:
    """Keyboard-map overlay (reference: header Help button)."""
    body: list[El] = []
    for title, rows_ in _HELP_SECTIONS:
        body.append(text(title, font_size=10, bold=True,
                         color=T.text_muted))
        for keys, desc in rows_:
            body.append(row(
                rect(text(keys, font_size=10, color=T.text_bright),
                     fill=(1, 1, 1, 0.08), radius=4,
                     padding=(1, 6, 1, 6)),
                text(desc, font_size=11, color=T.text),
                gap=8, align="center", width="fill"))
    return _modal_frame("Keyboard Shortcuts", body, width=460,
                        key="modal-help")


def rewind_modal(state) -> El:
    """Project Rewind timeline (the reference design review's "10x
    feature", design_feedback_feb2026.md:368-414): scrub through state
    snapshots, see what changed since, copy the commands to get back."""
    from ...gitcore.types import format_relative_time
    from ...services.rewind import diff_to_now, restore_commands

    snaps = state.snapshots
    body: list[El] = []
    if not snaps:
        body.append(text("No snapshots yet — Rewind records repository "
                         "state every 30 s while the app runs.",
                         font_size=11, color=T.text_muted, wrap=True))
        return _modal_frame("Project Rewind", body, width=560,
                            key="modal-rewind")

    sel = max(0, min(state.index, len(snaps) - 1))
    now_snap = snaps[-1]
    cur = snaps[sel]

    # -- timeline dots (downsampled to ≤40, selected always shown) -------
    idxs = list(range(len(snaps)))
    if len(idxs) > 40:
        step = len(idxs) / 39.0
        idxs = sorted({int(i * step) for i in range(39)} | {sel,
                                                            len(snaps) - 1})
    dots: list[El] = []
    for i in idxs:
        is_sel = i == sel
        is_now = i == len(snaps) - 1
        color = (T.accent if is_sel else
                 T.success if is_now else
                 T.warning if snaps[i].label else (1, 1, 1, 0.35))
        d = 11.0 if is_sel else 7.0
        dots.append(rect(width=d, height=d, radius=d / 2, fill=color,
                         route=f"rewind-scrub:{i}",
                         hover_fill=T.accent))
    dots.append(text("NOW", font_size=9, bold=True, color=T.success))
    body.append(rect(row(*dots, gap=5, align="center"),
                     width="fill", height=26, align="center",
                     fill=(1, 1, 1, 0.04), radius=6,
                     padding=(4, 8, 4, 8)))
    body.append(row(
        rect(text("< older", font_size=10, color=T.text_bright),
             route="rewind-step:-1", radius=4, padding=(2, 8, 2, 8),
             fill=(1, 1, 1, 0.08), hover_fill=T.surface_hover),
        text(f"{sel + 1}/{len(snaps)}", font_size=10, color=T.text_muted),
        rect(text("newer >", font_size=10, color=T.text_bright),
             route="rewind-step:1", radius=4, padding=(2, 8, 2, 8),
             fill=(1, 1, 1, 0.08), hover_fill=T.surface_hover),
        spacer(),
        text("Left/Right to scrub", font_size=9, color=T.text_muted),
        gap=8, align="center", width="fill"))

    # -- selected snapshot summary ---------------------------------------
    when = format_relative_time(int(cur.ts))
    title = f"{when}" + (f" — {cur.label}" if cur.label else "")
    body.append(row(
        text(title, font_size=T.font_size, bold=True, color=T.text_bright),
        spacer(),
        text("current state" if sel == len(snaps) - 1 else "",
             font_size=10, color=T.success),
        align="center", width="fill"))
    head = cur.head_oid[:8] if cur.head_oid else "(unborn)"
    body.append(text(f"{cur.branch or '(detached)'} @ {head} · "
                     f"{cur.dirty_summary()} · "
                     f"{len(cur.stashes)} stash"
                     f"{'es' if len(cur.stashes) != 1 else ''}",
                     font_size=11, color=T.text))
    if cur.worktree_state:
        # Per-worktree dirty lines, as in the spec's timeline mockup
        # ("main-app/ dirty(2)", design_feedback_feb2026.md:390).
        parts = [f"{name}: {'dirty(' + str(n) + ')' if n else 'clean'}"
                 for name, n in cur.worktree_state]
        body.append(text("worktrees — " + " · ".join(parts[:5])
                         + ("…" if len(parts) > 5 else ""),
                         font_size=10, color=T.text_muted))

    # -- diff to now ------------------------------------------------------
    if sel != len(snaps) - 1:
        lines = diff_to_now(cur, now_snap)
        body.append(text("SINCE THEN", font_size=9, bold=True,
                         color=T.text_muted))
        for ln in lines[:8]:
            body.append(rect(text(ln, font_size=10, color=T.text),
                             fill=(1, 1, 1, 0.05), radius=4,
                             padding=(2, 8, 2, 8), width="fill"))
        if len(lines) > 8:
            body.append(text(f"… {len(lines) - 8} more", font_size=10,
                             color=T.text_muted))

        # -- restore commands (shown on demand, copied — never run) ------
        if state.show_commands:
            cmds = restore_commands(cur, now_snap)
            body.append(text("RESTORE COMMANDS", font_size=9, bold=True,
                             color=T.text_muted))
            for c in cmds:
                body.append(rect(
                    text(c, font_size=10,
                         color=T.text_muted if c.startswith("#")
                         else T.text_bright),
                    fill=(0, 0, 0, 0.35), radius=4,
                    padding=(2, 8, 2, 8), width="fill"))
        body.append(row(
            rect(text("Hide commands" if state.show_commands
                      else "Restore This State…", font_size=11, bold=True,
                      color=T.text_bright),
                 route="rewind-commands", radius=6, padding=(4, 10, 4, 10),
                 fill=(T.accent[0], T.accent[1], T.accent[2], 0.35),
                 hover_fill=T.surface_hover),
            rect(text("Copy commands", font_size=11, color=T.text_bright),
                 route="rewind-copy", radius=6, padding=(4, 10, 4, 10),
                 fill=(1, 1, 1, 0.08), hover_fill=T.surface_hover),
            gap=8, align="center"))
    return _modal_frame("Project Rewind", body, width=560,
                        key="modal-rewind")


def info_modal(state: ErrorState) -> El:
    """Neutral informational modal (same shape as error_modal, accent
    border instead of danger — used for AI branch-intent summaries)."""
    body = [
        text(state.message, color=T.text, wrap=True, width="fill"),
        row(spacer(),
            rect(text("Close", color=T.text), fill=T.surface_hover,
                 radius=5, padding=(5, 12, 5, 12), route="close-modal"),
            width="fill"),
    ]
    return _modal_frame(state.title, body, key="modal-info")
