"""WhisperApp — the application root and state machine.

Capability parity with reference src/ui_app.rs: tab management, the
15-variant modal set, 13-variant confirm actions, context menus, toasts,
focus cycling, string-keyed action routing (handle_action, :1004), the
once-per-frame poll loop (poll_async_ops, :3069) with its safety nets
(30 s status net :3326, 5 s ref-fingerprint reconciliation :3355), and
remote-op slot management with error classification and force-push
retry (:3707-3818).
"""

from __future__ import annotations

import os
import queue
import time
from typing import Optional

from ..engine import EventLoopProxy, FsChangeKind
from ..engine.async_ops import (
    PushOptions,
    RebaseOptions,
    cherry_pick_abort_async,
    cherry_pick_async,
    cherry_pick_continue_async,
    classify_git_error,
    clone_async,
    create_worktree_with_post_steps_async,
    fetch_async,
    interactive_rebase_async,
    merge_abort_async,
    merge_async,
    merge_continue_async,
    merge_ff_only_async,
    merge_no_ff_async,
    merge_squash_async,
    pull_async,
    pull_rebase_async,
    push_with_options_async,
    rebase_abort_async,
    rebase_continue_async,
    rebase_with_options_async,
    remove_submodule_async,
    revert_abort_async,
    revert_async,
    revert_continue_async,
    stash_apply_async,
    stash_drop_async,
    stash_pop_async,
    stash_push_async,
    worktree_remove_async,
)
from ..engine.dirty import DirtyCheckResult, spawn_dirty_checks
from ..gitcore import refs as grefs
from ..gitcore import status as gstatus
from ..gitcore.diff import commit_diff, file_in_commit_diff, working_file_diff
from ..gitcore.hunk import discard_hunk, stage_hunk, unstage_hunk
from ..gitcore.repo import GitRepo
from ..services.config import Config
from ..tracing import COUNTERS, span
from ..ui import El, column, rect, row, stack, text
from ..ui.theme import DARK as T
from .palette import PaletteState, build_commands
from .repo_tab import RepoTab, TimedOp
from .views import chrome, dialogs
from .views.commit_details import commit_details_pane
from .views.commit_graph import history_view
from .views.diff import diff_view
from .views.sidebar import sidebar as sidebar_view
from .views.staging import staging_well, worktree_picker_overlay
from .views.welcome import welcome_view
from .views.widgets import (ContextMenuState, MenuItem, Toast, context_menu,
                            palette_overlay, toasts_overlay)

STATUS_SAFETY_NET_SECS = 30.0   # reference: ui_app.rs:3326
FINGERPRINT_INTERVAL_SECS = 5.0  # reference: ui_app.rs:3355
CI_POLL_FAST_SECS = 15.0        # reference: ui_app.rs:114-127
CI_POLL_SLOW_SECS = 300.0
CI_FAST_WINDOW_AFTER_PUSH = 300.0


class WhisperApp:
    def __init__(self, config: Optional[Config] = None,
                 proxy: Optional[EventLoopProxy] = None):
        self.config = config or Config()
        self.proxy = proxy
        self.tabs: list[RepoTab] = []
        self.active_tab = 0
        self.hover_route: Optional[str] = None  # set by Runner.pointer_move
        self.focus = "graph"            # graph | sidebar | staging
        # Caret index within the focused input; None = end-of-text. Reset
        # whenever focus moves (the focused_input setter below).
        self.input_cursor: Optional[int] = None
        self.focused_input = ""         # subject | body | search | modal keys
        self.modal: Optional[tuple[str, object]] = None
        self.context_menu: Optional[ContextMenuState] = None
        self.palette: Optional[PaletteState] = None
        self.worktree_picker_open = False
        self.toasts: list[Toast] = []
        self.diff_files = []            # currently shown diff
        self.diff_source = "commit"
        self.diff_title = ""
        self.diff_open = False
        self.clone_rx: Optional[queue.Queue] = None
        self.dirty_q: "queue.Queue[DirtyCheckResult]" = queue.Queue()
        from ..services.avatar import AvatarCache
        self.avatar_cache = AvatarCache(
            proxy=proxy,
            enabled=self.config.show_avatars
            and not os.environ.get("WGIT_SKIP_AVATARS"))
        self.selection_text = ""        # clipboard fallback
        self.primary_selection = ""     # PRIMARY store (middle-click paste)
        self._focus_route_hit = False   # set when a click lands on an input
        self.shift_click = False        # Shift held on the current click
        self.input_anchor: Optional[int] = None  # selection anchor (None = no selection)
        self.quit_requested = False
        self._last_viewport = (1280.0, 800.0)

    # Focus moves reset the caret to end-of-text (reference text inputs:
    # click/Tab focus places the cursor at the end).
    @property
    def focused_input(self) -> str:
        return self._focused_input

    @focused_input.setter
    def focused_input(self, value: str) -> None:
        if value != getattr(self, "_focused_input", None):
            self.input_cursor = None
            self.input_anchor = None
        self._focused_input = value

    # The host assigns the proxy after construction (the reference wires it
    # through host::run's on_proxy callback); propagate it to services that
    # captured it at init so their completion doorbells actually ring.
    @property
    def proxy(self):
        return self._proxy

    @proxy.setter
    def proxy(self, value) -> None:
        self._proxy = value
        cache = getattr(self, "avatar_cache", None)
        if cache is not None:
            cache._proxy = value

    # -- construction --------------------------------------------------------

    @classmethod
    def from_paths(cls, paths: list[str],
                   config: Optional[Config] = None) -> "WhisperApp":
        app = cls(config=config or Config.load())
        for p in paths:
            try:
                app.tabs.append(RepoTab.open(p))
                app.config.add_recent_repo(p)
            except Exception as exc:
                app.toast("error", f"Could not open {p}: {exc}")
        return app

    @classmethod
    def with_tabs(cls, tabs: list[RepoTab]) -> "WhisperApp":
        """Headless constructor with a default Config for hermetic golden
        dumps (reference: ui_app.rs:463-465)."""
        app = cls(config=Config())
        app.tabs = list(tabs)
        return app

    # -- helpers -------------------------------------------------------------

    def current(self) -> Optional[RepoTab]:
        if not self.tabs:
            return None
        self.active_tab = min(self.active_tab, len(self.tabs) - 1)
        return self.tabs[self.active_tab]

    def toast(self, kind: str, message: str) -> None:
        self.toasts.append(Toast(kind, message))
        self.toasts = [t for t in self.toasts if not t.expired()][-10:]

    def ci_overall_state(self, tab: RepoTab) -> Optional[str]:
        try:
            from ..services.ci import overall_of_results
            return overall_of_results(tab.ci_results.values())
        except Exception:
            return None

    def run_sync_op(self, label: str, fn) -> bool:
        """Run a synchronous libgit-style op, toast on failure, refresh
        (reference: run_op, ui_app.rs:4312)."""
        tab = self.current()
        try:
            fn()
        except Exception as exc:
            self.toast("error", f"{label} failed: {exc}")
            return False
        if tab is not None:
            tab.reopen_repo_handles()
            tab.trigger_state_refresh(self.proxy)
            tab.trigger_status_refresh(self.proxy)
        return True

    def _slot_free(self, tab: RepoTab, slot: str) -> bool:
        """Single in-flight op per slot (reference: prepare_remote_op busy
        check, ui_app.rs:3891)."""
        if getattr(tab, slot) is not None:
            self.toast("info", "An operation is already running")
            return False
        return True

    def _wd(self, tab: RepoTab) -> str:
        return tab.active_repo().root

    # -- frame protocol ------------------------------------------------------

    def before_build(self) -> None:
        for tab in self.tabs:
            if not tab.initial_refresh_done and tab.state_refresh_rx is None:
                tab.trigger_state_refresh(self.proxy)
                tab.trigger_status_refresh(self.proxy)
        with span("poll"):
            self.poll_async_ops()

    def build(self, viewport: tuple[float, float]) -> El:
        self._last_viewport = viewport
        self._sync_row_scale()
        layers: list[El] = [self._main_layer()]
        if self.worktree_picker_open and self.current() is not None:
            layers.append(rect(
                worktree_picker_overlay(self.current()),
                width="fill", height="fill", align="center",
                route="close-picker", key="picker-scrim"))
        if self.context_menu is not None:
            layers.append(context_menu(self.context_menu,
                                       viewport=self._last_viewport))
        if self.modal is not None:
            layers.append(self._modal_layer())
        if self.palette is not None:
            layers.append(palette_overlay(self.palette))
        overlay = toasts_overlay(self.toasts)
        if overlay is not None:
            layers.append(overlay)
        tree = stack(*layers, width="fill", height="fill", fill=T.background)
        if self.hover_route:
            from ..ui.hover import apply_hover

            tree = apply_hover(tree, self.hover_route)
        return tree

    def _main_layer(self) -> El:
        tab = self.current()
        if tab is None:
            return welcome_view(self.config.recent_repos)
        rows: list[El] = [chrome.tab_bar(self)]
        rows.append(chrome.header_bar(self, tab))
        crumb = chrome.breadcrumb(self, tab)
        if crumb is not None:
            rows.append(crumb)
        if self.config.show_shortcut_bar:
            rows.append(chrome.shortcut_bar(self.focus))

        right: El
        view = tab.active_view()
        if self.diff_open:
            right = diff_view(self.diff_files, scroll_offset=tab.diff_scroll,
                              hscroll=tab.diff_hscroll,
                              source=self.diff_source, title=self.diff_title,
                              mode=self.config.diff_mode)
        elif tab.selected_oid and tab.commit_detail is not None:
            right = commit_details_pane(
                tab, tab.commit_detail,
                submodule_pins=self._detail_pins(tab))
        else:
            right = staging_well(tab, focused_input=self.focused_input,
                                 ai_busy=tab.ai_op is not None,
                                 cursor=self.input_cursor,
                                 anchor=self.input_anchor)

        def divider(pane: str) -> El:
            # Drag-resizable pane divider (reference README: "drag-
            # resizable dividers"); the drag route receives move deltas.
            return rect(width=5, height="fill", fill=T.background,
                        hover_fill=T.surface_hover,
                        route_drag=f"pane-resize:{pane}",
                        key=f"divider-{pane}")

        body = row(
            rect(sidebar_view(tab), width=self.config.sidebar_width,
                 height="fill"),
            divider("sidebar"),
            rect(history_view(tab, show_avatars=self.config.show_avatars,
                              avatar_cache=self.avatar_cache,
                              search_focused=self.focused_input == "search",
                              search_cursor=self.input_cursor,
                              search_anchor=self.input_anchor),
                 flex=1, height="fill",
                 border=T.accent if self.focus == "graph" else None,
                 border_width=2 if self.focus == "graph" else 0),
            divider("right"),
            rect(right, width=self.config.right_panel_width, height="fill"),
            width="fill", flex=1)
        rows.append(body)
        return column(*rows, width="fill", height="fill")

    def _detail_pins(self, tab: RepoTab):
        """Memoized per (tab, oid): build() runs on every frame wake
        (pulse: ~7/s) and submodules_at_commit spawns a recursive
        ls-tree + git show — unmemoized, an open details pane churned
        subprocesses continuously. A commit's tree is immutable, so the
        oid fully keys the result."""
        if tab.selected_oid is None or not tab.submodules:
            return None
        key = (tab.tab_id, tab.selected_oid)
        cache = getattr(self, "_detail_pins_cache", None)
        if cache is None:
            cache = self._detail_pins_cache = {}
        if key in cache:
            return cache[key]
        try:
            pins = grefs.submodules_at_commit(tab.repo, tab.selected_oid)
        except Exception:
            return None  # transient failure: retry next frame, never cache
        if len(cache) > 64:
            cache.clear()
        cache[key] = pins
        return pins

    def _modal_layer(self) -> El:
        kind, form = self.modal
        tab = self.current()
        cur = self.input_cursor
        builders = {
            "settings": lambda: dialogs.settings_modal(self.config),
            "help": lambda: dialogs.help_modal(),
            "open-repo": lambda: dialogs.open_repo_modal(form, cursor=cur),
            "confirm": lambda: dialogs.confirm_modal(form),
            "error": lambda: dialogs.error_modal(form),
            "clone": lambda: dialogs.clone_modal(
                form, busy=self.clone_rx is not None, cursor=cur),
            "token": lambda: dialogs.token_modal(form, cursor=cur),
            "branch": lambda: dialogs.branch_modal(form, cursor=cur),
            "tag": lambda: dialogs.tag_modal(form, cursor=cur),
            "pull": lambda: dialogs.pull_modal(form),
            "push": lambda: dialogs.push_modal(
                form, tab.remotes if tab else ["origin"]),
            "merge": lambda: dialogs.merge_modal(form),
            "rebase": lambda: dialogs.rebase_modal(form),
            "worktree": lambda: dialogs.worktree_modal(form, cursor=cur),
            "rebase-i": lambda: dialogs.rebase_interactive_modal(form),
            "worktrees-manage": lambda: dialogs.worktrees_manage_modal(tab),
            "rewind": lambda: dialogs.rewind_modal(form),
            "info": lambda: dialogs.info_modal(form),
        }
        builder = builders.get(kind)
        return builder() if builder else rect(width=0, height=0)

    # ========================================================================
    # Action routing (reference: handle_action, ui_app.rs:1004-1381).
    # ========================================================================

    def handle_action(self, route: str, x: float = 0.0, y: float = 0.0
                      ) -> None:
        if route is None:
            return
        head, _, arg = route.partition(":")
        tab = self.current()
        handler = getattr(self, f"_act_{head.replace('-', '_')}", None)
        if handler is not None:
            with span("input"):
                handler(arg, x, y)
            return
        # Fallthrough actions that need a tab.
        if tab is None:
            return
        self.toast("info", f"Unhandled action: {route}")

    # -- focus / navigation --------------------------------------------------

    def _act_focus_graph(self, arg, x, y):
        self.focus = "graph"
        self.focused_input = ""

    def _act_focus_sidebar(self, arg, x, y):
        self.focus = "sidebar"
        self.focused_input = ""

    def _act_focus_staging(self, arg, x, y):
        self.focus = "staging"

    def _act_focus_staging_commit(self, arg, x, y):
        self.focus = "staging"
        self.focused_input = "subject"
        tab = self.current()
        if tab:
            tab.select_commit(None)
            self.diff_open = False

    def _act_focus_input(self, arg, x, y):
        self.focused_input = arg
        # Mark that this dispatch landed on a text input, so middle-click
        # paste targets the input UNDER the click (reference
        # src/host.rs:874-897), not whatever was focused before.
        self._focus_route_hit = True
        # Click-to-caret: the Runner stashed the click x relative to the
        # input's content origin — map it to a logical caret index,
        # exact through bidi/Arabic shaping (atlas caret map). Without
        # the stash (keyboard/Tab focus) the caret goes to the end.
        relx = getattr(self, "pending_click_text_x", None)
        self.pending_click_text_x = None
        measurer = getattr(self, "click_measurer", None)
        if relx is not None and measurer is not None:
            value = self._input_read()
            if value:
                from ..ui.theme import DARK

                idx = measurer.caret_index_from_click(
                    value, DARK.font_size, relx)
                self.input_cursor = None if idx >= len(value) else idx
                self.input_anchor = None
        if arg in ("subject", "body"):
            self.focus = "staging"
        # Keep the modal form's own focus marker in sync so the caret
        # renders in the field that actually receives keystrokes.
        if self.modal is not None and self.modal[1] is not None \
                and hasattr(self.modal[1], "focused"):
            self.modal[1].focused = arg

    def _act_close_menu(self, arg, x, y):
        self.context_menu = None

    def _act_close_picker(self, arg, x, y):
        self.worktree_picker_open = False

    def _act_close_modal(self, arg, x, y):
        self.modal = None
        self.focused_input = ""

    def _act_close_palette(self, arg, x, y):
        self.palette = None

    def _act_palette_run(self, arg, x, y):
        """Mouse activation of a palette row (`palette-run:<index>`)."""
        pal = self.palette
        if pal is None:
            return
        matches = pal.matches()
        try:
            idx = int(arg)
        except ValueError:
            return
        if not 0 <= idx < len(matches):
            return
        self.palette = None
        self.handle_action(matches[idx][0].route)

    def _act_search_history(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        self.focus = "graph"
        tab.search_active = True
        self.focused_input = "search"

    def _palette_key(self, key: str, ctrl: bool) -> None:
        """All keyboard input while the palette is open lands here
        (the Escape ladder already closed it if Escape was pressed)."""
        pal = self.palette
        matches = pal.matches()
        if key in ("Down", "Tab") or (ctrl and key.lower() in ("n", "j")):
            pal.selected = min(pal.selected + 1, max(0, len(matches) - 1))
        elif key == "Up" or (ctrl and key.lower() in ("p", "k")):
            pal.selected = max(pal.selected - 1, 0)
        elif key == "Backspace":
            pal.query = pal.query[:-1]
            pal.selected = 0
        elif key == "Enter":
            if matches:
                sel = min(pal.selected, len(matches) - 1)
                self.palette = None
                self.handle_action(matches[sel][0].route)
        elif len(key) == 1 and not ctrl:
            pal.query += key
            pal.selected = 0

    def _act_close_diff(self, arg, x, y):
        self.diff_open = False

    def _act_close_details(self, arg, x, y):
        tab = self.current()
        if tab:
            tab.select_commit(None)

    def _act_noop(self, arg, x, y):
        pass

    # -- tabs ----------------------------------------------------------------

    def _act_tab_select(self, arg, x, y):
        self.active_tab = int(arg)
        self.diff_open = False

    def _act_tab_close(self, arg, x, y):
        i = int(arg)
        if 0 <= i < len(self.tabs):
            tab = self.tabs.pop(i)
            tab.stop_workers()
            for anc in tab.nav_stack:
                anc.stop_workers()
            self.toast("info", f"Closed {tab.title}")
            if self.active_tab >= len(self.tabs):
                self.active_tab = max(0, len(self.tabs) - 1)

    def open_repo(self, path: str) -> None:
        try:
            tab = RepoTab.open(path)
        except Exception as exc:
            self.modal = ("error", dialogs.ErrorState(
                "Could not open repository", str(exc)))
            return
        self.tabs.append(tab)
        self.active_tab = len(self.tabs) - 1
        self.config.add_recent_repo(path, tab.title)
        self.config.save()
        self.toast("success", f"Opened {tab.title}")

    def _act_open_recent(self, arg, x, y):
        self.open_repo(arg)

    # -- selection / history -------------------------------------------------

    def _act_select_commit(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        self.focus = "graph"
        # Shift+click with an existing selection → range compare
        # (design_feedback_feb2026.md:492; terminals that swallow
        # Shift+click reach the same via the commit context menu).
        if (self.shift_click and tab.selected_oid
                and arg and arg != tab.selected_oid):
            self._open_range_compare(tab.selected_oid, arg)
            return
        tab.select_commit(arg)
        tab.compare_range = None
        tab.compare_set = frozenset()
        self.diff_open = False
        if tab.selected_oid == arg:
            try:
                self.diff_files = commit_diff(tab.repo, arg)
                self.diff_source = "commit"
                self.diff_title = f"Commit {arg[:8]}"
            except Exception:
                self.diff_files = []

    def _open_range_compare(self, a: str, b: str) -> None:
        """Open the combined diff between two commits, oldest as base
        (commits list is newest-first)."""
        from ..gitcore.diff import range_diff

        tab = self.current()
        if tab is None:
            return
        order = {c.oid: i for i, c in enumerate(tab.commits)}
        ia, ib = order.get(a), order.get(b)
        if ia is not None and ib is not None and ia < ib:
            base, head = b, a   # larger index = older = base
        else:
            base, head = a, b
        # Exact membership (rev-list, not a list-index interval) doubles
        # as the commit counts — 3 subprocesses per compare, not 5.
        from ..gitcore.diff import range_oids
        try:
            files = range_diff(tab.repo, base, head)
            fwd = range_oids(tab.repo, base, head)
            back = range_oids(tab.repo, head, base)
        except Exception as exc:
            self.toast("error", f"Compare failed: {exc}")
            return
        if not fwd and back:
            # Caller-order fallback guessed the direction wrong (an
            # endpoint outside the loaded commit window): head is an
            # ancestor of base. Swap so the diff reads forward.
            base, head = head, base
            fwd, back = back, fwd
            try:
                files = range_diff(tab.repo, base, head)
            except Exception as exc:
                # The swapped title must never present the ORIGINAL
                # (reversed) diff — its +/- signs would read backwards.
                self.toast("error", f"Compare failed: {exc}")
                return
        tab.compare_range = (base, head)
        tab.compare_set = fwd | back | {base}
        tab.range_anchor = None
        tab.select_commit(head)
        self.diff_files = files
        self.diff_source = "range"

        def count(s):  # range_oids caps at 2000 — show saturation
            return f"{len(s)}+" if len(s) >= 2000 else str(len(s))

        if fwd and back:
            # Divergence explanation (design_feedback_feb2026.md:425),
            # deterministic: neither endpoint contains the other.
            self.diff_title = (f"diverged: {base[:8]} ({count(back)} own) "
                               f"vs {head[:8]} ({count(fwd)} own)")
        else:
            n = len(fwd)
            self.diff_title = (f"{base[:8]}..{head[:8]} · {count(fwd)} "
                               f"commit{'s' if n != 1 else ''}")
        self.diff_open = True

    def _act_compare_set_anchor(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        tab.range_anchor = arg
        self.toast("info",
                   f"Compare anchor {arg[:8]} — pick the other commit")

    def _act_compare_with_anchor(self, arg, x, y):
        tab = self.current()
        if tab is None or not tab.range_anchor:
            return
        self._open_range_compare(tab.range_anchor, arg)

    def _act_branch_intent(self, arg, x, y):
        """'What is this branch FOR?' — AI summary of the branch's unique
        commits vs the merge base (design_feedback_feb2026.md:423).
        All git subprocesses (merge-base included) run on the worker."""
        from ..services import ai

        tab = self.current()
        if tab is None or not tab.head_oid:
            return
        if ai.find_claude_binary() is None:
            self.toast("error", "claude CLI not found in PATH")
            return
        tip = next((t for t in tab.branch_tips
                    if t.name == arg and not t.is_remote), None)
        if tip is None:
            return
        rx = ai.spawn_branch_intent_async(tab.repo, tab.head_oid, tip.oid,
                                          self.proxy)
        tab.intent_rx = (arg, rx)
        self.toast("info", f"Summarizing {arg}…")

    def _act_compare_branch(self, arg, x, y):
        """Branch label → combined diff of that branch tip vs HEAD."""
        tab = self.current()
        if tab is None or not tab.head_oid:
            return
        tip = next((t for t in tab.branch_tips
                    if t.name == arg and not t.is_remote), None)
        if tip is None or tip.oid == tab.head_oid:
            self.toast("info", "Nothing to compare")
            return
        self._open_range_compare(tip.oid, tab.head_oid)

    def _act_jump_to(self, arg, x, y):
        self._act_select_commit(arg, x, y)

    def _act_view_details(self, arg, x, y):
        self._act_select_commit(arg, x, y)

    def _act_view_commit_file(self, arg, x, y):
        tab = self.current()
        if tab is None or tab.selected_oid is None:
            return
        tab.detail_file = arg
        try:
            self.diff_files = file_in_commit_diff(tab.repo,
                                                  tab.selected_oid, arg)
            self.diff_source = "commit"
            self.diff_title = arg
            self.diff_open = True
        except Exception as exc:
            self.toast("error", f"Diff failed: {exc}")

    def _set_clipboard(self, text_val: str, primary: bool = False) -> None:
        """Write the system clipboard — and, like the reference's Linux
        host (src/host.rs:874-897), the PRIMARY selection too, so
        middle-click pastes the copied text elsewhere."""
        self.selection_text = text_val
        if primary:
            self.primary_selection = text_val
        import subprocess
        targets = [(["wl-copy"], ["xclip", "-selection", "clipboard"])]
        if primary:
            targets.append((["wl-copy", "--primary"],
                            ["xclip", "-selection", "primary"]))
        for cmds in targets:
            for cmd in cmds:
                try:
                    # DEVNULL, not capture: a successful clipboard tool
                    # daemonizes to serve the selection and its child
                    # would hold captured pipes open — run() would then
                    # block the full timeout and misread success as
                    # TimeoutExpired.
                    r = subprocess.run(cmd, input=text_val.encode(),
                                       timeout=2,
                                       stdout=subprocess.DEVNULL,
                                       stderr=subprocess.DEVNULL)
                    if r.returncode == 0:
                        break
                    # e.g. wl-copy installed but no Wayland server (X11
                    # session): fall through to xclip.
                except (OSError, subprocess.TimeoutExpired):
                    continue

    def _get_primary(self) -> str:
        """Read the PRIMARY selection (middle-click paste source); falls
        back to the in-process store when no selection tool exists."""
        import subprocess
        for cmd in (["wl-paste", "--primary", "--no-newline"],
                    ["xclip", "-o", "-selection", "primary"]):
            try:
                out = subprocess.run(cmd, timeout=2, capture_output=True)
                if out.returncode == 0 and out.stdout:
                    return out.stdout.decode("utf-8", "replace")
            except (OSError, subprocess.TimeoutExpired):
                continue
        return self.primary_selection

    def paste_primary(self, at_click: bool = False) -> None:
        """Middle-click paste: insert the PRIMARY selection into the
        focused input (reference: src/host.rs:874-897). With
        `at_click=True` the paste only fires when the click itself landed
        on a text input (the `_focus_route_hit` marker set by
        `_act_focus_input`) — a middle-click on the graph or chrome must
        not inject text into a previously-focused field."""
        if at_click and not self._focus_route_hit:
            return
        text_val = self._get_primary()
        if text_val and self.focused_input:
            self.on_paste(text_val)

    def _act_copy_sha(self, arg, x, y):
        self._set_clipboard(arg, primary=True)
        self.toast("success", f"Copied {arg[:12]}")

    # -- sidebar -------------------------------------------------------------

    def _act_sidebar_toggle(self, arg, x, y):
        tab = self.current()
        if tab is not None:
            tab.sidebar_collapsed[arg] = not tab.sidebar_collapsed.get(arg,
                                                                       False)

    def _act_checkout_branch(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        if self.run_sync_op(
                f"Checkout {arg}",
                lambda: grefs.checkout_branch(tab.active_repo(), arg)):
            self.toast("success", f"Checked out {arg}")

    def _act_checkout_remote(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        if self.run_sync_op(
                f"Checkout {arg}",
                lambda: grefs.checkout_remote_branch(tab.active_repo(), arg)):
            self.toast("success", f"Created tracking branch from {arg}")

    def _act_select_worktree(self, arg, x, y):
        tab = self.current()
        if tab is not None:
            tab.select_worktree(arg)

    def _act_pick_worktree(self, arg, x, y):
        self.worktree_picker_open = False
        self._act_select_worktree(arg, x, y)

    def _act_open_worktree_picker(self, arg, x, y):
        self.worktree_picker_open = True

    def _act_apply_stash(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "other_op"):
            return
        tab.other_op = TimedOp(stash_apply_async(self._wd(tab), arg,
                                                 self.proxy),
                               f"Apply {arg}", "Stash")

    def _act_enter_submodule(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        child = tab.enter_submodule(arg)
        if child is None:
            self.toast("error", f"Submodule {arg} is not initialized")
            return
        self.tabs[self.active_tab] = child
        self.diff_open = False

    def _act_exit_to_depth(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        target = tab.exit_to_depth(int(arg))
        if target is not None:
            self.tabs[self.active_tab] = target
            self.diff_open = False

    def _act_switch_sibling(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        child = tab.switch_sibling_submodule(arg)
        if child is not None:
            self.tabs[self.active_tab] = child
            self.diff_open = False

    # -- staging -------------------------------------------------------------

    def _act_view_file(self, arg, x, y):
        tab = self.current()
        view = tab.active_view() if tab else None
        if tab is None or view is None:
            return
        bucket, _, path = arg.partition(":")
        view.selected_file = path
        view.selected_staged = bucket == "staged"
        try:
            repo = tab.active_repo()
            self.diff_files = working_file_diff(repo, path,
                                                staged=(bucket == "staged"))
            self.diff_source = "staged" if bucket == "staged" else "unstaged"
            self.diff_title = path
            self.diff_open = True
            tab.select_commit(None)
        except Exception as exc:
            self.toast("error", f"Diff failed: {exc}")

    def _act_stage_file(self, arg, x, y):
        tab = self.current()
        if tab:
            self.run_sync_op(f"Stage {arg}",
                             lambda: gstatus.stage_file(tab.active_repo(), arg))

    def _act_unstage_file(self, arg, x, y):
        tab = self.current()
        if tab:
            self.run_sync_op(
                f"Unstage {arg}",
                lambda: gstatus.unstage_file(tab.active_repo(), arg))

    def _act_toggle_stage(self, arg, x, y):
        """Double-click stage/unstage (reference README: "Stage/unstage
        individual files (double-click)"). arg = "bucket:path"."""
        bucket, _, path = arg.partition(":")
        if bucket == "staged":
            self._act_unstage_file(path, x, y)
        else:
            self._act_stage_file(path, x, y)

    def _act_stage_all(self, arg, x, y):
        tab = self.current()
        if tab:
            self.run_sync_op("Stage all",
                             lambda: gstatus.stage_all(tab.active_repo()))

    def _act_unstage_all(self, arg, x, y):
        tab = self.current()
        if tab:
            self.run_sync_op("Unstage all",
                             lambda: gstatus.unstage_all(tab.active_repo()))

    def _act_commit(self, arg, x, y):
        tab = self.current()
        view = tab.active_view() if tab else None
        if tab is None or view is None:
            return
        subject = view.draft_subject.strip()
        if not subject and not view.amend_mode:
            self.toast("error", "Commit subject is empty")
            return
        message = subject
        if view.draft_body.strip():
            message += "\n\n" + view.draft_body.strip()

        def do():
            repo = tab.active_repo()
            if view.amend_mode:
                grefs.amend_commit(repo, message)
            else:
                repo.commit(message)

        if self.run_sync_op("Commit", do):
            self.toast("success",
                       "Amended commit" if view.amend_mode else
                       f"Committed: {subject[:48]}")
            view.draft_subject = ""
            view.draft_body = ""
            view.amend_mode = False
            self.focused_input = "subject"  # auto-focus after commit

    def _act_toggle_amend(self, arg, x, y):
        tab = self.current()
        view = tab.active_view() if tab else None
        if tab is None or view is None:
            return
        view.amend_mode = not view.amend_mode
        if view.amend_mode and not view.draft_subject:
            info = grefs.full_commit_info(tab.active_repo(),
                                          tab.active_repo().head_oid() or "")
            if info is not None:
                parts = info.message.split("\n\n", 1)
                view.draft_subject = parts[0].strip()
                view.draft_body = parts[1].strip() if len(parts) > 1 else ""

    def _act_ai_generate(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "ai_op"):
            return
        from ..services.ai import spawn_generate_async
        rx = spawn_generate_async(tab.active_repo(), self.proxy,
                                  provider=self.config.ai_provider)
        if rx is None:
            self.toast("error", "Nothing staged to describe")
            return
        tab.ai_op = TimedOp(rx, "Generating commit message", "AI")

    # -- hunk ops ------------------------------------------------------------

    def _hunk_at(self, arg) -> Optional[tuple]:
        fi, _, hi = arg.partition(":")
        try:
            f = self.diff_files[int(fi)]
            return f, f.hunks[int(hi)]
        except (ValueError, IndexError):
            return None

    def _act_stage_hunk(self, arg, x, y):
        tab = self.current()
        got = self._hunk_at(arg)
        if tab is None or got is None:
            return
        f, hunk = got
        res = stage_hunk(tab.active_repo(), f.path, hunk)
        if res.success:
            self.toast("success", "Hunk staged")
            self._refresh_working_diff(tab, f.path, staged=False)
        else:
            self.toast("error", classify_git_error(res.stderr).message)

    def _act_unstage_hunk(self, arg, x, y):
        tab = self.current()
        got = self._hunk_at(arg)
        if tab is None or got is None:
            return
        f, hunk = got
        res = unstage_hunk(tab.active_repo(), f.path, hunk)
        if res.success:
            self.toast("success", "Hunk unstaged")
            self._refresh_working_diff(tab, f.path, staged=True)
        else:
            self.toast("error", classify_git_error(res.stderr).message)

    def _act_confirm_discard_hunk(self, arg, x, y):
        self.modal = ("confirm", dialogs.ConfirmState(
            action="discard-hunk", title="Discard hunk?",
            message="This permanently discards the hunk from the working "
                    "tree. This cannot be undone.",
            confirm_label="Discard", payload={"arg": arg}))

    def _refresh_working_diff(self, tab, path, staged):
        tab.trigger_status_refresh(self.proxy)
        try:
            self.diff_files = working_file_diff(tab.active_repo(), path,
                                                staged=staged)
            if not any(f.hunks for f in self.diff_files):
                self.diff_open = False
        except Exception:
            self.diff_open = False

    # -- remote ops ----------------------------------------------------------

    def _act_fetch(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "fetch_op"):
            return
        tab.fetch_op = TimedOp(fetch_async(self._wd(tab), self.proxy),
                               "Fetching", "Fetch")

    def _act_push(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "push_op"):
            return
        if not tab.remotes:
            self.modal = ("error", dialogs.ErrorState(
                "No remotes", "Add a remote before pushing."))
            return
        branch = tab.current_branch
        if branch is None:
            self.toast("error", "Cannot push a detached HEAD")
            return
        local = next((t for t in tab.branch_tips
                      if not t.is_remote and t.name == branch), None)
        opts = PushOptions(remote=tab.remotes[0], branch=branch,
                           set_upstream=(local is None
                                         or local.upstream is None))
        tab.push_op = TimedOp(
            push_with_options_async(self._wd(tab), opts, self.proxy),
            f"Pushing {branch}", "Push")

    def _act_force_push(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "push_op"):
            return
        branch = tab.current_branch or ""
        opts = PushOptions(remote=tab.remotes[0] if tab.remotes else "origin",
                           branch=branch, force_with_lease=True)
        tab.push_op = TimedOp(
            push_with_options_async(self._wd(tab), opts, self.proxy),
            f"Force-pushing {branch}", "Push")

    def _act_open_pull_dialog(self, arg, x, y):
        self.modal = ("pull", dialogs.PullForm())

    def _act_do_pull(self, arg, x, y):
        tab = self.current()
        kind_form = self.modal
        self.modal = None
        if tab is None or not self._slot_free(tab, "pull_op"):
            return
        rebase = bool(kind_form and isinstance(kind_form[1], dialogs.PullForm)
                      and kind_form[1].rebase)
        fn = pull_rebase_async if rebase else pull_async
        tab.pull_op = TimedOp(fn(self._wd(tab), self.proxy),
                              "Pulling" + (" (rebase)" if rebase else ""),
                              "Pull")

    def _act_toggle_pull_rebase(self, arg, x, y):
        if self.modal and self.modal[0] == "pull":
            self.modal[1].rebase = not self.modal[1].rebase

    # push options dialog
    def _act_open_push_dialog(self, arg, x, y):
        # Seed the remote from the repo: the form's 'origin' default
        # would push to a nonexistent remote in a single-remote repo
        # named anything else (and the radios only render with >1).
        tab = self.current()
        remote = "origin"
        if tab is not None and tab.remotes:
            remote = ("origin" if "origin" in tab.remotes
                      else tab.remotes[0])
        self.modal = ("push", dialogs.PushForm(remote=remote))

    def _act_push_remote(self, arg, x, y):
        if self.modal and self.modal[0] == "push":
            self.modal[1].remote = arg

    def _act_toggle_push_force(self, arg, x, y):
        if self.modal and self.modal[0] == "push":
            self.modal[1].force_with_lease = not self.modal[1].force_with_lease

    def _act_toggle_push_upstream(self, arg, x, y):
        if self.modal and self.modal[0] == "push":
            self.modal[1].set_upstream = not self.modal[1].set_upstream

    def _act_toggle_push_tags(self, arg, x, y):
        if self.modal and self.modal[0] == "push":
            self.modal[1].push_tags = not self.modal[1].push_tags

    def _act_do_push_options(self, arg, x, y):
        tab = self.current()
        form = self.modal[1] if self.modal else dialogs.PushForm()
        self.modal = None
        if tab is None or not self._slot_free(tab, "push_op"):
            return
        branch = tab.current_branch or ""
        opts = PushOptions(remote=form.remote, branch=branch,
                           force_with_lease=form.force_with_lease,
                           set_upstream=form.set_upstream,
                           push_tags=form.push_tags)
        tab.push_op = TimedOp(
            push_with_options_async(self._wd(tab), opts, self.proxy),
            f"Pushing {branch}", "Push")

    # -- merge / rebase ------------------------------------------------------

    def _act_open_merge_dialog(self, arg, x, y):
        self.modal = ("merge", dialogs.MergeForm(branch=arg))

    def _act_merge_strategy(self, arg, x, y):
        if self.modal and self.modal[0] == "merge":
            self.modal[1].strategy = arg

    def _act_do_merge(self, arg, x, y):
        tab = self.current()
        form = self.modal[1] if self.modal else None
        self.modal = None
        if tab is None or form is None or not self._slot_free(tab, "other_op"):
            return
        fn = {"default": merge_async, "no-ff": merge_no_ff_async,
              "ff-only": merge_ff_only_async,
              "squash": merge_squash_async}[form.strategy]
        tab.other_op = TimedOp(fn(self._wd(tab), form.branch, self.proxy),
                               f"Merging {form.branch}", "Merge")

    def _act_open_rebase_dialog(self, arg, x, y):
        self.modal = ("rebase", dialogs.RebaseForm(onto=arg))

    def _act_toggle_rebase_autostash(self, arg, x, y):
        if self.modal and self.modal[0] == "rebase":
            self.modal[1].autostash = not self.modal[1].autostash

    def _act_toggle_rebase_merges(self, arg, x, y):
        if self.modal and self.modal[0] == "rebase":
            self.modal[1].rebase_merges = not self.modal[1].rebase_merges

    def _act_do_rebase(self, arg, x, y):
        tab = self.current()
        form = self.modal[1] if self.modal else None
        self.modal = None
        if tab is None or form is None or not self._slot_free(tab, "other_op"):
            return
        opts = RebaseOptions(onto=form.onto, autostash=form.autostash,
                             rebase_merges=form.rebase_merges)
        tab.other_op = TimedOp(
            rebase_with_options_async(self._wd(tab), opts, self.proxy),
            f"Rebasing onto {form.onto}", "Rebase")

    # -- stash ---------------------------------------------------------------

    def _act_stash_push(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "other_op"):
            return
        tab.other_op = TimedOp(stash_push_async(self._wd(tab), None,
                                                self.proxy),
                               "Stashing changes", "Stash")

    def _act_stash_pop(self, arg, x, y):
        tab = self.current()
        if tab is None or not self._slot_free(tab, "other_op"):
            return
        tab.other_op = TimedOp(stash_pop_async(self._wd(tab), self.proxy),
                               "Popping stash", "Stash")

    # -- dialogs: open -------------------------------------------------------

    def _act_open_help(self, arg, x, y):
        self.modal = ("help", None)

    def _act_open_settings(self, arg, x, y):
        self.modal = ("settings", None)

    def _act_open_repo_dialog(self, arg, x, y):
        self.modal = ("open-repo", dialogs.OpenRepoForm())
        self.focused_input = "path"

    def _act_open_clone_dialog(self, arg, x, y):
        self.modal = ("clone", dialogs.CloneForm())
        self.focused_input = "url"

    def _act_open_token_dialog(self, arg, x, y):
        self.modal = ("token", dialogs.TokenForm(editing=arg == "edit"))
        self.focused_input = "token"

    def _act_open_branch_dialog(self, arg, x, y):
        self.modal = ("branch", dialogs.BranchForm(at_oid=arg or None))
        self.focused_input = "name"

    def _act_open_tag_dialog(self, arg, x, y):
        self.modal = ("tag", dialogs.TagForm(at_oid=arg or None))
        self.focused_input = "name"

    def _act_open_worktree_dialog(self, arg, x, y):
        self.modal = ("worktree", dialogs.WorktreeForm())
        self.focused_input = "branch"

    def _act_open_worktrees_manage(self, arg, x, y):
        self.modal = ("worktrees-manage", None)

    # -- dialogs: submit -----------------------------------------------------

    def _act_do_open_repo(self, arg, x, y):
        form = self.modal[1] if self.modal else None
        self.modal = None
        if form and form.path:
            self.open_repo(os.path.expanduser(form.path))

    def _act_do_clone(self, arg, x, y):
        form = self.modal[1] if self.modal else None
        if form is None or self.clone_rx is not None:
            return
        dest = os.path.expanduser(form.dest)
        self.clone_rx = clone_async(form.url, dest, self.proxy)
        self.toast("info", f"Cloning {form.url}…")

    def _act_do_save_token(self, arg, x, y):
        form = self.modal[1] if self.modal else None
        self.modal = None
        if form is None:
            return
        from ..services.token_store import set_token
        host = form.host or ("github.com" if form.provider == "github"
                             else "gitlab.com")
        if set_token(form.provider, host, form.token):
            if form.provider == "gitlab" and form.host:
                self.config.register_gitlab_host(form.host)
                self.config.save()
            self.toast("success", f"Token saved for {host}")
        else:
            self.toast("error", "Could not store token")

    def _act_token_provider(self, arg, x, y):
        if self.modal and self.modal[0] == "token":
            self.modal[1].provider = arg

    def _act_do_create_branch(self, arg, x, y):
        tab = self.current()
        form = self.modal[1] if self.modal else None
        self.modal = None
        if tab is None or form is None or not form.name:
            return
        rename_from = getattr(form, "rename_from", None)
        if rename_from:
            if rename_from != form.name and self.run_sync_op(
                    f"Rename {rename_from}",
                    lambda: grefs.rename_branch(tab.active_repo(),
                                                rename_from, form.name)):
                self.toast("success",
                           f"Renamed {rename_from} → {form.name}")
            return
        at = form.at_oid or tab.head_oid
        if self.run_sync_op(
                f"Create branch {form.name}",
                lambda: grefs.create_branch_at(tab.active_repo(), form.name,
                                               at)):
            self.toast("success", f"Created branch {form.name}")

    def _act_do_create_tag(self, arg, x, y):
        tab = self.current()
        form = self.modal[1] if self.modal else None
        self.modal = None
        if tab is None or form is None or not form.name:
            return
        at = form.at_oid or tab.head_oid
        if self.run_sync_op(
                f"Create tag {form.name}",
                lambda: grefs.create_tag_at(tab.active_repo(), form.name, at,
                                            form.message or None)):
            self.toast("success", f"Created tag {form.name}")

    def _act_do_create_worktree(self, arg, x, y):
        tab = self.current()
        form = self.modal[1] if self.modal else None
        self.modal = None
        if tab is None or form is None or not self._slot_free(tab, "other_op"):
            return
        path = os.path.expanduser(form.path)
        tab.other_op = TimedOp(
            create_worktree_with_post_steps_async(
                self._wd(tab), path, form.branch, self.proxy,
                base=form.base or None),
            f"Creating worktree {form.branch}", "Worktree")

    # -- settings toggles ----------------------------------------------------

    def _toggle_setting(self, attr):
        setattr(self.config, attr, not getattr(self.config, attr))
        self.config.save()

    def _sync_row_scale(self) -> None:
        """Propagate the Row Size setting (reference README.md:117) into
        every tab — including drilled-in submodule levels — rebuilding
        graph geometry when it changes. Lazy (checked each build) so
        clones/drill-downs opened after a toggle pick it up too."""
        want = 1.5 if self.config.row_size_large else 1.0
        for tab in self.tabs:
            for level in [tab, *getattr(tab, "nav_stack", ())]:
                if level.row_scale != want:
                    level.row_scale = want
                    level._rebuild_layout()

    def _act_toggle_avatars(self, arg, x, y):
        self._toggle_setting("show_avatars")

    def _act_toggle_scroll_speed(self, arg, x, y):
        self._toggle_setting("scroll_speed_fast")

    def _act_toggle_row_size(self, arg, x, y):
        self._toggle_setting("row_size_large")

    def _act_toggle_shortcut_bar(self, arg, x, y):
        self._toggle_setting("show_shortcut_bar")

    def _act_toggle_ai_taglines(self, arg, x, y):
        self._toggle_setting("ai_taglines")

    def _act_toggle_rewind(self, arg, x, y):
        self._toggle_setting("rewind_enabled")

    # -- Project Rewind (services/rewind.py) ---------------------------------

    def _rewind_log(self, tab):
        if tab.rewind_log is None:
            from ..services.rewind import RewindLog
            tab.rewind_log = RewindLog(tab.repo.common_dir
                                       or tab.repo.workdir or tab.title)
        return tab.rewind_log

    def _record_rewind(self, tab, label: str = "") -> None:
        try:
            from ..services.rewind import snapshot_of_tab
            snap = snapshot_of_tab(tab, label=label)
            if snap is not None:
                self._rewind_log(tab).record(snap)
        except Exception:
            pass  # snapshotting must never break the frame loop

    def _welcome_back(self, tab) -> None:
        """'Welcome back — here's where you left off': built from the
        last session's final Rewind snapshot when it's ≥30 min old."""
        try:
            snaps = self._rewind_log(tab).snapshots
        except Exception:
            return
        if not snaps:
            return
        last = snaps[-1]
        if time.time() - last.ts < 1800:
            return
        from ..gitcore.types import format_relative_time

        ago = format_relative_time(int(last.ts))
        where = last.branch or "(detached)"
        state = last.dirty_summary()
        label = f" — {last.label}" if last.label else ""
        self.toast("info",
                   f"Welcome back: {ago} you were on {where} "
                   f"({state}){label}")

    def _act_open_rewind(self, arg, x, y):
        tab = self.current()
        if tab is None:
            return
        from ..services.rewind import RewindState, snapshot_of_tab
        if self.config.rewind_enabled:
            self._record_rewind(tab)  # the timeline always ends at NOW
        snaps = list(self._rewind_log(tab).snapshots)
        if not self.config.rewind_enabled:
            # Recording is off, but the modal still labels its last entry
            # NOW and diffs against it — append an UNRECORDED in-memory
            # snapshot so "current state" is actually current, not the
            # last pre-toggle entry.
            try:
                now_snap = snapshot_of_tab(tab)
            except Exception:
                now_snap = None
            if now_snap is not None and (
                    not snaps or snaps[-1].fingerprint() !=
                    now_snap.fingerprint()):
                snaps.append(now_snap)
        self.modal = ("rewind", RewindState(
            snapshots=snaps, index=max(0, len(snaps) - 1)))

    def _act_rewind_scrub(self, arg, x, y):
        if self.modal is not None and self.modal[0] == "rewind":
            st = self.modal[1]
            st.index = max(0, min(int(arg), len(st.snapshots) - 1))
            st.show_commands = False

    def _act_rewind_step(self, arg, x, y):
        if self.modal is not None and self.modal[0] == "rewind":
            st = self.modal[1]
            st.index = max(0, min(st.index + int(arg),
                                  len(st.snapshots) - 1))
            st.show_commands = False

    def _act_rewind_commands(self, arg, x, y):
        if self.modal is not None and self.modal[0] == "rewind":
            self.modal[1].show_commands = not self.modal[1].show_commands

    def _act_rewind_copy(self, arg, x, y):
        if self.modal is None or self.modal[0] != "rewind":
            return
        from ..services.rewind import restore_commands
        st = self.modal[1]
        if not st.snapshots:
            return
        cmds = restore_commands(st.snapshots[st.index], st.snapshots[-1])
        self._set_clipboard("\n".join(cmds))
        self.toast("success", "Restore commands copied")

    def _act_toggle_diff_mode(self, arg, x, y):
        self.config.diff_mode = ("split" if self.config.diff_mode == "unified"
                                 else "unified")
        self.config.save()

    def _act_pane_resize(self, arg, x, y):
        """Resizable pane dividers (reference: resizable pane widths +
        drag state, ui_app.rs struct). arg: '<pane>:<delta>' (keyboard) or
        '<pane>:<dx>:<dy>' (Runner drag deltas)."""
        pane, _, rest = arg.partition(":")
        try:
            d = float(rest.split(":")[0])
        except (ValueError, IndexError):
            return
        attr = {"sidebar": "sidebar_width",
                "right": "right_panel_width"}.get(pane)
        if attr is None:
            return
        if pane == "right":
            d = -d  # dragging the right divider left widens the panel
        value = getattr(self.config, attr) + d
        setattr(self.config, attr, max(140.0, min(700.0, value)))
        self.config.save()

    def _act_scroll_drag(self, arg, x, y):
        """Scrollbar thumb drag (reference README: scrollbars with "drag
        support"). arg: '<which>:<dx>:<dy>' — dy in track pixels maps to
        content pixels by the track's content/track ratio."""
        tab = self.current()
        if tab is None:
            return
        parts = arg.split(":")
        if len(parts) < 3:
            return
        which = parts[0]
        try:
            dy = float(parts[2])
        except ValueError:
            return
        if which == "history":
            total = max(tab.graph_layout.total_height, 1.0)
            track = 600.0  # matches the thumb geometry in commit_graph
            tab.history_scroll = max(0.0, min(
                tab.history_scroll + dy * total / track,
                max(0.0, total - 200.0)))
        elif which == "sidebar":
            from .views.sidebar import item_h
            max_scroll = max(0.0, (len(self._sidebar_keys(tab)) + 7)
                             * item_h(tab) - 200.0)
            tab.sidebar_scroll = max(0.0, min(
                tab.sidebar_scroll + dy * 3.0, max_scroll))

    # -- context menus (reference: ui_app.rs:4546-4788) ----------------------

    def _act_menu_commit(self, arg, x, y):
        oid = arg
        self.context_menu = ContextMenuState(
            items=[
                MenuItem("Copy SHA", f"copy-sha:{oid}"),
                MenuItem("View Details", f"view-details:{oid}"),
                (MenuItem("Compare with anchor "
                          f"{self.current().range_anchor[:8]}",
                          f"compare-with-anchor:{oid}")
                 if self.current() is not None
                 and self.current().range_anchor
                 and self.current().range_anchor != oid else
                 MenuItem("Compare: set anchor here",
                          f"compare-set-anchor:{oid}")),
                MenuItem("Checkout (detached)", f"checkout-detached:{oid}",
                         separator_before=True),
                MenuItem("Create Branch here…", f"open-branch-dialog:{oid}"),
                MenuItem("Create Tag here…", f"open-tag-dialog:{oid}"),
                MenuItem("Cherry-pick", f"confirm-cherry-pick:{oid}",
                         separator_before=True),
                MenuItem("Interactive Rebase from here…",
                         f"open-rebase-interactive:{oid}"),
                MenuItem("Revert…", f"confirm-revert:{oid}"),
                MenuItem("Reset Soft here…", f"confirm-reset:soft:{oid}",
                         separator_before=True),
                MenuItem("Reset Mixed here…", f"confirm-reset:mixed:{oid}"),
                MenuItem("Reset Hard here…", f"confirm-reset:hard:{oid}",
                         destructive=True),
            ], x=x, y=y, target=f"commit:{oid}")

    def _act_menu_branch(self, arg, x, y):
        items = [
            MenuItem("Checkout", f"checkout-branch:{arg}"),
            MenuItem("Merge into Current…", f"open-merge-dialog:{arg}"),
            MenuItem("Rebase Current onto…", f"open-rebase-dialog:{arg}"),
            # "Compare with..." on branch labels
            # (design_feedback_feb2026.md:461-466).
            MenuItem("Compare with Current", f"compare-branch:{arg}"),
            # "Branch intent summarization" (:423) via the claude CLI.
            MenuItem("Summarize Intent (AI)", f"branch-intent:{arg}"),
        ]
        # PR integration (beyond-reference: Deferred in user_needs.md).
        tab = self.current()
        pr = tab.pr_by_branch.get(arg) if tab else None
        if pr is not None:
            items.append(MenuItem(
                f"Open Pull Request #{pr.number} ↗", f"open-url:{pr.url}",
                separator_before=True))
        elif tab is not None and tab.remote_urls:
            items.append(MenuItem("Create Pull Request… ↗",
                                  f"open-create-pr:{arg}",
                                  separator_before=True))
        items += [
            MenuItem("Rename…", f"open-rename-branch:{arg}",
                     separator_before=True),
            MenuItem("Delete", f"confirm-delete-branch:{arg}",
                     destructive=True),
        ]
        self.context_menu = ContextMenuState(
            items=items, x=x, y=y, target=f"branch:{arg}")

    def _act_menu_remote_branch(self, arg, x, y):
        self.context_menu = ContextMenuState(
            items=[
                MenuItem("Checkout as local branch", f"checkout-remote:{arg}"),
                MenuItem("Delete on remote", f"confirm-delete-remote:{arg}",
                         destructive=True),
            ], x=x, y=y, target=f"remote:{arg}")

    def _act_menu_tag(self, arg, x, y):
        self.context_menu = ContextMenuState(
            items=[
                MenuItem("Push tag", f"push-tag:{arg}"),
                MenuItem("Delete", f"confirm-delete-tag:{arg}",
                         destructive=True),
            ], x=x, y=y, target=f"tag:{arg}")

    def _act_menu_stash(self, arg, x, y):
        self.context_menu = ContextMenuState(
            items=[
                MenuItem("Apply", f"apply-stash:{arg}"),
                MenuItem("Pop", f"pop-stash:{arg}"),
                MenuItem("Drop", f"confirm-drop-stash:{arg}",
                         destructive=True),
            ], x=x, y=y, target=f"stash:{arg}")

    def _act_menu_worktree(self, arg, x, y):
        items = [
            MenuItem("Switch to", f"select-worktree:{arg}"),
            MenuItem("Open in Terminal", f"open-terminal:{arg}"),
        ]
        # reference README sidebar: worktree menu offers "Jump to Branch" —
        # select the worktree's HEAD commit in the history view.
        tab = self.current()
        if tab is not None:
            wt = next((w for w in tab.worktrees if w.name == arg), None)
            if wt is not None and wt.head_oid:
                items.append(MenuItem("Jump to Branch",
                                      f"jump-to:{wt.head_oid}"))
        items.append(MenuItem("Remove", f"confirm-remove-worktree:{arg}",
                              destructive=True))
        self.context_menu = ContextMenuState(
            items=items, x=x, y=y, target=f"worktree:{arg}")

    def _act_menu_submodule(self, arg, x, y):
        items = [
            MenuItem("Open", f"enter-submodule:{arg}"),
            MenuItem("Open in Terminal", f"open-terminal:{arg}"),
            MenuItem("Update (to expected commit)",
                     f"update-submodule:{arg}"),
        ]
        # Pin-drift operations (design_feedback_feb2026.md:469-474): only
        # offered when the workdir points somewhere else than the pin.
        tab = self.current()
        sub = next((s for s in (tab.submodules if tab else [])
                    if s.path == arg), None)
        if (sub is not None and sub.head_oid and sub.workdir_oid
                and sub.head_oid != sub.workdir_oid):
            items += [
                MenuItem("Show Diff from Expected",
                         f"submodule-drift-diff:{arg}",
                         separator_before=True),
                MenuItem("Stage Pointer Change",
                         f"stage-submodule-pointer:{arg}"),
            ]
        items.append(MenuItem("Remove", f"confirm-remove-submodule:{arg}",
                              destructive=True, separator_before=True))
        self.context_menu = ContextMenuState(
            items=items, x=x, y=y, target=f"submodule:{arg}")

    def _act_submodule_drift_diff(self, arg, x, y):
        """Combined diff inside the submodule between the pinned gitlink
        (expected) and its actual workdir HEAD."""
        import os as _os

        from ..gitcore.diff import range_diff
        from ..gitcore.repo import GitRepo

        tab = self.current()
        sub = next((s for s in (tab.submodules if tab else [])
                    if s.path == arg), None)
        if sub is None or not (sub.head_oid and sub.workdir_oid):
            return
        try:
            sub_repo = GitRepo.open(
                _os.path.join(tab.repo.workdir or "", arg))
            self.diff_files = range_diff(sub_repo, sub.head_oid,
                                         sub.workdir_oid)
        except Exception as exc:
            self.toast("error", f"Submodule diff failed: {exc}")
            return
        self.diff_source = "range"
        self.diff_title = (f"{sub.name}: {sub.head_oid[:8]} (expected) → "
                           f"{sub.workdir_oid[:8]} (actual)")
        self.diff_open = True

    def _act_stage_submodule_pointer(self, arg, x, y):
        """Stage the submodule's moved gitlink in the parent index."""
        from ..gitcore import status as gstatus

        tab = self.current()
        if tab is None:
            return
        self.run_sync_op(f"Stage {arg} pointer",
                         lambda: gstatus.stage_file(tab.repo, arg))

    def _act_menu_file(self, arg, x, y):
        bucket, _, path = arg.partition(":")
        items = [MenuItem("View Diff", f"view-file:{bucket}:{path}")]
        if bucket == "conflicted":
            # Conflict resolution (beyond-reference: deferred there).
            items += [
                MenuItem("Use Ours (current branch)",
                         f"resolve-conflict:ours:{path}"),
                MenuItem("Use Theirs (incoming)",
                         f"resolve-conflict:theirs:{path}"),
                MenuItem("Mark Resolved (stage as-is)",
                         f"resolve-conflict:add:{path}",
                         separator_before=True),
            ]
        elif bucket == "staged":
            items.append(MenuItem("Unstage", f"unstage-file:{path}"))
        else:
            items.append(MenuItem("Stage", f"stage-file:{path}"))
        if bucket != "conflicted":
            items.append(MenuItem("Discard", f"confirm-discard-file:{path}",
                                  destructive=True))
        self.context_menu = ContextMenuState(items=items, x=x, y=y,
                                             target=f"file:{path}")

    # -- in-progress op control (beyond-reference; reference shows the
    # MERGING/REBASING pill with no abort/continue) ---------------------------

    _STATE_OPS = {
        "Merging": ("merge", merge_abort_async, merge_continue_async),
        "Rebasing": ("rebase", rebase_abort_async, rebase_continue_async),
        "Rebasing (interactive)": ("rebase", rebase_abort_async,
                                   rebase_continue_async),
        "Cherry-picking": ("cherry-pick", cherry_pick_abort_async,
                           cherry_pick_continue_async),
        "Reverting": ("revert", revert_abort_async, revert_continue_async),
    }

    def _act_menu_repo_state(self, arg, x, y):
        tab = self.current()
        if tab is None or tab.repo_state not in self._STATE_OPS:
            return
        kind = self._STATE_OPS[tab.repo_state][0]
        self.context_menu = ContextMenuState(items=[
            MenuItem(f"Continue {kind}", "continue-op"),
            MenuItem(f"Abort {kind}", "abort-op", destructive=True,
                     separator_before=True),
        ], x=x, y=y, target="repo-state")

    def _op_control(self, which: str) -> None:
        tab = self.current()
        if tab is None or tab.repo_state not in self._STATE_OPS \
                or not self._slot_free(tab, "other_op"):
            return
        kind, abort_fn, cont_fn = self._STATE_OPS[tab.repo_state]
        fn = abort_fn if which == "abort" else cont_fn
        verb = "Aborting" if which == "abort" else "Continuing"
        tab.other_op = TimedOp(fn(self._wd(tab), self.proxy),
                               f"{verb} {kind}",
                               "Abort" if which == "abort" else "Continue")

    def _act_abort_op(self, arg, x, y):
        self._op_control("abort")

    def _act_continue_op(self, arg, x, y):
        self._op_control("continue")

    # -- interactive rebase (beyond-reference; Deferred in the reference's
    # user_needs.md) ----------------------------------------------------------

    def _act_open_rebase_interactive(self, arg, x, y):
        tab = self.current()
        if tab is None or not arg:
            return
        self.context_menu = None
        try:
            plan = grefs.rebase_plan(tab.active_repo(), arg)
        except Exception as exc:
            self.toast("error", f"Rebase plan failed: {exc}")
            return
        if not plan:
            self.toast("info", "No commits to rebase from there")
            return
        entries = [dialogs.RebaseIEntry("pick", oid, subj)
                   for oid, subj in plan]
        self.modal = ("rebase-i",
                      dialogs.RebaseIForm(onto=arg, entries=entries))

    def _act_rebase_i_action(self, arg, x, y):
        """Cycle one todo row: pick → squash → fixup → drop → pick."""
        if not (self.modal and self.modal[0] == "rebase-i"):
            return
        form = self.modal[1]
        try:
            i = int(arg)
        except ValueError:
            return
        if not 0 <= i < len(form.entries):
            return
        cycle = ["pick", "squash", "fixup", "drop"]
        e = form.entries[i]
        e.action = cycle[(cycle.index(e.action) + 1) % len(cycle)]

    def _act_rebase_i_move(self, arg, x, y):
        """Reorder one todo row. arg: '<index>:<±1>'."""
        if not (self.modal and self.modal[0] == "rebase-i"):
            return
        form = self.modal[1]
        try:
            i_s, _, d_s = arg.partition(":")
            i, d = int(i_s), int(d_s)
        except ValueError:
            return
        j = i + d
        if not (0 <= i < len(form.entries) and 0 <= j < len(form.entries)):
            return
        form.entries[i], form.entries[j] = form.entries[j], form.entries[i]

    def _act_do_rebase_i(self, arg, x, y):
        tab = self.current()
        if tab is None or not (self.modal and self.modal[0] == "rebase-i"):
            return
        form = self.modal[1]
        kept = [e for e in form.entries if e.action != "drop"]
        if not kept or kept[0].action != "pick":
            self.toast("error",
                       "The first kept commit must be a pick")
            return
        if not self._slot_free(tab, "other_op"):
            return
        self.modal = None
        todo = [f"{e.action} {e.oid} {e.subject}"
                for e in form.entries if e.action != "drop"]
        tab.other_op = TimedOp(
            interactive_rebase_async(self._wd(tab), form.onto, todo,
                                     self.proxy),
            f"Interactive rebase ({len(todo)} commits)", "Rebase")

    def _act_resolve_conflict(self, arg, x, y):
        """arg: '<ours|theirs|add>:<path>' — resolve a conflicted file."""
        side, _, path = arg.partition(":")
        tab = self.current()
        if tab is None or not path:
            return
        if side == "add":
            ok = self.run_sync_op(
                f"Mark {path} resolved",
                lambda: gstatus.stage_file(tab.active_repo(), path))
        else:
            ok = self.run_sync_op(
                f"Resolve {path}",
                lambda: grefs.resolve_conflict_side(tab.active_repo(),
                                                    path, side))
        if ok:
            label = {"add": "staged as-is", "ours": "took ours",
                     "theirs": "took theirs"}[side]
            self.toast("success", f"Resolved {path} ({label})")

    # -- confirms (reference: ConfirmAction, ui_app.rs:170-209) --------------

    def _confirm(self, action: str, title: str, message: str,
                 label: str = "Confirm", **payload):
        self.context_menu = None
        self.modal = ("confirm", dialogs.ConfirmState(
            action=action, title=title, message=message,
            confirm_label=label, payload=payload))

    def _act_confirm_cherry_pick(self, arg, x, y):
        self._confirm("cherry-pick", "Cherry-pick commit?",
                      f"Apply commit {arg[:8]} onto the current branch.",
                      "Cherry-pick", oid=arg)

    def _act_confirm_revert(self, arg, x, y):
        self._confirm("revert", "Revert commit?",
                      f"Create a new commit reverting {arg[:8]}.",
                      "Revert", oid=arg)

    def _act_confirm_reset(self, arg, x, y):
        mode, _, oid = arg.partition(":")
        warnings = {
            "soft": "Moves HEAD; index and working tree are kept.",
            "mixed": "Moves HEAD and resets the index; files are kept.",
            "hard": "DESTROYS all uncommitted changes. This cannot be "
                    "undone.",
        }
        self._confirm("reset", f"Reset ({mode}) to {oid[:8]}?",
                      warnings[mode], f"Reset {mode}", mode=mode, oid=oid)

    def _act_confirm_delete_branch(self, arg, x, y):
        self._confirm("delete-branch", "Delete branch?",
                      f"Delete local branch {arg!r}.", "Delete", name=arg)

    def _act_confirm_delete_remote(self, arg, x, y):
        self._confirm("delete-remote-branch", "Delete remote branch?",
                      f"Delete {arg!r} on the remote. This affects everyone "
                      "using the remote.", "Delete", name=arg)

    def _act_confirm_delete_tag(self, arg, x, y):
        self._confirm("delete-tag", "Delete tag?",
                      f"Delete tag {arg!r} locally.", "Delete", name=arg)

    def _act_confirm_drop_stash(self, arg, x, y):
        self._confirm("drop-stash", "Drop stash?",
                      f"Permanently delete {arg}.", "Drop", ref=arg)

    def _act_confirm_remove_worktree(self, arg, x, y):
        self._confirm("remove-worktree", "Remove worktree?",
                      f"Remove the worktree at {arg}. Uncommitted changes "
                      "there will be lost.", "Remove", path=arg)

    def _act_confirm_remove_submodule(self, arg, x, y):
        self._confirm("remove-submodule", "Remove submodule?",
                      f"Deinit and remove submodule {arg!r}.", "Remove",
                      path=arg)

    def _act_confirm_discard_file(self, arg, x, y):
        self._confirm("discard-file", "Discard changes?",
                      f"Discard all changes to {arg!r}. This cannot be "
                      "undone.", "Discard", path=arg)

    def _act_do_confirm(self, arg, x, y):
        if self.modal is None or self.modal[0] != "confirm":
            return
        state = self.modal[1]
        self.modal = None
        tab = self.current()
        if tab is None:
            return
        p = state.payload
        wd = self._wd(tab)
        if state.action == "cherry-pick" and self._slot_free(tab, "other_op"):
            tab.other_op = TimedOp(cherry_pick_async(wd, p["oid"], self.proxy),
                                   f"Cherry-picking {p['oid'][:8]}",
                                   "Cherry-pick")
        elif state.action == "revert" and self._slot_free(tab, "other_op"):
            tab.other_op = TimedOp(revert_async(wd, p["oid"], self.proxy),
                                   f"Reverting {p['oid'][:8]}", "Revert")
        elif state.action == "reset":
            if self.run_sync_op(
                    f"Reset {p['mode']}",
                    lambda: grefs.reset(tab.active_repo(), p["oid"],
                                        p["mode"])):
                self.toast("success", f"Reset ({p['mode']}) to "
                           f"{p['oid'][:8]}")
        elif state.action == "delete-branch":
            if self.run_sync_op(
                    f"Delete {p['name']}",
                    lambda: grefs.delete_branch(tab.active_repo(), p["name"],
                                                force=True)):
                self.toast("success", f"Deleted branch {p['name']}")
        elif state.action == "delete-remote-branch":
            from ..engine.async_ops import delete_remote_branch_async
            remote, _, branch = p["name"].partition("/")
            if self._slot_free(tab, "other_op"):
                tab.other_op = TimedOp(
                    delete_remote_branch_async(wd, remote, branch,
                                               self.proxy),
                    f"Deleting {p['name']}", "Delete")
        elif state.action == "delete-tag":
            if self.run_sync_op(
                    f"Delete tag {p['name']}",
                    lambda: grefs.delete_tag(tab.active_repo(), p["name"])):
                self.toast("success", f"Deleted tag {p['name']}")
        elif state.action == "drop-stash" and self._slot_free(tab, "other_op"):
            tab.other_op = TimedOp(stash_drop_async(wd, p["ref"], self.proxy),
                                   f"Dropping {p['ref']}", "Stash")
        elif state.action == "remove-worktree" and self._slot_free(tab,
                                                                   "other_op"):
            tab.other_op = TimedOp(
                worktree_remove_async(wd, p["path"], force=True,
                                      proxy=self.proxy),
                "Removing worktree", "Worktree")
        elif state.action == "remove-submodule" and self._slot_free(
                tab, "other_op"):
            tab.other_op = TimedOp(
                remove_submodule_async(wd, p["path"], self.proxy),
                f"Removing submodule {p['path']}", "Submodule")
        elif state.action == "discard-file":
            if self.run_sync_op(
                    f"Discard {p['path']}",
                    lambda: grefs.discard_file(tab.active_repo(), p["path"])):
                self.toast("success", f"Discarded {p['path']}")
        elif state.action == "discard-hunk":
            got = self._hunk_at(p["arg"])
            if got is not None:
                f, hunk = got
                res = discard_hunk(tab.active_repo(), f.path, hunk)
                if res.success:
                    self.toast("success", "Hunk discarded")
                    self._refresh_working_diff(tab, f.path, staged=False)
                else:
                    self.toast("error",
                               classify_git_error(res.stderr).message)
        elif state.action == "force-push":
            self._act_force_push("", 0, 0)

    # -- misc menu follow-ups ------------------------------------------------

    def _act_checkout_detached(self, arg, x, y):
        tab = self.current()
        if tab and self.run_sync_op(
                f"Checkout {arg[:8]}",
                lambda: grefs.checkout_detached(tab.active_repo(), arg)):
            self.toast("success", f"Checked out {arg[:8]} (detached)")

    def _act_pop_stash(self, arg, x, y):
        tab = self.current()
        self.context_menu = None
        if tab and self._slot_free(tab, "other_op"):
            from ..engine.async_ops import stash_pop_index_async
            tab.other_op = TimedOp(
                stash_pop_index_async(self._wd(tab), arg, self.proxy),
                f"Popping {arg}", "Stash")

    def _act_push_tag(self, arg, x, y):
        tab = self.current()
        self.context_menu = None
        if tab and tab.remotes and self._slot_free(tab, "other_op"):
            from ..engine.async_ops import push_refspec_async
            tab.other_op = TimedOp(
                push_refspec_async(self._wd(tab), tab.remotes[0],
                                   f"refs/tags/{arg}", self.proxy),
                f"Pushing tag {arg}", "Push")

    def _act_update_submodule(self, arg, x, y):
        tab = self.current()
        self.context_menu = None
        if tab and self._slot_free(tab, "other_op"):
            from ..engine.async_ops import submodule_update_async
            tab.other_op = TimedOp(
                submodule_update_async(self._wd(tab), arg, self.proxy),
                f"Updating submodule {arg}", "Submodule")

    def _act_open_terminal(self, arg, x, y):
        self.context_menu = None
        import subprocess
        full = arg
        tab = self.current()
        if tab and tab.repo.workdir and not os.path.isabs(arg):
            full = os.path.join(tab.repo.workdir, arg)
        for term in (["x-terminal-emulator"], ["gnome-terminal"],
                     ["konsole"], ["xterm"]):
            try:
                subprocess.Popen(term, cwd=full,
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
                return
            except OSError:
                continue
        self.toast("error", "No terminal emulator found")

    def _act_open_url(self, arg, x, y):
        """Open a forge URL in the default browser (PR integration)."""
        self.context_menu = None
        if not (arg.startswith("https://") or arg.startswith("http://")):
            return
        import subprocess
        for opener in (["xdg-open"], ["open"]):
            try:
                subprocess.Popen(opener + [arg],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.DEVNULL)
                self.toast("info", "Opened in browser")
                return
            except OSError:
                continue
        self.toast("error", "No browser opener found (xdg-open)")

    def _act_open_create_pr(self, arg, x, y):
        """Open the forge's new-PR/new-MR page for branch `arg`."""
        self.context_menu = None
        tab = self.current()
        if tab is None:
            return
        from ..services.pr import create_pr_url
        for url in tab.remote_urls.values():
            target = create_pr_url(url, arg,
                                   known_gitlab_hosts=self.config.gitlab_hosts)
            if target:
                self.handle_action(f"open-url:{target}")
                return
        self.toast("error", "No GitHub/GitLab remote found")

    def _act_open_rename_branch(self, arg, x, y):
        self.context_menu = None
        form = dialogs.BranchForm(name=arg)
        form.at_oid = None
        self.modal = ("branch", form)
        # Reuse the branch dialog; submit routes to rename when the name
        # differs from the original — tracked via payload on the form.
        form.rename_from = arg  # type: ignore[attr-defined]
        self.focused_input = "name"

    # ========================================================================
    # Poll loop (reference: poll_async_ops, ui_app.rs:3069-3650).
    # ========================================================================

    def poll_async_ops(self) -> None:
        now = time.monotonic()
        for tab in self.tabs:
            # Poll the visible level AND every drilled-in ancestor level —
            # their in-flight ops keep completing while you're inside a
            # submodule (reference: poll_async_ops drains slots for every
            # drilled level, ui_app.rs:3069).
            self._poll_tab(tab, now)
            for ancestor in tab.nav_stack:
                self._poll_tab(ancestor, now)
        self._poll_clone()
        self._poll_dirty_checks()

    def _poll_tab(self, tab: RepoTab, now: float) -> None:
        self._poll_op_slots(tab)
        self._poll_state_refresh(tab)
        self._poll_status_refresh(tab)
        self._poll_watcher(tab)
        self._poll_safety_nets(tab, now)
        self._poll_ci(tab, now)
        self._poll_taglines(tab)

    def _poll_op_slots(self, tab: RepoTab) -> None:
        for slot in ("fetch_op", "push_op", "pull_op", "other_op"):
            op: Optional[TimedOp] = getattr(tab, slot)
            if op is None:
                continue
            try:
                result = op.rx.get_nowait()
            except queue.Empty:
                continue
            setattr(tab, slot, None)
            tab.reopen_repo_handles()
            tab.trigger_state_refresh(self.proxy)
            tab.trigger_status_refresh(self.proxy)
            if result.success:
                msg = op.label.replace("ing", "ed", 1) if "ing" in op.label \
                    else f"{op.label} done"
                if result.stderr.strip():
                    self.toast("info", f"{msg} — {result.stderr.strip()[:80]}")
                else:
                    self.toast("success", msg)
                if slot == "push_op":
                    tab.last_push_time = time.monotonic()
                    tab.last_ci_fetch = 0.0  # immediate CI fetch
                if slot in ("fetch_op", "pull_op"):
                    tab.last_fetch_time = time.monotonic()
                # Label the next Rewind snapshot with the completed op
                # (only while Rewind records — a label set while disabled
                # would attach to an unrelated state after re-enabling).
                if self.config.rewind_enabled:
                    tab.pending_rewind_label = f"after {msg.lower()}"
            else:
                err = classify_git_error(result.stderr)
                if err.retryable and slot == "push_op":
                    self.modal = ("confirm", dialogs.ConfirmState(
                        action="force-push", title="Push rejected",
                        message=err.message,
                        confirm_label="Force push (with lease)"))
                else:
                    self.modal = ("error", dialogs.ErrorState(
                        f"{op.verb or 'Operation'} failed", err.message))
        # Branch-intent receiver (design_feedback_feb2026.md:423).
        if tab.intent_rx is not None:
            branch, rx = tab.intent_rx
            try:
                payload = rx.get_nowait()
            except queue.Empty:
                payload = None
            if payload is not None:
                tab.intent_rx = None
                if payload.get("empty"):
                    self.toast("info",
                               f"{branch} has no commits of its own")
                elif payload.get("ok"):
                    if self.modal is None:
                        self.modal = ("info", dialogs.ErrorState(
                            f"Branch intent: {branch}",
                            payload["summary"]))
                    else:
                        # The result lands at an arbitrary later moment —
                        # never clobber a form the user is filling in.
                        self.toast("info",
                                   f"{branch}: "
                                   f"{payload['summary'][:120]}")
                else:
                    self.toast("error",
                               f"Intent summary failed: "
                               f"{payload.get('error', 'unknown')[:80]}")
        # AI slot (separate payload type).
        if tab.ai_op is not None:
            try:
                payload = tab.ai_op.rx.get_nowait()
            except queue.Empty:
                payload = None
            if payload is not None:
                tab.ai_op = None
                view = tab.active_view()
                if payload.get("ok") and view is not None:
                    view.draft_subject = payload.get("subject", "")
                    view.draft_body = payload.get("body", "")
                    self.toast("success", "Commit message generated")
                else:
                    self.toast("error",
                               payload.get("error", "AI generation failed"))

    def _poll_taglines(self, tab: RepoTab) -> None:
        """AI worktree taglines (user_needs.md 'LLM-Generated
        Descriptions'): drain finished generations, then spawn one per
        dirty worktree whose file-set fingerprint changed."""
        still = []
        landed = False
        for path, fp, rx in tab.tagline_rx:
            try:
                payload = rx.get_nowait()
            except queue.Empty:
                still.append((path, fp, rx))
                continue
            if payload.get("ok"):
                tab.worktree_taglines[path] = payload["tagline"]
                landed = True
            # On error the stamp stays — no retry loop for the same state.
        tab.tagline_rx = still
        if landed:
            tab.rebuild_synthetics()
        if not self.config.ai_taglines:
            return
        from ..services import ai
        inflight = {p for p, _, _ in tab.tagline_rx}
        for path, view in tab.worktree_views.items():
            dirty = view.dirty or (view.status is not None
                                   and not view.status.is_clean())
            if not dirty:
                # Clean again: drop the stale tagline (its synthetic row
                # is gone anyway) so re-dirtying regenerates.
                tab.worktree_taglines.pop(path, None)
                tab.tagline_stamps.pop(path, None)
                continue
            if path in inflight:
                continue
            fp = tab.status_fingerprint(path)
            if not fp or tab.tagline_stamps.get(path) == fp:
                continue
            tab.tagline_stamps[path] = fp
            rx = ai.spawn_tagline_async(path, self.proxy)
            if rx is not None:
                tab.tagline_rx.append((path, fp, rx))

    def _poll_state_refresh(self, tab: RepoTab) -> None:
        if tab.state_refresh_rx is None:
            return
        try:
            result = tab.state_refresh_rx.get_nowait()
        except queue.Empty:
            return
        # Invariant #5: stale-result rejection by tab_id.
        if result.tab_id != tab.tab_id:
            tab.state_refresh_rx = None
            return
        effects = tab.apply_state_result(result)
        for err in effects.toast_errors:
            self.toast("error", err[:120])
        if effects.fetch_diff_stats:
            self._trigger_diff_stats(tab)
        if effects.spawn_dirty_checks:
            spawn_dirty_checks(
                tab.repo, tab.tab_id,
                [s.path for s in tab.submodules],
                [wt.path for wt in tab.worktrees if not wt.is_main],
                self.dirty_q, self.proxy)
        if effects.update_watcher_paths and tab.watcher is not None:
            tab.watcher.update_worktree_watches(
                [wt.path for wt in tab.worktrees if not wt.is_main])
            if tab.repo.workdir:
                tab.watcher.update_submodule_paths(
                    [os.path.join(tab.repo.workdir, s.path)
                     for s in tab.submodules])
        tab.trigger_watcher_init(self.proxy)

    def _poll_status_refresh(self, tab: RepoTab) -> None:
        if tab.status_rx is not None:
            try:
                result = tab.status_rx.get_nowait()
            except queue.Empty:
                return
            if result.tab_id != tab.tab_id:
                tab.status_rx = None
                return
            tab.apply_status_result(result)
            # Invariant: events arriving mid-scan trigger a replay.
            if tab.status_dirty:
                tab.status_dirty = False
                tab.trigger_status_refresh(self.proxy)

    def _poll_watcher(self, tab: RepoTab) -> None:
        if tab.watcher_init_rx is not None:
            try:
                tab.watcher = tab.watcher_init_rx.get_nowait()
                tab.watcher_init_rx = None
            except queue.Empty:
                pass
        # Drain all pending events, keep the max priority (coalescing —
        # reference: dispatch_watcher_events_at, ui_app.rs:3379).
        best: Optional[FsChangeKind] = None
        while True:
            try:
                kind = tab.watcher_events_q.get_nowait()
            except queue.Empty:
                break
            if best is None or kind > best:
                best = kind
        if best is None:
            return
        if best is FsChangeKind.WORKING_TREE:
            tab.trigger_status_refresh(self.proxy)
            spawn_dirty_checks(
                tab.repo, tab.tab_id, [],
                [wt.path for wt in tab.worktrees if not wt.is_main],
                self.dirty_q, self.proxy)
        else:
            # GitMetadata / WorktreeStructure → reopen + heavy refresh
            # (invariant #7 + #2).
            tab.reopen_repo_handles()
            tab.trigger_state_refresh(self.proxy)
            tab.trigger_status_refresh(self.proxy)

    def _poll_safety_nets(self, tab: RepoTab, now: float) -> None:
        # 30 s status safety net (invariant #9).
        if (tab.initial_refresh_done
                and now - tab.last_status_query > STATUS_SAFETY_NET_SECS):
            tab.trigger_status_refresh(self.proxy)
        # 5 s ref-fingerprint reconciliation (invariant #8) — cheap, runs on
        # the frame thread like the reference (~0.5 ms).
        if (tab.initial_refresh_done
                and now - tab.last_fingerprint_check > FINGERPRINT_INTERVAL_SECS):
            tab.last_fingerprint_check = now
            try:
                from ..gitcore.repo import ref_fingerprint
                with span("fingerprint"):
                    fp = ref_fingerprint(tab.repo.git_dir,
                                         tab.repo.common_dir)
            except Exception:
                return
            if tab.last_fingerprint and fp != tab.last_fingerprint:
                tab.reopen_repo_handles()
                tab.trigger_state_refresh(self.proxy)
            tab.last_fingerprint = fp
        # Project Rewind cadence: snapshot the already-refreshed in-memory
        # state (zero extra git work). A pending op label records as soon
        # as the post-op refreshes have settled, so "after pull" captures
        # the settled state, not the mid-refresh one.
        if self.config.rewind_enabled and tab.initial_refresh_done:
            settled = (tab.state_refresh_rx is None
                       and tab.status_rx is None)
            from ..services.rewind import CADENCE_SECS
            if tab.pending_rewind_label and settled:
                self._record_rewind(tab, label=tab.pending_rewind_label)
                tab.pending_rewind_label = ""
                tab.last_rewind = now
            elif settled and now - tab.last_rewind > CADENCE_SECS:
                # `settled` also gates the cadence: a refresh in flight
                # could pair a new HEAD with the previous status lists —
                # a state that never existed. Retry next poll instead.
                if tab.last_rewind == 0.0:
                    # First snapshot of this session: before taking it,
                    # say where the user left off (context restoration,
                    # design_feedback_feb2026.md:428 — deterministic from
                    # the Rewind log, no LLM round-trip needed).
                    self._welcome_back(tab)
                tab.last_rewind = now
                self._record_rewind(tab)
        # Diff-stats drain.
        if tab.diff_stats_rx is not None:
            try:
                stats = tab.diff_stats_rx.get_nowait()
                tab.diff_stats_rx = None
                tab.apply_diff_stats(stats)
            except queue.Empty:
                pass

    def _trigger_diff_stats(self, tab: RepoTab) -> None:
        """Chunked diff-stat worker (reference: compute_diff_stats_async,
        git/mod.rs:783)."""
        if tab.diff_stats_rx is not None:
            return
        need = [c.oid for c in tab.commits
                if not c.is_synthetic and c.additions is None][:500]
        if not need:
            return
        import threading

        rx: queue.Queue = queue.Queue(maxsize=1)

        def worker():
            with span("diff_stats"):
                try:
                    stats = tab.repo.diff_stats_for_commits(need)
                except Exception:
                    stats = {}
            rx.put(stats)
            if self.proxy:
                self.proxy.send_event()

        COUNTERS["diff_stats.starts"] += 1
        threading.Thread(target=worker, daemon=True,
                         name="diff-stats").start()
        tab.diff_stats_rx = rx

    def _poll_ci(self, tab: RepoTab, now: float) -> None:
        try:
            from ..services import ci_poll
        except ImportError:
            return
        ci_poll.poll(self, tab, now)

    def _poll_clone(self) -> None:
        if self.clone_rx is None:
            return
        try:
            result = self.clone_rx.get_nowait()
        except queue.Empty:
            return
        self.clone_rx = None
        if result.success:
            self.modal = None
            self.open_repo(result.stdout)
        else:
            self.modal = ("error", dialogs.ErrorState(
                "Clone failed", classify_git_error(result.stderr).message))

    def _poll_dirty_checks(self) -> None:
        """Global dirty-check queue routed by tab_id; results for closed
        tabs drop silently (invariant #5; reference: ui_app.rs:3503)."""
        live = {t.tab_id: t for t in self.tabs}
        for t in self.tabs:
            for anc in t.nav_stack:
                live[anc.tab_id] = anc
        while True:
            try:
                result = self.dirty_q.get_nowait()
            except queue.Empty:
                return
            tab = live.get(result.tab_id)
            if tab is None or result.error:
                continue
            tab.apply_dirty_check_result(result.kind, result.key,
                                         result.dirty)

    # ========================================================================
    # Keyboard (reference README keyboard map).
    # ========================================================================

    def _input_read(self) -> Optional[str]:
        """Current text of the focused input, or None when nothing
        editable is focused."""
        tab = self.current()
        if self.focused_input in ("subject", "body") and tab is not None:
            view = tab.active_view()
            if view is None:
                return None
            return getattr(view, "draft_subject"
                           if self.focused_input == "subject"
                           else "draft_body")
        if self.focused_input == "search" and tab is not None:
            return tab.search_query
        if self.modal is not None and self.modal[1] is not None \
                and self.focused_input \
                and hasattr(self.modal[1], self.focused_input):
            value = getattr(self.modal[1], self.focused_input)
            return value if isinstance(value, str) else None
        return None

    def _input_write(self, s: str) -> None:
        tab = self.current()
        if self.focused_input in ("subject", "body") and tab is not None:
            view = tab.active_view()
            if view is not None:
                setattr(view, "draft_subject"
                        if self.focused_input == "subject"
                        else "draft_body", s)
        elif self.focused_input == "search" and tab is not None:
            tab.search_query = s
        elif self.modal is not None and self.modal[1] is not None \
                and hasattr(self.modal[1], self.focused_input):
            setattr(self.modal[1], self.focused_input, s)

    def _caret(self, value: str) -> int:
        return (len(value) if self.input_cursor is None
                else max(0, min(self.input_cursor, len(value))))

    def _selection_span(self, value: str):
        """(lo, hi) of the active selection in the focused input, or None.
        The selection spans anchor↔caret (reference text inputs:
        shift-arrow selection, src/host.rs keyboard handling)."""
        if self.input_anchor is None:
            return None
        a = max(0, min(self.input_anchor, len(value)))
        c = self._caret(value)
        if a == c:
            return None
        return (min(a, c), max(a, c))

    def _delete_selection(self, value: str):
        """Remove the selected span; returns the new value (caller writes)
        or None when no selection was active."""
        span = self._selection_span(value)
        if span is None:
            return None
        lo, hi = span
        self.input_anchor = None
        self.input_cursor = lo if lo < len(value) - (hi - lo) else None
        return value[:lo] + value[hi:]

    def on_text(self, s: str) -> None:
        """Printable text inserts at the caret in the focused input;
        typing over a selection replaces it. A combining mark (terminal
        IME / dead-key input) composes with the character before the
        caret (NFC), so multi-byte and combining input edit correctly."""
        if not self.focused_input:
            return
        value = self._input_read()
        if value is None:
            return
        replaced = self._delete_selection(value)
        if replaced is not None:
            value = replaced
        c = self._caret(value)
        import unicodedata

        if s and c > 0 and unicodedata.combining(s[0]):
            composed = unicodedata.normalize("NFC", value[c - 1] + s)
            new = value[:c - 1] + composed + value[c:]
            new_caret = c - 1 + len(composed)
        else:
            new = value[:c] + s + value[c:]
            new_caret = c + len(s)
        self._input_write(new)
        if self.input_cursor is not None:
            self.input_cursor = new_caret

    def on_paste(self, s: str) -> None:
        """Bracketed paste into the focused input. Single-line inputs
        flatten newlines to spaces; the commit body keeps them."""
        s = s.replace("\r\n", "\n").replace("\r", "\n")
        if self.palette is not None:
            self.palette.query += " ".join(
                part for part in s.split("\n") if part)
            self.palette.selected = 0
            return
        if not self.focused_input:
            return
        if self.focused_input != "body":
            s = " ".join(part for part in s.split("\n") if part)
        self.on_text(s)

    def _backspace(self) -> None:
        value = self._input_read()
        if value is None:
            return
        replaced = self._delete_selection(value)
        if replaced is not None:
            self._input_write(replaced)
            return
        c = self._caret(value)
        if c == 0:
            return
        self._input_write(value[:c - 1] + value[c:])
        if self.input_cursor is not None:
            self.input_cursor = c - 1

    def _input_edit_key(self, key: str, shift: bool = False) -> bool:
        """Caret movement / deletion inside the focused input (reference
        text inputs support full cursor editing; shift extends the
        selection). Returns True when the key was consumed."""
        value = self._input_read()
        if value is None:
            return False
        if key in ("Left", "Right", "Home", "End"):
            if shift:
                if self.input_anchor is None:
                    self.input_anchor = self._caret(value)
            else:
                self.input_anchor = None
        if key == "Left":
            self.input_cursor = max(0, self._caret(value) - 1)
            return True
        if key == "Right":
            if self.input_cursor is not None:
                c = self.input_cursor + 1
                self.input_cursor = None if c >= len(value) else c
            return True
        if key == "Home":
            self.input_cursor = 0
            return True
        if key == "End":
            self.input_cursor = None
            return True
        if key == "Delete":
            replaced = self._delete_selection(value)
            if replaced is not None:
                self._input_write(replaced)
                return True
            c = self._caret(value)
            if c < len(value):
                self._input_write(value[:c] + value[c + 1:])
            return True
        return False

    def on_key(self, key: str, ctrl: bool = False, shift: bool = False
               ) -> None:
        tab = self.current()
        # Escape ladder: palette → menu → modal → picker → search → diff →
        # details.
        if key == "Escape":
            if self.palette is not None:
                self.palette = None
            elif self.context_menu is not None:
                self.context_menu = None
            elif self.modal is not None:
                self.modal = None
                # Same as _act_close_modal: a stale focused_input would
                # keep _typing() true with no modal — every printable
                # key (j/k, '/', Ctrl+S) silently swallowed after.
                self.focused_input = ""
            elif self.worktree_picker_open:
                self.worktree_picker_open = False
            elif tab is not None and tab.search_active:
                tab.search_active = False
                tab.search_query = ""
                self.focused_input = ""
            elif self.diff_open:
                self.diff_open = False
            elif tab is not None and (tab.compare_range
                                      or tab.range_anchor):
                tab.compare_range = None
                tab.compare_set = frozenset()
                tab.range_anchor = None
            elif tab is not None and tab.selected_oid:
                tab.select_commit(None)
            else:
                self.quit_requested = True
            return
        # Command palette captures all input while open (topmost surface).
        if self.palette is not None:
            self._palette_key(key, ctrl)
            return
        if ctrl and key.lower() in ("p", "k") and self.modal is None:
            self.palette = PaletteState(commands=build_commands(self))
            return
        if key == "Backspace":
            self._backspace()
            return
        if key == "Enter" and self.modal is not None:
            kind = self.modal[0]
            submit = {"open-repo": "do-open-repo", "clone": "do-clone",
                      "branch": "do-create-branch", "tag": "do-create-tag",
                      "confirm": "do-confirm", "token": "do-save-token",
                      "worktree": "do-create-worktree",
                      "pull": "do-pull", "merge": "do-merge",
                      "rebase": "do-rebase", "rebase-i": "do-rebase-i",
                      "push": "do-push-options"}
            if kind in submit:
                self.handle_action(submit[kind])
            return
        # Rewind timeline scrubbing (←/→ while the modal is open).
        if self.modal is not None and self.modal[0] == "rewind":
            if key == "Left":
                self._act_rewind_step("-1", 0, 0)
            elif key == "Right":
                self._act_rewind_step("1", 0, 0)
            return
        # Context-menu keyboard nav.
        if self.context_menu is not None:
            menu = self.context_menu
            if key in ("j", "Down"):
                menu.selected_index = min(menu.selected_index + 1,
                                          len(menu.items) - 1)
            elif key in ("k", "Up"):
                menu.selected_index = max(menu.selected_index - 1, 0)
            elif key in ("Enter", " "):
                route = menu.items[menu.selected_index].route
                self.context_menu = None
                self.handle_action(route)
            return
        # Global chords.
        if ctrl and key.lower() == "o":
            self._act_open_repo_dialog("", 0, 0)
            return
        if ctrl and key.lower() == "w":
            self._act_tab_close(str(self.active_tab), 0, 0)
            return
        if ctrl and key == "Tab":
            if self.tabs:
                step = -1 if shift else 1
                self.active_tab = (self.active_tab + step) % len(self.tabs)
            return
        if ctrl and shift and key.lower() == "s":
            self._act_stash_pop("", 0, 0)
            return
        if ctrl and key.lower() == "s" and not self._typing():
            self._act_stash_push("", 0, 0)
            return
        if ctrl and shift and key.lower() == "a":
            self._act_toggle_amend("", 0, 0)
            return
        if ctrl and key == "Enter":
            self._act_commit("", 0, 0)
            return
        if key == "Tab" and not ctrl:
            if self.focus == "staging":
                # Reference README: staging Tab cycles subject → body →
                # staged list → unstaged list (empty lists skipped).
                view = tab.active_view() if tab else None
                status = view.status if view else None
                order = ["subject", "body"]
                if status and status.staged:
                    order.append("staged-list")
                if status and (status.unstaged or status.untracked):
                    order.append("unstaged-list")
                try:
                    idx = order.index(self.focused_input)
                except ValueError:
                    idx = -1
                self.focused_input = order[(idx + 1) % len(order)]
            else:
                cycle = ["graph", "staging", "sidebar"]
                self.focus = cycle[(cycle.index(self.focus) + 1)
                                   % len(cycle)]
                self.focused_input = ""
            return
        if tab is None:
            return
        # Diff viewer horizontal scroll (reference README: Left/Right
        # arrow keys; Shift+wheel handled in the host loop).
        if self.diff_open and key in ("Left", "Right") and not self._typing():
            step = 60.0 * (2.0 if self.config.scroll_speed_fast else 1.0)
            tab.diff_hscroll = max(
                0.0, tab.diff_hscroll + (step if key == "Right" else -step))
            return
        # Search ("/" typed into a focused input must insert, not search).
        if self.focus == "graph" and not self._typing() \
                and (key == "/" or (ctrl and key.lower() == "f")):
            tab.search_active = True
            self.focused_input = "search"
            return
        if self._typing():
            if key in ("Left", "Right", "Home", "End", "Delete") \
                    and self._input_edit_key(key, shift):
                return
            if ctrl and key.lower() == "a":
                # Select all (anchor at 0, caret at end).
                self.input_anchor = 0
                self.input_cursor = None
                return
            if ctrl and key.lower() == "c":
                value = self._input_read() or ""
                span = self._selection_span(value)
                if span is not None:
                    self._set_clipboard(value[span[0]:span[1]],
                                        primary=True)
                return
            if len(key) == 1 and not ctrl:
                self.on_text(key)
            return
        # Staging file-list navigation (focused via the staging Tab cycle).
        if (self.focus == "staging"
                and self.focused_input in ("staged-list", "unstaged-list")):
            view = tab.active_view()
            status = view.status if view else None
            if status is None:
                return
            bucket = ("staged" if self.focused_input == "staged-list"
                      else "unstaged")
            entries = (status.staged if bucket == "staged"
                       else status.unstaged + status.untracked)
            paths = [e.path for e in entries]
            if not paths:
                return
            in_bucket = view.selected_staged == (bucket == "staged")
            cur = (paths.index(view.selected_file)
                   if in_bucket and view.selected_file in paths else -1)
            if key in ("j", "Down", "k", "Up"):
                step = 1 if key in ("j", "Down") else -1
                nxt = max(0, min(len(paths) - 1,
                                 cur + step if cur >= 0 else 0))
                view.selected_file = paths[nxt]
                view.selected_staged = bucket == "staged"
            elif key == "Enter" and cur >= 0:
                self._act_view_file(f"{bucket}:{paths[cur]}", 0, 0)
            elif key == " " and cur >= 0:
                self._act_toggle_stage(f"{bucket}:{paths[cur]}", 0, 0)
            return
        # Graph navigation.
        if self.focus == "graph":
            selectable = [c.oid for c in tab.commits if not c.is_synthetic]
            if key in ("J", "K") and tab.selected_oid in selectable:
                # Shift+j/k: extend/open a range compare from the current
                # selection (keyboard parity with Shift+click;
                # design_feedback_feb2026.md:492 selection model). The
                # keyboard cursor IS the moving end; the other end of an
                # existing range stays fixed.
                cur = selectable.index(tab.selected_oid)
                nxt = max(0, min(len(selectable) - 1,
                                 cur + (1 if key == "J" else -1)))
                if nxt != cur:
                    target = selectable[nxt]
                    if (tab.compare_range
                            and tab.selected_oid in tab.compare_range):
                        a, b = tab.compare_range
                        fixed = b if tab.selected_oid == a else a
                    else:
                        fixed = tab.selected_oid
                    if fixed == target:
                        # Shrunk back onto the fixed end: collapse to a
                        # plain selection, not a degenerate 0-commit
                        # compare.
                        tab.compare_range = None
                        tab.compare_set = frozenset()
                        self.diff_open = False
                        tab.select_commit(target)
                    else:
                        self._open_range_compare(fixed, target)
                        tab.select_commit(target)
                    self._scroll_selected_into_view(tab)
                return
            if key in ("j", "Down", "k", "Up", "PageDown", "PageUp"):
                if not selectable:
                    return
                cur = (selectable.index(tab.selected_oid)
                       if tab.selected_oid in selectable else -1)
                step = {"j": 1, "Down": 1, "k": -1, "Up": -1,
                        "PageDown": 20, "PageUp": -20}[key]
                nxt = max(0, min(len(selectable) - 1,
                                 cur + step if cur >= 0 else 0))
                tab.select_commit(selectable[nxt])
                self._scroll_selected_into_view(tab)
            elif key == "Enter" and tab.selected_oid:
                self._act_select_commit(tab.selected_oid, 0, 0)
        elif self.focus == "sidebar":
            keys = self._sidebar_keys(tab)
            if not keys:
                return
            cur = (keys.index(tab.selected_sidebar_key)
                   if tab.selected_sidebar_key in keys else -1)
            if key in ("j", "Down", "k", "Up", "PageDown", "PageUp"):
                # Page step ~ one sidebar viewport of items (reference
                # README "Navigate by page", reference: README.md
                # sidebar keyboard table).
                step = {"j": 1, "Down": 1, "k": -1, "Up": -1,
                        "PageDown": 10, "PageUp": -10}[key]
                tab.selected_sidebar_key = keys[
                    max(0, min(len(keys) - 1, cur + step))]
                self._sidebar_autoscroll(tab, keys)
            elif key == "Enter" and tab.selected_sidebar_key:
                self._sidebar_activate(tab)
            elif key == "d" and tab.selected_sidebar_key:
                kind, _, name = tab.selected_sidebar_key.partition(":")
                if kind == "branch":
                    self._act_confirm_delete_branch(name, 0, 0)

    def _typing(self) -> bool:
        # File-list focus (staged-list/unstaged-list) is navigational,
        # not a text input — j/k etc. must keep working there.
        return self.focused_input not in ("", "staged-list",
                                          "unstaged-list")

    def _scroll_selected_into_view(self, tab: RepoTab) -> None:
        if tab.selected_oid is None:
            return
        idx = next((i for i, c in enumerate(tab.commits)
                    if c.oid == tab.selected_oid), None)
        if idx is None or idx >= len(tab.graph_layout.row_tops):
            return
        top = tab.graph_layout.row_tops[idx]
        rh = tab.graph_layout.row_heights[idx]
        view_h = self._last_viewport[1] - 130
        if top < tab.history_scroll:
            tab.history_scroll = top
        elif top + rh > tab.history_scroll + view_h:
            tab.history_scroll = top + rh - view_h

    def _sidebar_autoscroll(self, tab: RepoTab, keys: list[str]) -> None:
        """Keep the keyboard selection visible (reference README: sidebar
        "auto-scroll on keyboard navigation"). Row pitch is uniform
        (sidebar.item_h, honoring Row Size); section headers above the
        selection are approximated by the selection's section ordinal."""
        from .views.sidebar import item_h

        ih = item_h(tab)
        if tab.selected_sidebar_key not in keys:
            return
        idx = keys.index(tab.selected_sidebar_key)
        section_ord = {"branch": 1, "remote": 2, "tag": 3, "worktree": 5,
                       "stash": 6}.get(
            tab.selected_sidebar_key.partition(":")[0], 1)
        top = (idx + section_ord) * ih
        view_h = max(self._last_viewport[1] - 140, ih * 4)
        if top < tab.sidebar_scroll + ih:
            tab.sidebar_scroll = max(0.0, top - ih)
        elif top + ih > tab.sidebar_scroll + view_h:
            tab.sidebar_scroll = top + ih - view_h

    def _sidebar_keys(self, tab: RepoTab) -> list[str]:
        keys = [f"branch:{t.name}" for t in tab.branch_tips
                if not t.is_remote]
        keys += [f"remote:{t.name}" for t in tab.branch_tips if t.is_remote]
        keys += [f"tag:{t.name}" for t in tab.tags]
        keys += [f"worktree:{w.path}" for w in tab.worktrees]
        keys += [f"stash:{s.ref_name}" for s in tab.stashes]
        return keys

    def _sidebar_activate(self, tab: RepoTab) -> None:
        kind, _, name = (tab.selected_sidebar_key or "").partition(":")
        if kind == "branch":
            self._act_checkout_branch(name, 0, 0)
        elif kind == "remote":
            self._act_checkout_remote(name, 0, 0)
        elif kind == "tag":
            tag = next((t for t in tab.tags if t.name == name), None)
            if tag:
                self._act_select_commit(tag.oid, 0, 0)
        elif kind == "worktree":
            self._act_select_worktree(name, 0, 0)
        elif kind == "stash":
            self._act_apply_stash(name, 0, 0)

    def on_scroll(self, dy: float, x: float, y: float) -> None:
        with span("input"):
            self._on_scroll(dy, x, y)

    def _on_scroll(self, dy: float, x: float, y: float) -> None:
        tab = self.current()
        if tab is None:
            return
        speed = 2.0 if self.config.scroll_speed_fast else 1.0
        sidebar_w = self.config.sidebar_width
        right_w = self.config.right_panel_width
        vw = self._last_viewport[0]
        if x < sidebar_w:
            from .views.sidebar import item_h
            max_scroll = max(0.0, (len(self._sidebar_keys(tab)) + 7)
                             * item_h(tab) - 200.0)
            tab.sidebar_scroll = max(0.0, min(
                tab.sidebar_scroll + dy * speed, max_scroll))
        elif x > vw - right_w and self.diff_open:
            tab.diff_scroll = max(0.0, tab.diff_scroll + dy * speed)
        else:
            tab.history_scroll = max(
                0.0, min(tab.history_scroll + dy * speed,
                         max(0.0, tab.graph_layout.total_height - 200)))
            # Infinite scroll: nearing the bottom raises the walk cap and
            # refreshes (reference README: "loads more commits as you
            # scroll down"; walk cap per refresh stays MAX_COMMITS-sized).
            near_bottom = (tab.history_scroll
                           > tab.graph_layout.total_height - 2000)
            real = sum(1 for c in tab.commits if not c.is_synthetic)
            # Only bump when the trigger can actually spawn: raising the
            # limit while a refresh is in flight would drop the trigger
            # (idempotence) but keep the raised limit — `real >= limit`
            # then never fires again and loading stalls permanently. A
            # later scroll event at the (clamped) bottom retries.
            if (near_bottom and real >= tab.commit_limit
                    and tab.state_refresh_rx is None):
                tab.commit_limit += 1000
                tab.trigger_state_refresh(self.proxy)
