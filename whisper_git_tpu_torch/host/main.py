"""CLI entry point of the port: the interactive terminal app and the
headless screenshot.

    python -m whisper_git_tpu_torch [paths…] [--repo P] [--device cuda|cpu]
    python -m whisper_git_tpu_torch --screenshot OUT.png [--size WxH]
        [--scale S] [--repo P] [--screenshot-state STATE]
        [--device cuda|cpu]

The options and the screenshot states are the port's own copy of the
reference CLI's (`whisper_git_tpu/host/main.py` `parse_args`,
`apply_screenshot_state`), plus `--device` (default cuda; asking for cuda
without a GPU is an error, raised before anything else runs). Without
`--screenshot` it runs the interactive frame loop (`host/loop.py`) on the
terminal, as the reference does; on cuda the three kernels start building
at once, beside the repositories' first refresh. The screenshot prefetches
avatars first (one 3 s deadline a tab; `WGIT_SKIP_AVATARS` skips it), and
`--dump-bundles OUT_DIR` writes the SVG, tree and lint dumps of every
fixture scene (`tools/dump_bundles.py`), as the reference's CLI does.

The CLI refuses every import of JAX and of the reference package in its
process (`refuse_jax`, `refuse_reference`): the port stands on its own
modules, and a view that reaches an op the port lacks fails as an
ImportError of `whisper_git_tpu_torch.<module>` instead of quietly
running the reference's.
"""

from __future__ import annotations

import argparse
import importlib.abc
import sys

from ..app.repo_tab import RepoTab, WorktreeView
from ..app.ui_app import WhisperApp
from ..app.views import dialogs
from ..gitcore.types import WorktreeInfo
from ..render.renderer import resolve_device
from ..services import crash_log
from ..services.config import Config

SCREENSHOT_STATES = [
    "welcome", "history", "history-search", "commit-menu", "diff",
    "settings", "open-repo", "confirm", "error", "clone", "token",
    "token-edit", "context-menu", "many-worktrees", "many-worktrees-open",
    "palette", "rebase-i", "pr", "rewind", "compare",
]


def parse_args(argv: list[str]) -> argparse.Namespace:
    """The reference CLI's options (reference: main.rs:29), and
    `--device`."""
    p = argparse.ArgumentParser(
        prog="whisper_git_tpu_torch",
        description="Git client (whisper-git rebuild), PyTorch / CUDA port")
    p.add_argument("paths", nargs="*", help="repositories to open as tabs")
    p.add_argument("--screenshot", metavar="OUT.png",
                   help="render one frame headlessly and exit")
    p.add_argument("--size", default="1280x800", metavar="WxH")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--screenshot-state", choices=SCREENSHOT_STATES,
                   default=None)
    p.add_argument("--repo", default=None,
                   help="repository for screenshot states needing one")
    p.add_argument("--dump-bundles", metavar="OUT_DIR",
                   help="write SVG+tree+lint golden dumps and exit")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to render on (default: cuda)")
    return p.parse_args(argv)


def synthesize_many_worktrees(tab: RepoTab, n: int = 9) -> None:
    """Stress fixture (reference: main.rs:261)."""
    base = tab.worktrees[0] if tab.worktrees else WorktreeInfo(
        name="main", path=tab.repo.workdir or "/", branch="main",
        head_oid=tab.head_oid, is_main=True)
    wts = [base]
    for i in range(1, n):
        path = f"{(tab.repo.workdir or '/tmp')}-wt{i}"
        wts.append(WorktreeInfo(name=f"wt{i}", path=path,
                                branch=f"feature/wt-{i}",
                                head_oid=tab.head_oid))
        tab.worktree_views[path] = WorktreeView(path=path, dirty=(i % 3 == 0))
    tab.worktrees = wts


def apply_screenshot_state(app: WhisperApp, state: str) -> None:
    """Fixture injection (reference: main.rs:100-233)."""
    tab = app.current()
    if state == "welcome":
        app.tabs = []
        if not app.config.recent_repos:
            app.config.recent_repos = [
                {"path": "/home/user/src/whisper-git", "name": "whisper-git"},
                {"path": "/home/user/src/esp-idf", "name": "esp-idf"},
            ]
    elif state == "history-search" and tab is not None:
        tab.search_active = True
        tab.search_query = "fix"
        app.focused_input = "search"
    elif state == "commit-menu" and tab is not None and tab.commits:
        oid = next((c.oid for c in tab.commits if not c.is_synthetic), None)
        if oid:
            app._act_menu_commit(oid, 320.0, 180.0)
    elif state == "context-menu" and tab is not None and tab.branch_tips:
        app._act_menu_branch(tab.branch_tips[0].name, 120.0, 160.0)
    elif state == "diff" and tab is not None and tab.commits:
        oid = next((c.oid for c in tab.commits if not c.is_synthetic), None)
        if oid:
            app._act_select_commit(oid, 0, 0)
            if app.diff_files:
                app.diff_open = True
    elif state == "settings":
        app.modal = ("settings", None)
    elif state == "open-repo":
        app.modal = ("open-repo", dialogs.OpenRepoForm(path="/home/user/src"))
        app.focused_input = "path"
    elif state == "confirm":
        app.modal = ("confirm", dialogs.ConfirmState(
            action="reset", title="Reset (hard) to 3f2a91c?",
            message="DESTROYS all uncommitted changes. This cannot be "
                    "undone.", confirm_label="Reset hard",
            payload={"mode": "hard", "oid": "3f2a91c"}))
    elif state == "error":
        app.modal = ("error", dialogs.ErrorState(
            "Push failed",
            "Push rejected: the remote has newer commits. Pull first, or "
            "force-push."))
    elif state == "clone":
        app.modal = ("clone", dialogs.CloneForm(
            url="https://github.com/user/repo.git", dest="~/src/repo"))
        app.focused_input = "url"
    elif state == "token":
        app.modal = ("token", dialogs.TokenForm())
        app.focused_input = "token"
    elif state == "token-edit":
        app.modal = ("token", dialogs.TokenForm(
            provider="gitlab", host="gitlab.example.com", editing=True,
            token="glpat-xxxx"))
    elif state in ("many-worktrees", "many-worktrees-open") and tab is not None:
        synthesize_many_worktrees(tab)
        if state == "many-worktrees-open":
            app.worktree_picker_open = True
    elif state == "palette":
        from ..app.palette import PaletteState, build_commands
        app.palette = PaletteState(query="br", commands=build_commands(app))
    elif state == "pr" and tab is not None:
        from ..services.pr import PullRequestInfo
        branch = tab.current_branch or "main"
        tab.pr_by_branch[branch] = PullRequestInfo(
            "github", 42, "Improve widget rendering", branch, "main",
            "https://github.com/example/repo/pull/42")
    elif state == "rebase-i" and tab is not None and tab.commits:
        plan = tab.commits[:4][::-1]  # oldest first, todo order
        entries = [dialogs.RebaseIEntry("pick", c.oid, c.summary)
                   for c in plan]
        if len(entries) > 1:
            entries[1].action = "squash"
        if len(entries) > 2:
            entries[2].action = "drop"
        app.modal = ("rebase-i", dialogs.RebaseIForm(
            onto=plan[0].oid if plan else "HEAD~4", entries=entries))
    elif state == "compare" and tab is not None and len(tab.commits) >= 3:
        real = [c for c in tab.commits if not c.is_synthetic]
        if len(real) >= 3:
            app._open_range_compare(real[2].oid, real[0].oid)
    elif state == "rewind" and tab is not None:
        # Synthetic timeline: a working session of cadence + op-labeled
        # snapshots ending at NOW, scrubbed back two steps.
        import time as _time

        from ..services.rewind import RewindSnapshot, RewindState
        base = _time.time() - 3 * 3600
        oid = tab.head_oid or ("a" * 40)
        older = "b" * 40
        snaps = [
            RewindSnapshot(ts=base, head_oid=older, branch="main",
                           branch_tips=(("main", older),),
                           label="fresh after pull"),
            RewindSnapshot(ts=base + 1500, head_oid=older, branch="main",
                           branch_tips=(("main", older),),
                           unstaged=("auth.py", "config.py")),
            RewindSnapshot(ts=base + 4200, head_oid=older,
                           branch="feature/auth",
                           branch_tips=(("feature/auth", older),
                                        ("main", older)),
                           staged=("auth.py",), unstaged=("config.py",),
                           label="started auth work"),
            RewindSnapshot(ts=base + 7800, head_oid=oid, branch="main",
                           branch_tips=(("feature/auth", older),
                                        ("main", oid)),
                           untracked=("notes.md",),
                           worktree_state=(("feature-x", 2), ("main", 1))),
            RewindSnapshot(ts=_time.time(), head_oid=oid, branch="main",
                           branch_tips=(("feature/auth", older),
                                        ("main", oid))),
        ]
        app.modal = ("rewind", RewindState(snapshots=snaps,
                                           index=len(snaps) - 3,
                                           show_commands=True))
    # "history" is the default rendered state — nothing to inject.


class _Refuse(importlib.abc.MetaPathFinder):
    def __init__(self, roots: tuple, why: str):
        self.roots = roots
        self.why = why

    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in self.roots:
            raise ImportError(f"{name}: {self.why}")
        return None


def _refuse(roots: tuple, why: str) -> None:
    if not any(isinstance(f, _Refuse) and f.roots == roots
               for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse(roots, why))


def refuse_jax() -> None:
    """Make every later import of jax or jaxlib in this process raise."""
    _refuse(("jax", "jaxlib"),
            "this view reaches a JAX op that whisper_git_tpu_torch has "
            "not ported")


def refuse_reference() -> None:
    """Make every later import of the JAX package in this process raise:
    the port keeps its own copy of every module it needs."""
    _refuse(("whisper_git_tpu",),
            "whisper_git_tpu_torch imports nothing of the reference package")


def open_app(paths: list[str]) -> WhisperApp:
    """The app with `paths` open as tabs, refreshed synchronously, and
    its avatars fetched (reference: the screenshot path of main.py)."""
    app = WhisperApp.from_paths(paths, config=Config())
    for tab in app.tabs:
        tab.refresh_sync()  # sync full refresh — no event loop
    # Blocking avatar prefetch so the frame shows real avatars
    # (reference: prefetch_avatars_for_screenshot, main.rs:307;
    # WGIT_SKIP_AVATARS skips it). The fetches fan out over a thread
    # pool with ONE 3 s wall deadline per tab — a dead network costs
    # seconds, not 20 × 3 s of serial timeouts.
    for tab in app.tabs:
        emails = list({c.author_email for c in tab.commits
                       if c.author_email})[:20]
        app.avatar_cache.prefetch_sync(emails, timeout=3.0)
    return app


def main(argv: list[str] | None = None) -> int:
    refuse_jax()
    refuse_reference()
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(args.device)  # no GPU for cuda: fail first
    from ..ops import diffword

    diffword.set_device(device)
    # The bundle dump renders nothing: it starts no nvcc that would
    # outlive it.
    if device.type == "cuda" and (args.screenshot or not args.dump_bundles):
        from ..render.renderer import start_kernel_builds

        start_kernel_builds()
    paths = list(args.paths)
    if args.repo:
        paths = [args.repo] + paths
    if args.screenshot:
        app = open_app(paths)
        if args.screenshot_state:
            apply_screenshot_state(app, args.screenshot_state)
        w, h = (int(v) for v in args.size.lower().split("x"))
        from . import screenshot_mode

        screenshot_mode.run(args.screenshot, w, h, args.scale, app,
                            device=device)
        print(f"wrote {args.screenshot}")
        return 0
    if args.dump_bundles:
        from ..tools.dump_bundles import dump_all

        count = dump_all(args.dump_bundles, repo_path=paths[0] if paths
                         else None)
        print(f"wrote {count} scenes to {args.dump_bundles}")
        return 0

    # Windowed mode: no display stack here — run the interactive
    # terminal frame loop instead (reference: main.py:236-247).
    # BEFORE init() — init would unlink the clean-exit marker the check
    # compares against (reference: crash_log.rs:288 surfaces this).
    crashed = crash_log.has_crash_since_last_exit()
    crash_log.init()
    crash_log.install_panic_hook()
    from .loop import run_loop

    app = WhisperApp.from_paths(paths)
    if crashed:
        app.toast("error",
                  f"Previous session crashed — report saved: {crashed}")
    code = run_loop(app, device=device)
    crash_log.mark_clean_exit()
    return code


if __name__ == "__main__":
    sys.exit(main())
