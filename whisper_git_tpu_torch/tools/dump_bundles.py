"""Golden scene dumps: build fixture WhisperApps for every view / modal /
menu state and write `<scene>.svg` + `<scene>.tree.txt` + `<scene>.lint.txt`
per scene.

Capability parity with reference src/bin/dump_bundles.rs:20-76 — the
CPU-only regression artifacts; the lint report is the gate
(`grep -c MissingSurfaceFill out/*.lint.txt` must be zero,
docs/aetna-port.md:258-279).
"""

from __future__ import annotations

import os
import subprocess
import tempfile

from ..app.repo_tab import RepoTab
from ..app.ui_app import WhisperApp
from ..app.views import dialogs
from ..host.main import SCREENSHOT_STATES, apply_screenshot_state
from ..ui.dump import to_svg, to_tree_text
from ..ui.layout import layout_tree
from ..ui.lint import run_lints

VIEWPORT = (1280.0, 800.0)


def make_fixture_repo(base_dir: str) -> str:
    """A deterministic throwaway repo with branches, a merge, a tag, a
    stash and staged + unstaged changes."""
    path = os.path.join(base_dir, "fixture-repo")
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0",
               GIT_AUTHOR_DATE="2026-01-01T12:00:00",
               GIT_COMMITTER_DATE="2026-01-01T12:00:00")

    def git(*args):
        subprocess.run(["git", "-C", path, *args], check=True,
                       capture_output=True, env=env)

    os.makedirs(path, exist_ok=True)
    subprocess.run(["git", "init", "-b", "main", path], check=True,
                   capture_output=True, env=env)
    git("config", "user.email", "fixture@example.com")
    git("config", "user.name", "Fixture Author")
    with open(os.path.join(path, "README.md"), "w") as f:
        f.write("# Fixture\n\nhello\n")
    git("add", ".")
    git("commit", "-m", "initial commit")
    git("checkout", "-b", "feature/widgets")
    with open(os.path.join(path, "widget.py"), "w") as f:
        f.write("def widget():\n    return 42\n")
    git("add", ".")
    git("commit", "-m", "add widget module")
    git("checkout", "main")
    with open(os.path.join(path, "main.py"), "w") as f:
        f.write("print('main')\n")
    git("add", ".")
    git("commit", "-m", "add main entry")
    git("merge", "feature/widgets", "-m", "merge feature/widgets")
    git("tag", "-a", "v0.1.0", "-m", "first release")
    with open(os.path.join(path, "README.md"), "a") as f:
        f.write("\nstash me\n")
    git("stash", "push", "-m", "wip notes")
    with open(os.path.join(path, "staged.txt"), "w") as f:
        f.write("staged content\n")
    git("add", "staged.txt")
    with open(os.path.join(path, "README.md"), "a") as f:
        f.write("\nunstaged edit\n")
    return path


def build_scenes(repo_path: str) -> dict[str, WhisperApp]:
    """One fixture app per scene (reference: dump_bundles scenes :78+)."""
    scenes: dict[str, WhisperApp] = {}

    def fresh() -> WhisperApp:
        tab = RepoTab.open(repo_path)
        tab.refresh_sync()
        app = WhisperApp.with_tabs([tab])
        return app

    for state in SCREENSHOT_STATES:
        app = (WhisperApp.with_tabs([]) if state == "welcome" else fresh())
        apply_screenshot_state(app, state)
        scenes[state] = app

    # Extra scenes beyond the CLI states.
    app = fresh()
    app._act_view_file("unstaged:README.md", 0, 0)
    scenes["working-diff"] = app

    app = fresh()
    tab = app.current()
    # First NON-synthetic commit: the dirty fixture's 'Uncommitted
    # changes' row sorts first and select_commit rejects synthetics —
    # selecting it silently dumped plain history with no details pane.
    oid = next((c.oid for c in tab.commits if not c.is_synthetic), None)
    if oid:
        app._act_select_commit(oid, 0, 0)
    assert app.current().selected_oid, "commit-details scene: no selection"
    scenes["commit-details"] = app

    app = fresh()
    app.focus = "staging"
    app.focused_input = "subject"
    view = app.current().active_view()
    if view:
        view.draft_subject = "Improve widget rendering performance"
        view.draft_body = "Batch the glyph uploads per frame."
    scenes["staging-draft"] = app

    app = fresh()
    second = RepoTab.open(repo_path)
    second.refresh_sync()
    second.title = "second-tab"
    app.tabs.append(second)
    scenes["multi-tab"] = app

    app = fresh()
    app.toast("success", "Pushed main to origin")
    app.toast("error", "Fetch failed: network unreachable")
    app.toast("info", "3 new commits on origin/main")
    scenes["toasts"] = app

    app = fresh()
    app.modal = ("push", dialogs.PushForm())
    scenes["push-options"] = app

    app = fresh()
    app.modal = ("merge", dialogs.MergeForm(branch="feature/widgets"))
    scenes["merge-options"] = app

    app = fresh()
    app.modal = ("rebase", dialogs.RebaseForm(onto="main"))
    scenes["rebase-options"] = app

    app = fresh()
    app.modal = ("worktree", dialogs.WorktreeForm(branch="feature/x", path="../fixture-x"))
    scenes["worktree-create"] = app

    app = fresh()
    app.modal = ("worktrees-manage", None)
    scenes["worktrees-manage"] = app

    app = fresh()
    app.modal = ("branch", dialogs.BranchForm(name="feature/new"))
    scenes["branch-dialog"] = app

    app = fresh()
    app.modal = ("tag", dialogs.TagForm(name="v0.2.0", message="next release"))
    scenes["tag-dialog"] = app

    app = fresh()
    app.modal = ("pull", dialogs.PullForm(rebase=True))
    scenes["pull-options"] = app

    # AI worktree tagline on the dirty synthetic row.
    app = fresh()
    tab = app.current()
    wd = tab.repo.workdir
    view = tab.worktree_views.get(wd)
    if view is not None:
        view.dirty = True
        tab.worktree_taglines[wd] = "reworks the widget glyph batching"
        tab.rebuild_synthetics()
    scenes["taglines"] = app

    # Row Size: Large (1.5×) — history/sidebar/staging pitch scales
    # (reference README.md:117).
    app = fresh()
    app.config.row_size_large = True
    scenes["large-rows"] = app

    app = fresh()
    app.modal = ("help", None)
    scenes["help"] = app

    # Unicode draft + shift-arrow selection in the subject input
    # (Greek/Cyrillic glyph coverage; selection accent wash).
    app = fresh()
    tab = app.current()
    view = tab.active_view()
    if view is not None:
        view.draft_subject = "Исправить рендер — γρήγορα"
    app.focus = "staging"
    app.focused_input = "subject"
    app.input_cursor = 9
    app.input_anchor = 0
    scenes["unicode-selection"] = app

    # Shaped-text scene: Hebrew + Arabic commit subjects through the
    # full view stack — bidi reordering, Arabic joining and a mixed-
    # direction draft all ride the history rows + staging well
    # (render/shaping.py; reference gets this from cosmic-text).
    app = fresh()
    tab = app.current()
    if tab.commits:
        c = tab.commits[0]
        c.summary = "إصلاح خلل في الواجهة"
        if len(tab.commits) > 1:
            tab.commits[1].summary = "תיקון באג — mixed עם ascii"
    view = tab.active_view()
    if view is not None:
        view.draft_subject = "fix: שלום عالم"
    scenes["rtl-shaping"] = app

    return scenes


def dump_all(out_dir: str, repo_path: str | None = None) -> int:
    from ..app.views import widgets
    from ..app.views.widgets import freeze_cursor, freeze_pulse

    prev_freeze = widgets._PULSE_FREEZE
    prev_cursor = widgets._CURSOR_FREEZE
    freeze_pulse(0.0)   # golden dumps must be byte-deterministic
    freeze_cursor(True)  # the caret blink is wall-clock-driven too
    try:
        os.makedirs(out_dir, exist_ok=True)
        tmp = None
        if repo_path is None:
            tmp = tempfile.mkdtemp(prefix="wgit-dump-")
            repo_path = make_fixture_repo(tmp)
        scenes = build_scenes(repo_path)
        for name, app in scenes.items():
            tree = app.build(VIEWPORT)
            root = layout_tree(tree, VIEWPORT)
            with open(os.path.join(out_dir, f"{name}.svg"), "w") as f:
                f.write(to_svg(root, *VIEWPORT))
            with open(os.path.join(out_dir, f"{name}.tree.txt"), "w") as f:
                f.write(to_tree_text(root))
            findings = run_lints(root)
            with open(os.path.join(out_dir, f"{name}.lint.txt"), "w") as f:
                for finding in findings:
                    f.write(f"{finding.rule}: {finding.message} "
                            f"@({finding.x:.0f},{finding.y:.0f})\n")
            for tab in app.tabs:
                tab.stop_workers()
        return len(scenes)
    finally:
        # Restore the CALLER's clocks (pytest pins them in conftest;
        # leaving ours behind would mask animation behavior for the
        # rest of the calling process).
        freeze_pulse(prev_freeze)
        freeze_cursor(prev_cursor)


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "out/bundles"
    n = dump_all(out)
    print(f"wrote {n} scenes to {out}")
