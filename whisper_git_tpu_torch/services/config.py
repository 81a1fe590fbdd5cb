"""Settings persistence: JSON at ~/.config/whisper-git/settings.json with
per-field defaults and recent-repo compaction.

Capability parity with reference src/config.rs (Config :10-45, load/save
:99,113, add_recent_repo :138, register_gitlab_host :128,
MAX_RECENT_REPOS :65) and src/recent.rs normalization (dedupe by repo
identity, canonicalize worktrees to their repo, cap 10).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

MAX_RECENT_REPOS = 10


@dataclass
class Config:
    show_avatars: bool = True
    scroll_speed_fast: bool = False
    row_size_large: bool = False
    show_shortcut_bar: bool = True
    recent_repos: list = field(default_factory=list)  # [{path, name}]
    gitlab_hosts: list = field(default_factory=list)
    sidebar_width: float = 220.0
    staging_width: float = 320.0
    right_panel_width: float = 420.0
    window_width: float = 1280.0
    window_height: float = 800.0
    diff_mode: str = "unified"  # unified | split
    ai_provider: str = "claude-cli"
    # Worktree changeset taglines via cheap LLM (user_needs.md
    # "LLM-Generated Descriptions"); off by default — it shells out.
    ai_taglines: bool = False
    # Project Rewind timeline (design_feedback_feb2026.md:368 — local
    # state-only snapshots, no file contents, no network).
    rewind_enabled: bool = True

    @staticmethod
    def path() -> str:
        base = os.environ.get("XDG_CONFIG_HOME",
                              os.path.expanduser("~/.config"))
        return os.path.join(base, "whisper-git", "settings.json")

    @classmethod
    def load(cls) -> "Config":
        try:
            with open(cls.path(), "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cls()
        cfg = cls()
        for k, v in data.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg

    def save(self) -> None:
        path = self.path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                json.dump(asdict(self), f, indent=2)
        except OSError:
            pass

    def add_recent_repo(self, path: str, name: str = "") -> None:
        """Compact: canonicalize, dedupe by identity, drop stale, cap 10."""
        entry = {"path": canonical_repo_path(path),
                 "name": name or os.path.basename(path.rstrip(os.sep))}
        self.recent_repos = normalize_recents(
            [entry] + list(self.recent_repos))

    def register_gitlab_host(self, host: str) -> None:
        if host and host not in self.gitlab_hosts:
            self.gitlab_hosts.append(host)


def canonical_repo_path(path: str) -> str:
    """Resolve a worktree path to its main repo identity where possible
    (reference: recent.rs dedupes by common_dir identity)."""
    path = os.path.abspath(os.path.expanduser(path))
    try:
        from ..gitcore.cli import run_git
        out = run_git(path if os.path.isdir(path) else os.path.dirname(path),
                      "rev-parse", "--path-format=absolute",
                      "--git-common-dir", check=False, timeout=10)
        if out.ok:
            common = out.stdout.strip().splitlines()[0]
            if common.endswith("/.git"):
                return common[:-len("/.git")]
            if os.path.basename(common) == ".git":
                return os.path.dirname(common)
    except Exception:
        pass
    return path


_canonical_memo: dict = {}


def normalize_recents(entries: list[dict]) -> list[dict]:
    """Dedupe by canonical path, drop nonexistent, cap at 10
    (reference: recent.rs:26-60)."""
    seen: set[str] = set()
    out: list[dict] = []
    for e in entries:
        path = e.get("path", "")
        if not path or not os.path.isdir(path):
            continue
        # Canonicalize PERSISTED entries too: an old worktree-path entry
        # plus its later-canonicalized repo path must dedupe to one row
        # (reference recent.rs dedupes by repo identity). Memoized — the
        # resolve spawns a git subprocess and normalize runs on the UI
        # thread on every add.
        path = _canonical_memo.get(path) or _canonical_memo.setdefault(
            path, canonical_repo_path(path))
        if not path or path in seen or not os.path.isdir(path):
            continue
        seen.add(path)
        out.append({"path": path,
                    "name": e.get("name")
                    or os.path.basename(path.rstrip(os.sep))})
        if len(out) >= MAX_RECENT_REPOS:
            break
    return out
