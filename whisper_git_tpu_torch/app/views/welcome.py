"""Welcome view: hero + Open/Clone + normalized recent list.

Capability parity with reference src/welcome.rs:28 (welcome_view) +
src/recent.rs normalization.
"""

from __future__ import annotations

from ...ui import El, column, rect, row, spacer, text
from ...ui.theme import DARK as T


def welcome_view(recent_repos: list[dict]) -> El:
    rows: list[El] = [
        spacer(40),
        text("Whisper Git", font_size=26, bold=True, color=T.text_bright),
        text("A TPU-accelerated Git client", font_size=T.font_size,
             color=T.text_muted),
        spacer(16),
        row(
            rect(text("Open Repository…", font_size=T.font_size, bold=True,
                      color=T.text_bright),
                 fill=T.accent, radius=6, padding=(7, 14, 7, 14),
                 route="open-repo-dialog", key="welcome-open"),
            rect(text("Clone…", font_size=T.font_size, color=T.text),
                 fill=T.surface_raised, radius=6, padding=(7, 14, 7, 14),
                 route="open-clone-dialog", key="welcome-clone"),
            gap=10, justify="center", width="fill"),
        spacer(24),
    ]
    if recent_repos:
        rows.append(text("RECENT", font_size=10, bold=True,
                         color=T.text_muted))
        for entry in recent_repos[:10]:
            path = entry.get("path", "")
            name = entry.get("name") or path.rstrip("/").rsplit("/", 1)[-1]
            rows.append(rect(
                row(text(name, font_size=T.font_size, color=T.text),
                    spacer(),
                    text(path[-50:], font_size=T.font_size_small,
                         color=T.text_muted),
                    gap=10, align="center", width="fill", height="fill"),
                width=520, height=30, radius=5, padding=(4, 10, 4, 10),
                hover_fill=T.surface_hover, fill=T.surface,
                route=f"open-recent:{path}", key=f"recent:{path}"))
    body = column(*rows, gap=6, align="center", width="fill", height="fill",
                  padding=(20, 20, 20, 20))
    return rect(body, fill=T.background, width="fill", height="fill",
                key="welcome")
