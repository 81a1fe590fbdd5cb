"""Commit details pane: full SHA/parents/author/time/message, per-file
± stats with clickable rows, submodule-pin entries, Copy SHA.

Capability parity with reference src/commit_details.rs:17
(commit_details_pane).
"""

from __future__ import annotations

from ...gitcore.types import FullCommitInfo, format_absolute_time
from ...ui import El, column, rect, row, spacer, text
from ...ui.theme import DARK as T
from .commit_graph import identicon


def commit_details_pane(tab, info: FullCommitInfo,
                        submodule_pins=None) -> El:
    rows: list[El] = []
    rows.append(row(
        text(info.oid[:12], font_size=T.font_size, bold=True, color=T.accent),
        rect(text("Copy SHA", font_size=10, color=T.text_muted),
             route=f"copy-sha:{info.oid}", radius=3, padding=(1, 6, 1, 6),
             hover_fill=T.surface_hover),
        spacer(),
        rect(text("✕", font_size=11, color=T.text_muted),
             route="close-details", radius=3, padding=(0, 5, 0, 5),
             hover_fill=T.surface_hover),
        gap=8, align="center", width="fill"))
    rows.append(row(
        identicon(info.author_email, info.author_name, 24),
        column(
            text(f"{info.author_name} <{info.author_email}>",
                 font_size=T.font_size_small, color=T.text),
            text(format_absolute_time(info.author_time),
                 font_size=T.font_size_small, color=T.text_muted),
            gap=2),
        gap=8, align="center"))
    if info.parents:
        parent_links = [text("Parents:", font_size=T.font_size_small,
                             color=T.text_muted)]
        for p in info.parents:
            parent_links.append(rect(
                text(p[:8], font_size=T.font_size_small, color=T.accent),
                route=f"select-commit:{p}", radius=3,
                padding=(0, 4, 0, 4), hover_fill=T.surface_hover))
        rows.append(row(*parent_links, gap=4, align="center"))
    rows.append(rect(
        text(info.message, font_size=T.font_size, color=T.text, wrap=True),
        fill=T.background, radius=4, padding=(6, 8, 6, 8), width="fill"))

    if info.files:
        rows.append(text("FILES", font_size=10, bold=True,
                         color=T.text_muted))
        for f in info.files[:200]:
            selected = tab.detail_file == f.path
            rows.append(rect(
                row(text(f.path[-48:], font_size=T.font_size_small,
                         color=T.text),
                    spacer(),
                    text(f"+{f.additions}", font_size=10, color=T.success),
                    text(f"−{f.deletions}", font_size=10, color=T.danger),
                    gap=6, align="center", width="fill", height="fill"),
                width="fill", height=20, radius=3, padding=(1, 6, 1, 6),
                fill=T.surface_hover if selected else None,
                hover_fill=T.surface_hover,
                route=f"view-commit-file:{f.path}",
                key=f"detail-file:{f.path}"))

    if submodule_pins:
        rows.append(text("SUBMODULE PINS", font_size=10, bold=True,
                         color=T.text_muted))
        for sub in submodule_pins:
            rows.append(row(
                text(sub.path, font_size=T.font_size_small, color=T.text),
                spacer(),
                text((sub.head_oid or "")[:8], font_size=10,
                     color=T.text_muted),
                gap=6, align="center", width="fill"))

    return rect(column(*rows, gap=8, width="fill", padding=(10, 10, 10, 10)),
                fill=T.surface, width="fill", height="fill", clip=True,
                key="commit-details")
