"""History view: virtualized commit rows with graph lanes, pills,
search dimming, zebra striping, diff-stat chips and CI dots.

Capability parity with reference src/commit_graph.rs:981-1504 (build_row,
history_view, commit_matches_query) on top of ops.lanes geometry.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Optional

from ...gitcore.types import CommitInfo, format_relative_time
from ...ops.lanes import LANE_COLORS, MAX_VISIBLE_LANES, LANE_WIDTH
from ...ui import (El, column, insert_caret, path, rect, row, scroll,
                   spacer, stack, text)
from .widgets import cursor_visible
from ...ui.theme import DARK as T

NODE_RADIUS = 4.5
IDENTICON_COLORS = [
    (0.85, 0.42, 0.42, 1.0), (0.46, 0.78, 0.50, 1.0), (0.92, 0.62, 0.30, 1.0),
    (0.68, 0.50, 0.84, 1.0), (0.87, 0.80, 0.33, 1.0), (0.37, 0.79, 0.79, 1.0),
    (0.36, 0.61, 0.84, 1.0), (0.71, 0.62, 0.89, 1.0),
]


def _node_radius(commit: CommitInfo) -> float:
    """Node visual weight scales with lines changed (the reference's
    design review specs 4 size buckets, design_feedback_feb2026.md:142;
    radii adapted to the 28 px row pitch)."""
    if commit.additions is None:
        return NODE_RADIUS
    total = (commit.additions or 0) + (commit.deletions or 0)
    if total <= 10:
        return 4.0
    if total <= 100:
        return 5.5
    if total <= 500:
        return 7.0
    return 8.5


def _delta_tone(commit: CommitInfo):
    """Green↔red ring tint from the +/- ratio (all green = pure addition,
    all red = pure deletion, mixed = refactoring;
    design_feedback_feb2026.md:151-155). None without diff stats."""
    if commit.additions is None:
        return None
    total = (commit.additions or 0) + (commit.deletions or 0)
    if total == 0:
        return None
    f = (commit.additions or 0) / total
    g, r = T.success, T.danger
    return (r[0] + (g[0] - r[0]) * f, r[1] + (g[1] - r[1]) * f,
            r[2] + (g[2] - r[2]) * f, 0.95)


# Conventional-commit category colors for the prefix token
# (design_feedback_feb2026.md:427 "Auto-tagging … without user input").
_KIND_COLORS = {
    "feat": (0.46, 0.78, 0.50, 1.0), "fix": (0.94, 0.47, 0.47, 1.0),
    "perf": (0.92, 0.62, 0.30, 1.0), "docs": (0.37, 0.70, 0.92, 1.0),
    "refactor": (0.68, 0.50, 0.84, 1.0), "test": (0.37, 0.79, 0.79, 1.0),
    "tests": (0.37, 0.79, 0.79, 1.0),
    "chore": (0.55, 0.58, 0.64, 1.0), "build": (0.55, 0.58, 0.64, 1.0),
    "ci": (0.55, 0.58, 0.64, 1.0), "style": (0.55, 0.58, 0.64, 1.0),
    "revert": (0.94, 0.47, 0.47, 1.0),
}
_KIND_RE = re.compile(r"^([a-z]+)(\([^)]*\))?!?:")


def commit_kind(summary: str):
    """(prefix_length, color) when the subject starts with a known
    conventional-commit token, else None. A "prefix" longer than 40
    chars isn't one (an unbounded scope group must not defeat the
    90-char summary cap downstream)."""
    m = _KIND_RE.match(summary)
    if m is None or m.end() > 40:
        return None
    color = _KIND_COLORS.get(m.group(1))
    return (m.end(), color) if color is not None else None


def commit_matches_query(commit: CommitInfo, query: str) -> bool:
    """Match subject, author name, and SHA (reference: commit_graph.rs:1509)."""
    q = query.lower().strip()
    if not q:
        return True
    return (q in commit.summary.lower()
            or q in commit.author_name.lower()
            or commit.oid.lower().startswith(q))


def identicon(email: str, name: str, size: float = 20.0) -> El:
    """Deterministic colored-initial fallback avatar
    (reference: commit_graph.rs:83-123 — 8-color hash)."""
    key = email or name or "?"
    color = IDENTICON_COLORS[sum(key.encode()) % len(IDENTICON_COLORS)]
    initial = (name or email or "?").strip()[:1].upper() or "?"
    return rect(text(initial, font_size=size * 0.55, bold=True,
                     color=(1, 1, 1, 0.92)),
                width=size, height=size, radius=size / 2, fill=color,
                align="center")


def _pills_for(tab, commit: CommitInfo) -> list[El]:
    pills: list[El] = []

    def pill(label: str, color, outline_only: bool = False):
        pills.append(rect(
            text(label, font_size=10, color=(1, 1, 1, 0.95) if not outline_only
                 else color, bold=True),
            fill=(color[0], color[1], color[2], 0.28) if outline_only else
            (color[0], color[1], color[2], 0.85),
            border=color, border_width=1.0,
            radius=T.radius_pill, padding=(1, 6, 1, 6), height=16))

    if tab.pinned_oid and commit.oid == tab.pinned_oid:
        pill("PINNED", T.pill_worktree)
    if commit.is_orphan:
        pill("ORPHAN", T.pill_orphan, outline_only=True)
    if commit.synthetic_worktree:
        pill(f"WT:{commit.synthetic_worktree}", T.pill_worktree,
             outline_only=True)
    head = tab.head_oid
    for tip in tab.branch_tips:
        if tip.oid != commit.oid:
            continue
        if tip.is_remote:
            pill(tip.name, T.pill_remote)
        elif tip.is_head:
            pill(tip.name, T.pill_head)
        else:
            pill(tip.name, T.pill_local)
    for tag in tab.tags:
        if tag.oid == commit.oid:
            pill(tag.name, T.pill_tag)
    if head and commit.oid == head and not any(
            t.is_head and t.oid == head for t in tab.branch_tips):
        pill("HEAD", T.pill_head)  # detached
    return pills[:5]


def _ci_dots(tab, commit: CommitInfo) -> Optional[El]:
    rollup = tab.ci_rollups.get(commit.oid)
    if rollup is None:
        return None
    dots = []
    color_map = {"success": T.success, "failure": T.danger,
                 "pending": T.warning}
    for state in getattr(rollup, "states", []):
        c = color_map.get(state, T.text_muted)
        dots.append(rect(width=6, height=6, radius=3, fill=c))
    if not dots:
        return None
    return row(*dots, gap=3, align="center")


# Built-row El memo: rows are content-addressed (see cache_key below), so
# while scrolling the same El object is replayed frame after frame, letting
# the layout/scene subtree caches hit without even rebuilding the El tree.
_ROW_EL_MEMO: dict = {}


def build_row(tab, index: int, segments_by_row: dict,
              show_avatars: bool = True, now: Optional[int] = None,
              avatar_cache=None) -> El:
    """One history row (reference: commit_graph.rs:981-1195): graph cell |
    pills | summary | chip | author | CI | relative time."""
    commit = tab.commits[index]
    layout = tab.graph_layout
    rh = layout.row_heights[index] if index < len(layout.row_heights) else 28.0
    row_top = layout.row_tops[index] if index < len(layout.row_tops) else 0.0
    graph_w = max(layout.graph_width(), LANE_WIDTH)

    selected = commit.oid == tab.selected_oid
    dimmed = (tab.search_active and tab.search_query
              and not commit_matches_query(commit, tab.search_query))
    avatar_arr = (avatar_cache.get(commit.author_email)
                  if (avatar_cache is not None and show_avatars
                      and not commit.is_synthetic) else None)
    rel_time = format_relative_time(commit.timestamp, now)
    rollup = tab.ci_rollups.get(commit.oid)
    # Content-addressed cache key: everything that affects this row's
    # pixels. Lets the layout pass and scene compiler replay the row from
    # cache while scrolling (see ui.layout/_render docs).
    lv = getattr(tab, "layout_version", 0)
    # Per-(layout_version) STATIC key prefix per row index: oid, stats,
    # row height, ref pills, pin — none of it changes between frames of
    # one layout, and this key is assembled for every visible row every
    # frame, so the per-frame work must be only the volatile parts
    # (selection, search dim, time bucket, avatar, CI).
    sgen = (lv, getattr(tab, "stats_version", 0), tab.pinned_oid,
            show_avatars)
    skey_memo = getattr(tab, "_row_skey_memo", None)
    if skey_memo is None or skey_memo[0] != sgen:
        tips_by_oid: dict = {}
        for tip in tab.branch_tips:
            tips_by_oid.setdefault(tip.oid, []).append(
                (tip.name, tip.is_remote, tip.is_head))
        tags_by_oid: dict = {}
        for t in tab.tags:
            tags_by_oid.setdefault(t.oid, []).append(t.name)
        ref_memo = (lv, {k: tuple(v) for k, v in tips_by_oid.items()},
                    {k: tuple(v) for k, v in tags_by_oid.items()})
        tab._row_ref_memo = ref_memo
        skey_memo = (sgen, {})
        tab._row_skey_memo = skey_memo
    ref_memo = tab._row_ref_memo
    static_key = skey_memo[1].get(index)
    if static_key is None:
        static_key = (
            "history-row", commit.oid, index % 2,
            commit.additions, commit.deletions, rh,
            (tab.tab_id, lv),  # new layout → new prims
            ref_memo[1].get(commit.oid, ()),
            ref_memo[2].get(commit.oid, ()),
            commit.oid == tab.pinned_oid, show_avatars,
        )
        skey_memo[1][index] = static_key
    # Compare-range membership wash: EXACT rev-list set (an index
    # interval would mark interleaved other-branch commits the compare
    # diff excludes). design_feedback_feb2026.md:492 selection model.
    in_range = (tab.compare_range is not None
                and commit.oid in tab.compare_set)
    cache_key = (
        static_key, selected, bool(dimmed), in_range,
        id(avatar_arr) if avatar_arr is not None else None,
        tuple(getattr(rollup, "states", ()) or ()),
        rel_time,
    )
    memo_hit = _ROW_EL_MEMO.pop(cache_key, None)
    if memo_hit is not None:
        _ROW_EL_MEMO[cache_key] = memo_hit   # LRU re-insert
        return memo_hit

    # Graph cell prims in row-local coordinates.
    prims = []
    for seg in segments_by_row.get(index, ()):
        color = LANE_COLORS[min(seg.lane, MAX_VISIBLE_LANES - 1)
                            % len(LANE_COLORS)]
        if seg.kind == "vline":
            x, y0, y1 = seg.data
            prims.append(("vline", x, y0 - row_top, y1 - row_top, 2.0, color))
        elif seg.kind == "cubic":
            pts = [(p[0], p[1] - row_top) for p in seg.data]
            prims.append(("cubic", *pts, 2.0, color))
        else:  # node
            cx, cy = seg.data
            node_color = (T.pill_orphan if commit.is_orphan else
                          T.pill_worktree if commit.is_synthetic else color)
            r = _node_radius(commit) + (1.0 if commit.oid == tab.selected_oid
                                        else 0.0)
            tone = (None if commit.is_synthetic or commit.is_orphan
                    else _delta_tone(commit))
            # "The Comet" (design_feedback_feb2026.md:348-356): a tapered
            # fading tail toward the parent, longer/brighter with commit
            # size — drawn under the node so the joint stays clean.
            if (not commit.is_synthetic and commit.parents
                    and commit.additions is not None):
                tail = min(2.0 * _node_radius(commit), rh - (cy - row_top))
                c = node_color
                for frac, w, a in ((0.45, 3.8, 0.55), (0.75, 2.6, 0.30),
                                   (1.0, 1.6, 0.14)):
                    prims.append(("vline", cx, cy - row_top,
                                  cy - row_top + tail * frac, w,
                                  (c[0], c[1], c[2], a)))
            if tone is not None:
                # Dual-tone: +/- ratio ring around the lane-colored core.
                prims.append(("circle", cx, cy - row_top, r, tone))
                prims.append(("circle", cx, cy - row_top, max(r - 2.0, 2.0),
                              node_color))
            else:
                prims.append(("circle", cx, cy - row_top, r, node_color))

    opacity = 0.3 if dimmed else 1.0

    zebra = (T.surface if index % 2 == 1 else T.background)
    bg = (T.surface_hover if selected else
          (0.92, 0.75, 0.25, 0.10) if commit.is_synthetic else
          (T.accent[0], T.accent[1], T.accent[2], 0.10) if in_range
          else zebra)

    # Graph column shadow: a 3-step alpha falloff on the right edge of
    # the lane area (reference README: "Graph column shadow on right edge
    # of lane area") — separates the lanes from the subject column.
    shadow = row(
        spacer(),
        rect(width=3, height="fill", fill=(0, 0, 0, 0.04)),
        rect(width=2, height="fill", fill=(0, 0, 0, 0.08)),
        rect(width=1, height="fill", fill=(0, 0, 0, 0.12)),
        width="fill", height="fill")
    cells: list[El] = []
    if not commit.is_synthetic:
        # Author strip: 3 px color strip keyed by author hash — ownership
        # patterns and handoffs at a glance (design_feedback_feb2026.md:169;
        # same 8-color hash as the identicon fallback).
        akey = commit.author_email or commit.author_name or "?"
        ac = IDENTICON_COLORS[sum(akey.encode()) % len(IDENTICON_COLORS)]
        cells.append(rect(width=3, height="fill",
                          fill=(ac[0], ac[1], ac[2], 0.55)))
    else:
        cells.append(rect(width=3, height="fill"))
    cells.append(stack(path(prims, width=graph_w + 8, height=rh),
                       shadow, width=graph_w + 8, height=rh))
    pills = _pills_for(tab, commit)
    mid: list[El] = []
    if pills:
        mid.append(row(*pills, gap=4, align="center"))
    summary_color = ((0.92, 0.75, 0.25, 1.0) if commit.is_synthetic
                     else T.text)
    kind = None if commit.is_synthetic else commit_kind(commit.summary)
    if kind is not None:
        # Auto-tagging without user input (design_feedback_feb2026.md:
        # 427): the conventional-commit prefix token renders in its
        # category color; the message text stays untouched.
        head_len, cat_color = kind
        mid.append(row(
            text(commit.summary[:head_len], color=cat_color,
                 font_size=T.font_size, opacity=opacity, bold=True),
            text(commit.summary[head_len:90], color=summary_color,
                 font_size=T.font_size, opacity=opacity, ellipsis=True),
            gap=0, align="center"))
    else:
        mid.append(text(commit.summary[:90], color=summary_color,
                        font_size=T.font_size, opacity=opacity,
                        ellipsis=True))
    cells.append(row(*mid, gap=6, align="center", flex=1, clip=True))

    right: list[El] = []
    if commit.additions is not None and not commit.is_synthetic:
        right.append(rect(
            text(f"+{commit.additions} −{commit.deletions}", font_size=10,
                 color=T.text_muted),
            fill=(1, 1, 1, 0.06), radius=4, padding=(1, 5, 1, 5)))
    if not commit.is_synthetic:
        if show_avatars:
            # Real Gravatar when the cache has it; identicon fallback
            # (reference: identicon fallback avatars, commit_graph.rs:83).
            if avatar_arr is not None:
                from ...ui import image
                right.append(image(avatar_arr, width=20, height=20))
            else:
                right.append(identicon(commit.author_email,
                                       commit.author_name))
        right.append(text(commit.author_name[:20], color=T.text_muted,
                          font_size=T.font_size_small, opacity=opacity))
    dots = _ci_dots(tab, commit)
    if dots is not None:
        right.append(dots)
    right.append(text(rel_time, color=T.text_muted,
                      font_size=T.font_size_small, opacity=opacity))
    cells.append(row(*right, gap=8, align="center"))

    el = rect(
        row(*cells, gap=8, align="center", width="fill", height="fill",
            padding=(0, 10, 0, 0)),  # flush left: the author strip sits
                                     # on the row edge
        width="fill", height=rh, fill=bg,
        route=None if commit.is_synthetic else f"select-commit:{commit.oid}",
        route_right=None if commit.is_synthetic else f"menu-commit:{commit.oid}",
        key=f"commit:{commit.oid}", cache_key=cache_key)
    while len(_ROW_EL_MEMO) > 4096:
        _ROW_EL_MEMO.pop(next(iter(_ROW_EL_MEMO)))
    _ROW_EL_MEMO[cache_key] = el
    return el


def history_view(tab, show_avatars: bool = True,
                 now: Optional[int] = None, avatar_cache=None,
                 search_focused: bool = False,
                 search_cursor: Optional[int] = None,
                 search_anchor: Optional[int] = None) -> El:
    """The virtualized history list (reference: commit_graph.rs:1308)."""
    if not tab.commits:
        label = ("Loading…" if not tab.initial_refresh_done
                 else "No commits yet")
        return rect(text(label, color=T.text_muted),
                    fill=T.background, width="fill", height="fill",
                    align="center", key="history")

    # Segment binning + heights only change when a refresh swaps the graph
    # layout (layout_version); memo on the tab keeps steady-state scrolling
    # free of the O(segments) rebuild.
    lv = getattr(tab, "layout_version", 0)
    cached = getattr(tab, "_segments_memo", None)
    if cached is not None and cached[0] == lv:
        segments_by_row, heights = cached[1], cached[2]
    else:
        segments_by_row = defaultdict(list)
        for seg in tab.graph_segments:
            segments_by_row[seg.row].append(seg)
        heights = list(tab.graph_layout.row_heights)
        tab._segments_memo = (lv, segments_by_row, heights)
    if now is None:
        import time as _t
        # Minute granularity: relative times stay fresh while row cache
        # keys stay stable between frames.
        now = int(_t.time() // 60 * 60)

    def build(i: int) -> El:
        return build_row(tab, i, segments_by_row, show_avatars, now,
                         avatar_cache)

    body = scroll(len(tab.commits), build, offset=tab.history_scroll,
                  row_heights=heights, width="fill", flex=1,
                  key="history-scroll")
    # Proportional scrollbar thumb (reference: scrollbars with
    # proportional thumb; drag is pointer-only, keyboard PageUp/Down here).
    total_h = tab.graph_layout.total_height
    if total_h > 700:
        track_h = 600.0  # nominal viewport track; fractions scale with it
        frac_view = min(1.0, track_h / total_h)
        frac_pos = min(1.0 - frac_view,
                       tab.history_scroll / max(total_h, 1.0))
        # Content-quantize the thumb geometry (1 px steps): volatile
        # elements with CONTINUOUS per-frame values defeat the dyn-pack/
        # blob caches — one numpy re-bin + device upload every frame
        # (measured; docs/performance.md cache rules). Sub-pixel thumb
        # motion is invisible at a 6 px thumb.
        frac_pos = round(frac_pos * track_h) / track_h
        thumb = rect(width=6, height=round(max(30.0, frac_view * track_h)),
                     radius=3, fill=(1, 1, 1, 0.14),
                     route_drag="scroll-drag:history",
                     key="history-scrollbar", volatile=True)
        overlay = row(
            spacer(),
            column(rect(width=6, height=frac_pos * track_h),
                   thumb, width=10),
            width="fill", height="fill")
        body = stack(body, overlay, width="fill", flex=1)

    parts: list[El] = []
    if tab.search_active:
        q = tab.search_query
        # Blinking caret at the edit position (reference README:
        # "Blinking cursor in search input").
        if search_focused and q and search_anchor is not None:
            from .widgets import input_text_el

            shown = None
            # Same size as the other branches' text() default — a
            # selection must not visibly shrink the query line.
            search_el = input_text_el(q, search_cursor, search_anchor,
                                      cursor_visible(), T.text,
                                      T.font_size)
        elif search_focused and cursor_visible():
            shown = insert_caret(q, search_cursor) if q \
                else "▏type to filter…"
        else:
            shown = q or "type to filter…"
        if shown is None:
            inner = search_el  # selection-highlighted run (see above)
        else:
            inner = text(shown, color=T.text if q else T.text_muted)
        parts.append(rect(
            row(text("/", color=T.accent, bold=True), inner,
                gap=6, align="center"),
            fill=T.surface_raised, border=T.accent, border_width=1,
            radius=4, padding=(4, 8, 4, 8), width="fill", height=28,
            key="search-bar", route="focus-input:search"))
    parts.append(body)
    return rect(column(*parts, width="fill", height="fill"),
                fill=T.background, width="fill", height="fill",
                clip=True, key="history", route="focus-graph")
