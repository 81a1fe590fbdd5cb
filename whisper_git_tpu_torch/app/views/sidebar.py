"""Branch sidebar: collapsible LOCAL / REMOTE / TAGS / SUBMODULES /
WORKTREES / STASHES sections with count badges, per-remote grouping,
current-branch highlight, create affordances and context-menu routes.

Capability parity with reference src/sidebar.rs (+ README feature list:
six sections, keyboard nav, ahead/behind, delete affordances).
"""

from __future__ import annotations

from collections import defaultdict

from ...ui import El, column, rect, row, scroll, spacer, stack, text
from ...ui.memo import memo_el
from ...ui.theme import DARK as T

SECTIONS = ["local", "remote", "tags", "submodules", "worktrees", "stashes"]
ITEM_H = 26.0  # uniform row pitch (24 px row + 2 px gap)


def item_h(tab) -> float:
    """Row pitch honoring the Row Size setting (reference README.md:117:
    "Row Size: Normal or Large (1.5×)"); keyboard auto-scroll in ui_app
    uses the same pitch so hit targets and scroll math stay aligned."""
    return ITEM_H * getattr(tab, "row_scale", 1.0)


def branch_health(tab, oid: str, is_head: bool) -> float:
    """Branch staleness → label opacity (adapted from the reference
    design review's "Branch Health" line styling,
    design_feedback_feb2026.md:173-181): active full, aging 0.8,
    stale 0.55, abandoned/off-walk 0.35. HEAD is always active."""
    import time as _time

    if is_head:
        return 1.0
    ts_map = getattr(tab, "_tip_ts_memo", None)
    lv = getattr(tab, "layout_version", 0)
    if ts_map is None or ts_map[0] != lv:
        ts_map = (lv, {c.oid: c.timestamp for c in tab.commits
                       if not c.is_synthetic})
        tab._tip_ts_memo = ts_map
    ts = ts_map[1].get(oid)
    if ts is None:
        return 0.35  # older than the 1000-commit walk: abandoned
    age = _time.time() - ts
    if age < 7 * 86400:
        return 1.0
    if age < 28 * 86400:
        return 0.8
    if age < 90 * 86400:
        return 0.55
    return 0.35


def _sidebar_key(tab) -> tuple:
    """Every pixel-affecting input of the sidebar panel."""
    return (
        "sidebar", tab.tab_id,
        tuple((t.name, t.is_remote, t.is_head, t.ahead, t.behind,
               branch_health(tab, t.oid, t.is_head))
              for t in tab.branch_tips),
        tuple(sorted((br, p.number, p.draft)
                     for br, p in tab.pr_by_branch.items())),
        tuple((t.name, t.oid) for t in tab.tags),
        tuple((s.name, s.path, s.initialized,
               tab.submodule_dirty.get(s.path, False))
              for s in tab.submodules),
        tuple((w.name, w.path, w.branch, w.is_main,
               bool(tab.worktree_views.get(w.path)
                    and tab.worktree_views[w.path].dirty))
              for w in tab.worktrees),
        tuple((s.ref_name, s.summary) for s in tab.stashes),
        tuple(sorted(tab.sidebar_collapsed.items())),
        tab.selected_sidebar_key, tab.active_worktree,
        round(tab.sidebar_scroll, 1), getattr(tab, "row_scale", 1.0),
    )


def _section_header(tab, key: str, label: str, count: int,
                    create_route: str | None = None) -> El:
    collapsed = tab.sidebar_collapsed.get(key, False)
    row_h = 24.0 * getattr(tab, "row_scale", 1.0)
    arrow = "▸" if collapsed else "▾"
    items = [
        text(f"{arrow} {label}", font_size=11, bold=True, color=T.text_muted),
        rect(text(str(count), font_size=10, color=T.text_muted),
             fill=(1, 1, 1, 0.08), radius=7, padding=(0, 5, 0, 5)),
        spacer(),
    ]
    if create_route:
        items.append(rect(text("+", color=T.text_muted, font_size=12),
                          route=create_route, radius=4,
                          padding=(0, 4, 0, 4),
                          hover_fill=T.surface_hover))
    return rect(row(*items, gap=6, align="center", width="fill"),
                fill=T.surface_raised, radius=4, width="fill", height=row_h,
                padding=(2, 6, 2, 6), route=f"sidebar-toggle:{key}",
                key=f"sidebar-section:{key}")


def _item_row(label: str, route: str, *, selected=False, current=False,
              badge: str = "", dirty=False, route_right: str | None = None,
              muted=False, pr=None, row_h: float = 24.0,
              health: float = 1.0) -> El:
    fg = (T.accent if current else T.text_muted if muted else T.text)
    cells: list[El] = []
    if current:
        cells.append(rect(width=3, height="fill", fill=T.accent, radius=1))
    cells.append(text(label[:34], font_size=T.font_size, color=fg,
                      bold=current, opacity=health))
    if dirty:
        cells.append(rect(width=7, height=7, radius=3.5, fill=T.warning))
    if pr is not None:
        # Open-PR pill (beyond-reference: PR integration is Deferred in
        # the reference's user_needs.md). Drafts render dimmed.
        tint = T.info
        cells.append(rect(
            text(f"#{pr.number}", font_size=10, bold=True,
                 color=T.text_bright),
            fill=(tint[0], tint[1], tint[2], 0.22 if pr.draft else 0.4),
            radius=7, padding=(0, 5, 0, 5)))
    cells.append(spacer())
    if badge:
        cells.append(text(badge, font_size=10, color=T.text_muted))
    return rect(row(*cells, gap=6, align="center", width="fill",
                    height="fill"),
                width="fill", height=row_h, radius=4,
                fill=T.surface_hover if selected else None,
                hover_fill=T.surface_hover,
                padding=(2, 6, 2, 8), route=route, route_right=route_right,
                key=route)


def sidebar(tab) -> El:
    """reference: sidebar.rs:18. Memoized per content (ui.memo)."""
    return memo_el(_sidebar_key(tab), lambda: _sidebar_impl(tab))


def _sidebar_impl(tab) -> El:
    import functools

    rows: list[El] = []
    _item = functools.partial(_item_row,
                              row_h=24.0 * getattr(tab, "row_scale", 1.0))

    local = [t for t in tab.branch_tips if not t.is_remote]
    rows.append(_section_header(tab, "local", "LOCAL", len(local),
                                "open-branch-dialog"))
    if not tab.sidebar_collapsed.get("local", False):
        for tip in local:
            badge = ""
            if tip.ahead or tip.behind:
                parts = []
                if tip.ahead:
                    parts.append(f"↑{tip.ahead}")
                if tip.behind:
                    parts.append(f"↓{tip.behind}")
                badge = " ".join(parts)
            rows.append(_item(
                tip.name, f"checkout-branch:{tip.name}",
                current=tip.is_head,
                selected=tab.selected_sidebar_key == f"branch:{tip.name}",
                badge=badge, route_right=f"menu-branch:{tip.name}",
                pr=tab.pr_by_branch.get(tip.name),
                health=branch_health(tab, tip.oid, tip.is_head)))

    remotes = [t for t in tab.branch_tips if t.is_remote]
    by_remote: dict[str, list] = defaultdict(list)
    for tip in remotes:
        remote = tip.name.split("/", 1)[0]
        by_remote[remote].append(tip)
    rows.append(_section_header(tab, "remote", "REMOTE", len(remotes)))
    if not tab.sidebar_collapsed.get("remote", False):
        for remote in sorted(by_remote):
            gkey = f"remote-group:{remote}"
            collapsed = tab.sidebar_collapsed.get(gkey, False)
            rows.append(_item(("▸ " if collapsed else "▾ ") + remote,
                              f"sidebar-toggle:{gkey}", muted=True))
            if not collapsed:
                for tip in by_remote[remote]:
                    rows.append(_item(
                        "  " + tip.name.split("/", 1)[1],
                        f"checkout-remote:{tip.name}",
                        selected=tab.selected_sidebar_key == f"remote:{tip.name}",
                        route_right=f"menu-remote-branch:{tip.name}",
                        health=branch_health(tab, tip.oid, False)))

    rows.append(_section_header(tab, "tags", "TAGS", len(tab.tags),
                                "open-tag-dialog"))
    if not tab.sidebar_collapsed.get("tags", False):
        for tag in tab.tags:
            rows.append(_item(tag.name, f"jump-to:{tag.oid}",
                              selected=tab.selected_sidebar_key == f"tag:{tag.name}",
                              route_right=f"menu-tag:{tag.name}"))

    rows.append(_section_header(tab, "submodules", "SUBMODULES",
                                len(tab.submodules)))
    if not tab.sidebar_collapsed.get("submodules", False):
        for sub in tab.submodules:
            rows.append(_item(sub.name, f"enter-submodule:{sub.path}",
                              dirty=tab.submodule_dirty.get(sub.path, False),
                              route_right=f"menu-submodule:{sub.path}",
                              muted=not sub.initialized))

    rows.append(_section_header(tab, "worktrees", "WORKTREES",
                                len(tab.worktrees),
                                "open-worktree-dialog"))
    if not tab.sidebar_collapsed.get("worktrees", False):
        for wt in tab.worktrees:
            view = tab.worktree_views.get(wt.path)
            rows.append(_item(
                wt.name + (" (main)" if wt.is_main else ""),
                f"select-worktree:{wt.path}",
                current=wt.path == tab.active_worktree,
                selected=tab.selected_sidebar_key
                == f"worktree:{wt.path}",
                dirty=bool(view and view.dirty),
                badge=wt.branch or "detached",
                route_right=f"menu-worktree:{wt.path}"))

    rows.append(_section_header(tab, "stashes", "STASHES", len(tab.stashes)))
    if not tab.sidebar_collapsed.get("stashes", False):
        for st in tab.stashes:
            rows.append(_item(st.summary[:30], f"apply-stash:{st.ref_name}",
                              selected=tab.selected_sidebar_key
                              == f"stash:{st.ref_name}",
                              route_right=f"menu-stash:{st.ref_name}"))

    # Virtualized + scrollable with a proportional thumb (reference README:
    # "Scrollbar with proportional thumb and auto-scroll on keyboard
    # navigation"); tall repos (many branches/tags) stay reachable.
    ih = item_h(tab)
    total_h = len(rows) * ih
    body = scroll(len(rows), lambda i: rows[i],
                  offset=tab.sidebar_scroll,
                  row_heights=[ih] * len(rows),
                  width="fill", height="fill", key="sidebar-scroll")
    content: El = body
    track_h = 560.0
    if total_h > track_h:
        frac_view = min(1.0, track_h / total_h)
        frac_pos = min(1.0 - frac_view,
                       tab.sidebar_scroll / max(total_h, 1.0))
        # Content-quantize (1 px): continuous volatile geometry defeats
        # the per-frame dyn-pack/blob caches (docs/performance.md).
        thumb_y = round(frac_pos * track_h)
        thumb_h = round(max(24.0, frac_view * track_h))
        overlay = row(
            spacer(),
            column(rect(width=5, height=thumb_y),
                   rect(width=5, height=thumb_h,
                        radius=2.5, fill=(1, 1, 1, 0.14),
                        route_drag="scroll-drag:sidebar",
                        key="sidebar-scrollbar", volatile=True),
                   width=8),
            width="fill", height="fill")
        content = stack(body, overlay, width="fill", height="fill")
    return rect(content, fill=T.surface, width="fill", height="fill",
                clip=True, padding=(6, 2, 6, 6),
                key="sidebar", route="focus-sidebar")
