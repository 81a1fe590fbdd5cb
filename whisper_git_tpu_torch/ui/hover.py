"""Hover restyling — paint `El.hover_fill` on the pointed-at element.

The reference repaints hovered buttons/rows through aetna's hover state
(README: "Hover highlighting on buttons, sidebar items, file list items,
and graph rows"). Here the Runner tracks the hovered route
(`Runner.pointer_move`) and the app applies it at build time: the built
tree is rewritten copy-on-write along the spine to the hovered node, which
gets `fill = hover_fill` (and a hover-disambiguated cache key, so the
layout/scene subtree caches never replay the un-hovered pixels).
"""

from __future__ import annotations

from typing import Optional

from .el import El


def _find_path(el: El, route: str, path: list) -> bool:
    """Depth-first: true when `el` or a descendant routes `route` with a
    hover fill; `path` receives (parent, child-index) pairs root-first."""
    if el.route == route and el.hover_fill is not None:
        return True
    for i, child in enumerate(el.children):
        path.append((el, i))
        if _find_path(child, route, path):
            return True
        path.pop()
    # Virtualized children are materialized at layout time and cannot be
    # restyled here; scroll rows that want hover use selection routes.
    return False


def apply_hover(tree: El, route: Optional[str]) -> El:
    """Return `tree` with the hovered element's fill swapped to its
    hover_fill. Copy-on-write: only the spine to the hovered node is
    copied, so memoized sibling subtrees keep their identity (and their
    layout/scene caches)."""
    if not route:
        return tree
    path: list = []
    if tree.route == route and tree.hover_fill is not None:
        target = tree
    else:
        if not _find_path(tree, route, path):
            return tree
        target = path[-1][0].children[path[-1][1]]
    hovered = target.with_(
        fill=target.hover_fill,
        cache_key=((*target.cache_key, "hover")
                   if target.cache_key is not None else None))
    if target is tree:
        return hovered
    node = hovered
    for parent, idx in reversed(path):
        kids = list(parent.children)
        kids[idx] = node
        node = parent.with_(
            children=kids,
            cache_key=((*parent.cache_key, "hover", route)
                       if parent.cache_key is not None else None))
    return node
