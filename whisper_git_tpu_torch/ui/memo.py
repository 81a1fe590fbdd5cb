"""Content-addressed El memoization for chrome panels.

Views are pure `state -> El` composers rebuilt every frame (reference:
aetna's immediate rebuild, ui_app.rs:563-740). Panels whose inputs rarely
change between frames (sidebar, staging well, header, tab bar) memoize the
built El by a key covering every pixel-affecting input; the same El object
then replays through the layout subtree cache (`ui.layout`) and the scene
compiler's chunk cache (`render.scene`), so steady-state frames skip the
build + layout + emit cost for the whole panel.
"""

from __future__ import annotations

from typing import Callable

from .el import El

_EL_MEMO: dict = {}
_MAX_ENTRIES = 4096


def memo_el(key: tuple, builder: Callable[[], El]) -> El:
    """Return the cached El for `key`, building (and tagging it with
    cache_key=key so layout/scene caches also hit) on miss.

    LRU, not wipe-at-cap: keys embed per-keystroke inputs (the staging
    panel keys on the message cursor), so dead entries accumulate; a
    wholesale clear() at the cap also evicted the HOT sidebar/header
    entries, forcing a full rebuild burst. Python dicts iterate in
    insertion order, so hit-re-insert + pop-oldest is an LRU."""
    el = _EL_MEMO.pop(key, None)
    if el is None:
        el = builder()
        el.cache_key = key
        while len(_EL_MEMO) >= _MAX_ENTRIES:
            _EL_MEMO.pop(next(iter(_EL_MEMO)))
    _EL_MEMO[key] = el
    return el


def clear() -> None:
    _EL_MEMO.clear()
