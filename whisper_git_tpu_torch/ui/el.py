"""The El tree — declarative retained-mode scene description.

The rebuild's equivalent of aetna's `El` (the reference's views are pure
`fn(&state) -> El` composers; ours are pure `def view(state) -> El`). The
tree is rebuilt every frame, laid out by `ui.layout`, painted by the TPU
rasterizer, and hit-tested by the Runner for string-routed actions
(reference: string-keyed action routing, ui_app.rs:1004).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Union

Color = tuple  # (r, g, b, a) floats 0-1

AUTO = "auto"
FILL = "fill"
Size = Union[float, str]  # px | AUTO | FILL


@dataclass
class El:
    kind: str  # column | row | stack | rect | text | spacer | image | path | scroll
    children: list["El"] = field(default_factory=list)
    # Layout
    width: Size = AUTO
    height: Size = AUTO
    flex: float = 0.0           # >0: share of remaining space on main axis
    padding: tuple = (0.0, 0.0, 0.0, 0.0)  # t, r, b, l
    gap: float = 0.0
    align: str = "start"        # cross-axis: start | center | end | stretch
    justify: str = "start"      # main-axis: start | center | end | between
    # Paint
    fill: Optional[Color] = None
    border: Optional[Color] = None
    border_width: float = 1.0
    radius: float = 0.0
    shadow: bool = False
    clip: bool = False
    opacity: float = 1.0
    # Text
    text: str = ""
    color: Optional[Color] = None
    font_size: float = 13.0
    bold: bool = False
    wrap: bool = False
    # Elide-to-fit: at emit time the run is cut to the laid-out width
    # with a trailing '…' instead of clipping mid-glyph (the aetna-lint
    # TextOverflow rule treats ellipsis texts as self-clamping).
    ellipsis: bool = False
    # Path (vector geometry in local coords): list of primitives
    #   ("vline", x, y0, y1, width, color) | ("cubic", p0..p3, width, color)
    #   | ("circle", cx, cy, r, color)
    prims: list = field(default_factory=list)
    # Image: (H, W, 4) uint8 numpy array (avatar tile etc.)
    image_data: object = None
    # Interaction
    route: Optional[str] = None        # click action id
    route_right: Optional[str] = None  # right-click action id
    route_double: Optional[str] = None  # double-click action id
    # Drag action id: while the pointer is held after pressing on this
    # element, each move dispatches "<route_drag>:<dx>:<dy>" (pane
    # dividers, scrollbar thumbs — reference: drag-resizable dividers,
    # scrollbar drag support).
    route_drag: Optional[str] = None
    hover_fill: Optional[Color] = None
    key: Optional[str] = None          # stable identity (focus, scroll)
    # Content-addressed cache key: when set, the layout pass and scene
    # compiler may reuse this subtree's origin-relative results across
    # frames (rows set it to a hash of everything that affects pixels).
    cache_key: Optional[tuple] = None
    focusable: bool = False
    # Volatile: this subtree's pixels change continuously (scrollbar
    # thumbs, drag ghosts). The scene compiler routes volatile commands to
    # the layer's dynamic tail so the static chrome prefix stays
    # byte-stable across scroll frames (the render frame-cache keys on it).
    # Volatile content must be topmost within its layer at its pixels.
    volatile: bool = False
    # Horizontal content offset (any container kind): children lay out
    # shifted left by this many px while the clip stays at the element's
    # rect — the diff viewer's h-scroll. An El carrying scroll_x inside a
    # cache_key subtree must fold scroll_x into that key.
    scroll_x: float = 0.0
    # Scroll (kind == "scroll")
    scroll_offset: float = 0.0
    virtual_row_count: int = 0
    virtual_row_heights: Optional[list] = None  # None → uniform
    virtual_build: object = None  # fn(index) -> El, materialized lazily

    def with_(self, **kw) -> "El":
        return replace(self, **kw)


def column(*children: El, **kw) -> El:
    return El("column", children=list(children), **kw)


def row(*children: El, **kw) -> El:
    return El("row", children=list(children), **kw)


def stack(*children: El, **kw) -> El:
    """Overlay: children occupy the same rect, painted in order."""
    return El("stack", children=list(children), **kw)


def rect(*children: El, **kw) -> El:
    return El("rect", children=list(children), **kw)


def text(content: str, **kw) -> El:
    return El("text", text=content, **kw)


def spacer(size: Size = FILL, **kw) -> El:
    if size == FILL:
        return El("spacer", flex=1.0, **kw)
    return El("spacer", width=size, height=size, **kw)


def image(data, **kw) -> El:
    return El("image", image_data=data, **kw)


def path(prims: list, **kw) -> El:
    return El("path", prims=prims, **kw)


def scroll(row_count: int, build, offset: float = 0.0,
           row_heights: Optional[list] = None, **kw) -> El:
    """Virtualized list (the reference's virtual_list_dyn): only rows
    intersecting the viewport are materialized at layout time."""
    return El("scroll", virtual_row_count=row_count, virtual_build=build,
              scroll_offset=offset, virtual_row_heights=row_heights,
              clip=True, **kw)


def insert_caret(value: str, cursor, caret: str = "▏") -> str:
    """Place the caret glyph at `cursor` (None → end) within `value`.
    Bidi/Arabic input routes through the visual caret map
    (render/shaping.caret_insert_visual): the caret renders at the
    exact visual slot for the logical index, without breaking the
    joining context around it."""
    from ..render.shaping import caret_insert_visual, needs_shaping

    if needs_shaping(value):
        return caret_insert_visual(value, cursor, caret)
    if cursor is None:
        return value + caret
    c = max(0, min(int(cursor), len(value)))
    return value[:c] + caret + value[c:]
