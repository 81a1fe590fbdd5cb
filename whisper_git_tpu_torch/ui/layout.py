"""Layout pass: resolve the El tree to absolutely-positioned LayoutNodes.

Flexbox-ish single-axis layout like aetna's `Runner::prepare` layout step:
fixed sizes, auto (content-measured), and flex (share of remaining space);
padding/gap/align/justify; virtualized scroll lists materialize only the
visible rows (reference: virtual_list_dyn, commit_graph.rs:1449).
"""

from __future__ import annotations

from typing import Optional

from .el import FILL, El


class TextMeasurer:
    """Measures text extents. The default approximates a proportional font;
    the renderer swaps in real atlas metrics (same interface)."""

    # Rough advance ratios for a proportional font (fraction of font size).
    _NARROW = set("iljIft.,:;'|!()[]{} ")
    _WIDE = set("mwMW@")

    def width(self, s: str, size: float, bold: bool = False) -> float:
        w = 0.0
        for ch in s:
            if ch in self._NARROW:
                w += 0.30
            elif ch in self._WIDE:
                w += 0.85
            else:
                w += 0.58
        return w * size * (1.05 if bold else 1.0)

    def height(self, size: float) -> float:
        return size * 1.4


_DEFAULT_MEASURER = TextMeasurer()


class LayoutNode:
    """Absolutely-positioned node. Children of cache-replayed subtrees
    materialize lazily: the scene compiler replays those subtrees from
    its own chunk cache without ever touching children, so the clone cost
    is only paid on hit-testing or a first compile."""

    __slots__ = ("el", "x", "y", "w", "h", "clip", "_children", "_lazy")

    def __init__(self, el: El, x: float, y: float, w: float, h: float,
                 children: Optional[list] = None, clip: Optional[tuple]
                 = None):
        self.el = el
        self.x = x
        self.y = y
        self.w = w
        self.h = h
        self.clip = clip  # (x, y, w, h) inherited clip rect
        self._children: Optional[list] = children
        self._lazy: Optional[tuple] = None  # (template, dx, dy, clip)

    @property
    def children(self) -> list["LayoutNode"]:
        if self._children is None:
            if self._lazy is not None:
                tpl, dx, dy, clip = self._lazy
                self._children = [_shift_tree(c, dx, dy, clip)
                                  for c in tpl.children]
            else:
                self._children = []
        return self._children

    @children.setter
    def children(self, value: list) -> None:
        self._children = value

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def find_route_at(self, px: float, py: float, attr: str = "route"
                      ) -> Optional[str]:
        """Topmost route under a point (paint order = later wins)."""
        node = self.find_route_node_at(px, py, attr)
        return None if node is None else getattr(node.el, attr)

    def find_route_node_at(self, px: float, py: float,
                           attr: str = "route") -> Optional["LayoutNode"]:
        """Topmost routed NODE under a point (the Runner uses its rect
        for click-to-caret mapping inside text inputs)."""
        hit = None
        for node in self.walk():
            if getattr(node.el, attr) is None:
                continue
            if node.clip is not None:
                cx, cy, cw, ch = node.clip
                if not (cx <= px <= cx + cw and cy <= py <= cy + ch):
                    continue
            if node.x <= px <= node.x + node.w \
                    and node.y <= py <= node.y + node.h:
                hit = node
        return hit


def _fixed(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) else None


_MEASURE_MEMO: dict = {}


def _measure(el: El, avail_w: float, avail_h: float, m: TextMeasurer
             ) -> tuple[float, float]:
    """Intrinsic (content) size within the available box. Memoized per
    El instance within a frame (parents measure children once for sizing
    and again during placement)."""
    key = (id(el), avail_w, avail_h)
    hit = _MEASURE_MEMO.get(key)
    if hit is not None:
        return hit
    out = _measure_impl(el, avail_w, avail_h, m)
    _MEASURE_MEMO[key] = out
    return out


def _measure_impl(el: El, avail_w: float, avail_h: float, m: TextMeasurer
                  ) -> tuple[float, float]:
    fw, fh = _fixed(el.width), _fixed(el.height)
    if fw is not None and fh is not None:
        return fw, fh
    pt, pr, pb, pl = el.padding
    if el.kind == "text":
        if el.wrap and fw is None:
            lines = _wrap_lines(el.text, avail_w - pl - pr, el.font_size,
                                el.bold, m)
            w = max((m.width(l, el.font_size, el.bold) for l in lines),
                    default=0.0)
            h = m.height(el.font_size) * max(len(lines), 1)
        else:
            w = m.width(el.text, el.font_size, el.bold)
            h = m.height(el.font_size)
        return (fw if fw is not None else w + pl + pr,
                fh if fh is not None else h + pt + pb)
    if el.kind == "image":
        data = el.image_data
        ih = getattr(data, "shape", (32, 32))[0] if data is not None else 32
        iw = getattr(data, "shape", (32, 32, 4))[1] if data is not None else 32
        return (fw if fw is not None else float(iw),
                fh if fh is not None else float(ih))
    if el.kind == "spacer":
        return (fw or 0.0, fh or 0.0)
    if el.kind == "scroll":
        return (fw if fw is not None else avail_w,
                fh if fh is not None else avail_h)
    # Containers: measure children.
    inner_w = (fw if fw is not None else avail_w) - pl - pr
    inner_h = (fh if fh is not None else avail_h) - pt - pb
    main_is_x = el.kind == "row"
    total_main, max_cross = 0.0, 0.0
    n_vis = 0
    for c in el.children:
        cw, ch = _measure(c, inner_w, inner_h, m)
        n_vis += 1
        if el.kind in ("stack", "rect", "path"):
            max_cross = max(max_cross, ch)
            total_main = max(total_main, cw)
        elif main_is_x:
            total_main += cw
            max_cross = max(max_cross, ch)
        else:
            total_main += ch
            max_cross = max(max_cross, cw)
    if el.kind in ("column",):
        gap_total = el.gap * max(n_vis - 1, 0)
        w = (fw if fw is not None else max_cross + pl + pr)
        h = (fh if fh is not None else total_main + gap_total + pt + pb)
    elif el.kind == "row":
        gap_total = el.gap * max(n_vis - 1, 0)
        w = (fw if fw is not None else total_main + gap_total + pl + pr)
        h = (fh if fh is not None else max_cross + pt + pb)
    else:  # stack / rect / path
        w = (fw if fw is not None else total_main + pl + pr)
        h = (fh if fh is not None else max_cross + pt + pb)
    return w, h


def _wrap_lines(s: str, max_w: float, size: float, bold: bool,
                m: TextMeasurer) -> list[str]:
    if max_w <= 0:
        return s.split("\n")
    out: list[str] = []
    for para in s.split("\n"):
        words = para.split(" ")
        cur = ""
        for word in words:
            cand = word if not cur else cur + " " + word
            if m.width(cand, size, bold) <= max_w or not cur:
                cur = cand
            else:
                out.append(cur)
                cur = word
        out.append(cur)
    return out


def layout_tree(el: El, viewport: tuple[float, float],
                measurer: Optional[TextMeasurer] = None) -> LayoutNode:
    m = measurer or _DEFAULT_MEASURER
    vw, vh = viewport
    _MEASURE_MEMO.clear()  # per-frame scope (keyed by El identity)
    try:
        return _layout(el, 0.0, 0.0, vw, vh, None, m)
    finally:
        _MEASURE_MEMO.clear()


_SUBTREE_LAYOUT_CACHE: dict = {}


def _shift_tree(tpl: LayoutNode, dx: float, dy: float,
                clip: Optional[tuple]) -> LayoutNode:
    """Clone a cached origin-relative subtree to an absolute position.
    Template nodes hold coords relative to the subtree origin; internal
    clip rects shift and intersect with the inherited clip. Children are
    deferred (LayoutNode._lazy) — most replayed subtrees are consumed by
    the scene compiler's chunk cache, which never reads them."""
    if tpl.clip is None:
        new_clip = clip
    else:
        # LayoutNode.clip is (x, y, w, h) everywhere (producers:
        # _layout_impl/_layout_scroll; consumers: find_route_at, lint).
        # Shifting/intersecting it as corner coordinates corrupted
        # replayed subtrees' clips — hit-testing then reached invisible
        # overscan rows below memoized panels.
        nx0, ny0 = tpl.clip[0] + dx, tpl.clip[1] + dy
        nx1, ny1 = nx0 + tpl.clip[2], ny0 + tpl.clip[3]
        if clip is not None:
            nx0, ny0 = max(nx0, clip[0]), max(ny0, clip[1])
            nx1 = min(nx1, clip[0] + clip[2])
            ny1 = min(ny1, clip[1] + clip[3])
        new_clip = (nx0, ny0, max(nx1 - nx0, 0.0), max(ny1 - ny0, 0.0))
    node = LayoutNode(tpl.el, tpl.x + dx, tpl.y + dy, tpl.w, tpl.h,
                      clip=new_clip)
    node._lazy = (tpl, dx, dy, clip)
    return node


def _layout(el: El, x: float, y: float, w: float, h: float,
            clip: Optional[tuple], m: TextMeasurer) -> LayoutNode:
    if el.cache_key is not None:
        key = (el.cache_key, round(w, 1), round(h, 1))
        # LRU, not clear-at-cap: content keys carry minute-bucketed
        # timestamps, so a long session mints new entries every minute
        # per visible row — unbounded-until-20k was a measured RSS
        # creep (~MB/min). Hot steady-state entries stay resident.
        tpl = _SUBTREE_LAYOUT_CACHE.pop(key, None)
        if tpl is None:
            tpl = _layout_impl(el, 0.0, 0.0, w, h, None, m)
            while len(_SUBTREE_LAYOUT_CACHE) > 8192:
                _SUBTREE_LAYOUT_CACHE.pop(
                    next(iter(_SUBTREE_LAYOUT_CACHE)))
        _SUBTREE_LAYOUT_CACHE[key] = tpl
        return _shift_tree(tpl, x, y, clip)
    return _layout_impl(el, x, y, w, h, clip, m)


def _layout_impl(el: El, x: float, y: float, w: float, h: float,
                 clip: Optional[tuple], m: TextMeasurer) -> LayoutNode:
    node = LayoutNode(el, x, y, w, h, clip=clip)
    child_clip = (x, y, w, h) if el.clip else clip
    pt, pr, pb, pl = el.padding
    ix, iy = x + pl, y + pt
    iw, ih = max(w - pl - pr, 0.0), max(h - pt - pb, 0.0)
    if el.scroll_x:
        # Horizontal content offset: children shift left, clip stays put
        # (snapped to the 1/8-px command-quantization grid like scroll).
        ix -= round(el.scroll_x * 8.0) / 8.0

    if el.kind == "scroll":
        node.children = _layout_scroll(el, ix, iy, iw, ih, child_clip, m)
        return node
    if not el.children:
        return node

    if el.kind in ("stack", "rect", "path"):
        for c in el.children:
            cw, ch = _resolve_child_size(c, iw, ih, m)
            cx, cy = _align_in(c, ix, iy, iw, ih, cw, ch, el)
            node.children.append(_layout(c, cx, cy, cw, ch, child_clip, m))
        return node

    main_is_x = el.kind == "row"
    main_avail = iw if main_is_x else ih
    gap_total = el.gap * max(len(el.children) - 1, 0)
    remaining = main_avail - gap_total
    sizes: list[Optional[float]] = []
    flex_total = 0.0
    for c in el.children:
        fixed = _fixed(c.width if main_is_x else c.height)
        if c.flex > 0 or (c.width if main_is_x else c.height) == FILL:
            sizes.append(None)
            flex_total += max(c.flex, 1.0) if c.flex > 0 else 1.0
        elif fixed is not None:
            sizes.append(fixed)
            remaining -= fixed
        else:
            cw, ch = _measure(c, iw, ih, m)
            s = cw if main_is_x else ch
            sizes.append(s)
            remaining -= s
    remaining = max(remaining, 0.0)
    for i, c in enumerate(el.children):
        if sizes[i] is None:
            share = (max(c.flex, 1.0) if c.flex > 0 else 1.0) / max(flex_total, 1e-9)
            sizes[i] = remaining * share

    used = sum(sizes) + gap_total
    cursor = ix if main_is_x else iy
    if el.justify == "center":
        cursor += max((main_avail - used) / 2, 0.0)
    elif el.justify == "end":
        cursor += max(main_avail - used, 0.0)
    extra_gap = 0.0
    if el.justify == "between" and len(el.children) > 1:
        extra_gap = max(main_avail - used, 0.0) / (len(el.children) - 1)

    for c, size in zip(el.children, sizes):
        if main_is_x:
            cw = size
            ch_fixed = _fixed(c.height)
            if c.height == FILL or el.align == "stretch":
                ch = ih
            elif ch_fixed is not None:
                ch = ch_fixed
            else:
                ch = _measure(c, cw, ih, m)[1]
            cy = iy
            if el.align == "center":
                cy += (ih - ch) / 2
            elif el.align == "end":
                cy += ih - ch
            node.children.append(_layout(c, cursor, cy, cw, ch, child_clip, m))
            cursor += cw + el.gap + extra_gap
        else:
            ch = size
            cw_fixed = _fixed(c.width)
            if c.width == FILL or el.align == "stretch":
                cw = iw
            elif cw_fixed is not None:
                cw = cw_fixed
            else:
                cw = _measure(c, iw, ch, m)[0]
            cx = ix
            if el.align == "center":
                cx += (iw - cw) / 2
            elif el.align == "end":
                cx += iw - cw
            node.children.append(_layout(c, cx, cursor, cw, ch, child_clip, m))
            cursor += ch + el.gap + extra_gap
    return node


def _resolve_child_size(c: El, iw: float, ih: float, m: TextMeasurer
                        ) -> tuple[float, float]:
    cw = _fixed(c.width)
    ch = _fixed(c.height)
    if c.width == FILL:
        cw = iw
    if c.height == FILL:
        ch = ih
    if cw is None or ch is None:
        mw, mh = _measure(c, iw if cw is None else cw, ih if ch is None else ch, m)
        cw = mw if cw is None else cw
        ch = mh if ch is None else ch
    return cw, ch


def _align_in(c: El, ix, iy, iw, ih, cw, ch, parent: El) -> tuple[float, float]:
    cx, cy = ix, iy
    if parent.align == "center":
        cx, cy = ix + (iw - cw) / 2, iy + (ih - ch) / 2
    elif parent.align == "end":
        cx, cy = ix + iw - cw, iy + ih - ch
    return cx, cy


_OVERSCAN = 128.0  # px of extra rows materialized beyond the viewport
                   # (128 keeps a 1280×800 history under the 4096-glyph
                   # capacity bucket; 256 pushed it to 8192)


def _layout_scroll(el: El, ix, iy, iw, ih, clip, m: TextMeasurer
                   ) -> list[LayoutNode]:
    """Materialize only the visible rows of a virtual list."""
    n = el.virtual_row_count
    if n == 0 or el.virtual_build is None:
        return []
    # Scroll offsets snap to the 1/8-px command-quantization grid so the
    # device-resident window path (which quantizes row coords and the
    # scroll shift separately) stays bit-exact with inline compilation.
    el.scroll_offset = round(el.scroll_offset * 8.0) / 8.0
    heights = el.virtual_row_heights
    out: list[LayoutNode] = []
    if heights is None:
        # Probe one row for uniform height.
        probe = el.virtual_build(0)
        rh = _measure(probe, iw, ih, m)[1]
        rh = max(rh, 1.0)
        first = max(int(el.scroll_offset // rh), 0)
        last = min(int((el.scroll_offset + ih) // rh) + 1, n - 1)
        for i in range(first, last + 1):
            child = el.virtual_build(i)
            cy = iy + i * rh - el.scroll_offset
            out.append(_layout(child, ix, cy, iw, rh, clip or (ix, iy, iw, ih), m))
    else:
        tops = []
        yacc = 0.0
        for hh in heights:
            tops.append(yacc)
            yacc += hh
        # Overscan: materialize a margin beyond the viewport so the row
        # SET stays stable across many scroll steps — the scene
        # compiler's window composite (scene._splice_scroll_window) then
        # hits its cache while scrolling; out-of-view quads are culled at
        # bin time. Quantizing the window edge to OVERSCAN steps makes
        # the set a pure function of the scroll bucket.
        lo = max(0.0, (el.scroll_offset // _OVERSCAN) * _OVERSCAN
                 - _OVERSCAN)
        hi = (((el.scroll_offset + ih) // _OVERSCAN) + 2) * _OVERSCAN
        for i in range(n):
            top, hh = tops[i], heights[i]
            if top + hh < lo:
                continue
            if top > hi:
                break
            child = el.virtual_build(i)
            cy = iy + top - el.scroll_offset
            out.append(_layout(child, ix, cy, iw, hh, clip or (ix, iy, iw, ih), m))
    return out
