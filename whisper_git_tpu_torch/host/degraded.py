"""Degraded host-side present — the picture survives the link.

The render thread owns every device dispatch (host/loop.py), so a
congested device link can only DROP frames; but a dropped frame is
still a frozen picture. The host already owns the full laid-out
LayoutNode tree each frame, so when the presenter has had no fresh
device frame for a beat, the loop paints a HOST-RASTERIZED
approximation straight into the terminal cell grid — solid rects,
text as coverage-weighted color smears, graph prims as strokes — a
few ms of numpy for a ~140×80 cell grid, no device round trip at all.
At half-block cell resolution this is close to what the real
downsampled frame looks like; a link-status chip marks the frames as
approximate, and the next device frame swaps the real picture back in.

The tree walk composes cache-replayed subtree offsets analytically
(the same shift/intersect math as ui/layout._shift_tree) instead of
forcing the lazy clones — a full-frame history view rasterizes in a
few ms with zero LayoutNode allocation.

Reference bar: continuous redraw — the *picture* stays live, not just
the input loop (the reference's docs/async-engine-redesign.md:27-31,
README continuous redraw).
"""

from __future__ import annotations

import math

import numpy as np

# Text paints as a coverage-weighted smear of its color: at cell
# resolution a real downsampled glyph run averages to roughly this
# ink fraction over its line box.
_TEXT_COVERAGE = 0.25

_COLOR_CACHE: dict = {}
_IMAGE_MEAN_CACHE: dict = {}
_GRID_BUF: dict = {}


def _rgb255(color) -> np.ndarray:
    hit = _COLOR_CACHE.get(color)
    if hit is None:
        hit = np.asarray(color[:3], np.float32) * 255.0
        if len(_COLOR_CACHE) > 512:
            _COLOR_CACHE.clear()
        _COLOR_CACHE[color] = hit
    return hit


def rasterize_cells(root, viewport: tuple[float, float], rows2: int,
                    cols: int, background: tuple) -> np.ndarray:
    """Laid-out LayoutNode tree → (rows2, cols, 3) u8 half-block cell
    grid, painted in tree paint order (parent, then children)."""
    vw, vh = max(float(viewport[0]), 1.0), max(float(viewport[1]), 1.0)
    sx = cols / vw
    sy = rows2 / vh
    # Reuse the accumulation buffer across frames (this runs several
    # times a second during an outage — churning a fresh ~130 KB array
    # per frame just feeds allocator fragmentation).
    grid = _GRID_BUF.get((rows2, cols))
    if grid is None:
        _GRID_BUF.clear()
        grid = _GRID_BUF[(rows2, cols)] = np.empty((rows2, cols, 3),
                                                   np.float32)
    grid[:] = _rgb255(tuple(background[:3]))
    ceil = math.ceil

    def blend(x, y, w, h, clip, color, alpha_scale):
        if color is None:
            return
        a = float(color[3]) * alpha_scale if len(color) > 3 \
            else alpha_scale
        if a <= 0.003:
            return
        if clip is not None:
            cx, cy, cw, ch = clip
            x0, y0 = max(x, cx), max(y, cy)
            x1, y1 = min(x + w, cx + cw), min(y + h, cy + ch)
        else:
            x0, y0, x1, y1 = x, y, x + w, y + h
        c0 = int(x0 * sx)
        r0 = int(y0 * sy)
        c1 = min(cols, ceil(x1 * sx))
        r1 = min(rows2, ceil(y1 * sy))
        if c0 < 0:
            c0 = 0
        if r0 < 0:
            r0 = 0
        if c1 <= c0 or r1 <= r0:
            return
        # Ink thinner than a cell covers only part of it — scale alpha
        # by the geometric coverage so a 2 px graph lane or 1 px divider
        # averages to the same dimness the real downsample produces.
        covx = (x1 - x0) * sx
        if covx < 1.0:
            a *= covx
        covy = (y1 - y0) * sy
        if covy < 1.0:
            a *= covy
        if a <= 0.003:
            return
        rgb = _rgb255(tuple(color[:3]))
        region = grid[r0:r1, c0:c1]
        if a >= 0.997:
            region[:] = rgb
        else:
            region *= (1.0 - a)
            region += rgb * a

    def paint(el, x, y, w, h, clip):
        op = el.opacity
        if op <= 0.0:
            return
        if el.fill is not None:
            blend(x, y, w, h, clip, el.fill, op)
        kind = el.kind
        if kind == "text":
            if el.text:
                blend(x, y, w, h, clip,
                      el.color or (0.85, 0.88, 0.92, 1.0),
                      _TEXT_COVERAGE * op)
        elif kind == "image":
            if el.image_data is not None:
                try:
                    # id-keyed mean memo with a weakref finalizer: a
                    # freed array's id can be reused by a DIFFERENT
                    # image, so the entry must die with the array.
                    key = id(el.image_data)
                    mean = _IMAGE_MEAN_CACHE.get(key)
                    if mean is None:
                        img = np.asarray(el.image_data)
                        mean = tuple(
                            img[..., :3].astype(np.float32).mean(
                                axis=(0, 1)) / 255.0) + (1.0,)
                        _IMAGE_MEAN_CACHE[key] = mean
                        try:
                            import weakref

                            weakref.finalize(
                                el.image_data,
                                _IMAGE_MEAN_CACHE.pop, key, None)
                        except TypeError:
                            # Not weakref-able: don't cache at all.
                            _IMAGE_MEAN_CACHE.pop(key, None)
                    blend(x, y, w, h, clip, mean, op)
                except Exception:
                    pass
        elif kind == "path":
            for p in el.prims:
                try:
                    pk = p[0]
                    if pk == "vline":
                        _, px, y0, y1, pw, color = p
                        blend(x + px - pw * 0.5, y + y0, pw, y1 - y0,
                              clip, color, op)
                    elif pk == "circle":
                        _, cx, cy, r, color = p
                        blend(x + cx - r, y + cy - r, 2.0 * r, 2.0 * r,
                              clip, color, 0.785 * op)
                    elif pk == "cubic":
                        _, p0, p1, p2, p3, pw, color = p
                        xs = (p0[0], p1[0], p2[0], p3[0])
                        ys = (p0[1], p1[1], p2[1], p3[1])
                        blend(x + min(xs), y + min(ys),
                              max(xs) - min(xs) + pw,
                              max(ys) - min(ys), clip, color, 0.3 * op)
                except (ValueError, TypeError, IndexError):
                    continue

    def shift_clip(c, dx, dy, bclip):
        """_shift_tree's clip math: shift a template-relative clip and
        intersect it with the boundary clip."""
        nx0, ny0 = c[0] + dx, c[1] + dy
        nx1, ny1 = nx0 + c[2], ny0 + c[3]
        if bclip is not None:
            nx0, ny0 = max(nx0, bclip[0]), max(ny0, bclip[1])
            nx1 = min(nx1, bclip[0] + bclip[2])
            ny1 = min(ny1, bclip[1] + bclip[3])
        return (nx0, ny0, max(nx1 - nx0, 0.0), max(ny1 - ny0, 0.0))

    def visit(node, dx, dy, bclip):
        el = node.el
        if node.clip is None:
            eff = bclip
        elif dx == 0.0 and dy == 0.0 and bclip is None:
            eff = node.clip
        else:
            eff = shift_clip(node.clip, dx, dy, bclip)
        paint(el, node.x + dx, node.y + dy, node.w, node.h, eff)
        ch = node._children
        if ch is not None:
            for c in ch:
                visit(c, dx, dy, bclip)
        elif node._lazy is not None:
            # Compose the replayed subtree's offset instead of cloning
            # it (ui/layout._shift_tree semantics).
            tpl, ldx, ldy, lclip = node._lazy
            ndx, ndy = dx + ldx, dy + ldy
            if lclip is None:
                nbclip = bclip
            elif dx == 0.0 and dy == 0.0 and bclip is None:
                nbclip = lclip
            else:
                nbclip = shift_clip(lclip, dx, dy, bclip)
            for c in tpl.children:
                visit(c, ndx, ndy, nbclip)

    visit(root, 0.0, 0.0, None)
    return np.clip(grid + 0.5, 0.0, 255.0).astype(np.uint8)
