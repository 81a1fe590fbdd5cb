"""Lints over the laid-out tree.

The reference leans on aetna's lint pipeline as its regression gate
(reference: SURVEY §4.3 — `MissingSurfaceFill`, `FocusRingObscured`,
`ScrollbarObscuresFocusable`; docs/aetna-port.md:258-279 gates on zero
findings across every golden scene). Ours re-implements all three named
rules over `LayoutNode`s plus two of its own (`ZeroSizeInteractive`,
`TextOverflow`); CI fails on ANY finding in ANY dumped scene.
"""

from __future__ import annotations

from dataclasses import dataclass

from .layout import LayoutNode


@dataclass(frozen=True)
class LintFinding:
    rule: str
    message: str
    x: float
    y: float


def run_lints(root: LayoutNode) -> list[LintFinding]:
    order = _paint_order(root)
    findings: list[LintFinding] = []
    findings += _missing_surface_fill(root)
    findings += _zero_size_interactive(root)
    findings += _text_overflow(root)
    findings += _focus_ring_obscured(order)
    findings += _scrollbar_obscures_focusable(order)
    return findings


def _paint_order(root: LayoutNode
                 ) -> list[tuple[int, int, int, LayoutNode]]:
    """(paint_index, subtree_end_index, root_layer, node) in paint order
    — later entries composite over earlier ones; a node's descendants
    occupy indices (i, end]. `root_layer` is the child index under the
    root stack (modal/menu/toast overlays are separate layers; occlusion
    ACROSS layers is intentional UI, occlusion WITHIN one is a bug)."""
    out: list = []

    def walk(node: LayoutNode, layer: int) -> None:
        i = len(out)
        out.append([i, i, layer, node])
        for c in node.children:
            walk(c, layer)
        out[i][1] = len(out) - 1

    if root.el.kind == "stack":
        out.append([0, 0, 0, root])
        for li, c in enumerate(root.children):
            walk(c, li)
        out[0][1] = len(out) - 1
    else:
        walk(root, 0)
    return [tuple(e) for e in out]


def _missing_surface_fill(root: LayoutNode) -> list[LintFinding]:
    """Text must sit on some filled ancestor surface (or the root fill)."""
    out: list[LintFinding] = []

    def walk(node: LayoutNode, has_surface: bool):
        if node.el.fill is not None and (node.el.fill[3] if len(node.el.fill) > 3 else 1.0) > 0.05:
            has_surface = True
        if node.el.kind == "text" and node.el.text.strip() and not has_surface:
            out.append(LintFinding(
                "MissingSurfaceFill",
                f"text {node.el.text[:32]!r} has no filled ancestor surface",
                node.x, node.y))
        for c in node.children:
            walk(c, has_surface)

    walk(root, False)
    return out


def _zero_size_interactive(root: LayoutNode) -> list[LintFinding]:
    out: list[LintFinding] = []
    for node in root.walk():
        if node.el.route is not None and (node.w <= 0 or node.h <= 0):
            out.append(LintFinding(
                "ZeroSizeInteractive",
                f"route {node.el.route!r} has zero hit area", node.x, node.y))
    return out


def _text_overflow(root: LayoutNode) -> list[LintFinding]:
    """Non-wrapping text wider than its clip rect. 8 px slack absorbs
    sub-glyph measurement jitter; anything larger is a real truncation
    bug the view should be clamping/eliding itself."""
    out: list[LintFinding] = []
    for node in root.walk():
        if (node.el.kind != "text" or node.el.wrap or node.el.ellipsis
                or node.clip is None):
            continue  # ellipsis texts elide themselves at emit time
        cx, cy, cw, ch = node.clip
        if node.x + node.w > cx + cw + 8:
            out.append(LintFinding(
                "TextOverflow",
                f"text {node.el.text[:32]!r} overflows clip by "
                f"{node.x + node.w - (cx + cw):.0f}px", node.x, node.y))
    return out


def _opaque_fill(el) -> bool:
    f = el.fill
    return f is not None and (f[3] if len(f) > 3 else 1.0) >= 0.9


def _is_focus_ring(el) -> bool:
    """Accent-colored borders are the focus/selection rings (staging
    inputs, dialog fields, selected options)."""
    if el.border is None or el.border_width <= 0:
        return False
    from .theme import DARK

    b, a = el.border, DARK.accent
    return all(abs(b[i] - a[i]) < 0.02 for i in range(3))


def _focus_ring_obscured(order) -> list[LintFinding]:
    """A later-painted opaque surface may not cover a focus ring's
    perimeter band (reference rule: FocusRingObscured — a focused field
    whose ring is hidden looks unfocused)."""
    out: list[LintFinding] = []
    rings = [(i, end, lr, n) for i, end, lr, n in order
             if _is_focus_ring(n.el)]
    for i, end, lr, n in rings:
        bw = max(n.el.border_width, 1.0) + 1.0
        for j, _, mlr, m in order:
            if j <= end and j >= i:
                continue  # self or descendant: paints inside the ring
            if j < i or mlr != lr or not _opaque_fill(m.el):
                continue  # earlier paint, or an intentional overlay layer
            # Overlap with the ring band = overlap with the outer rect
            # minus containment of the inner rect.
            ox0 = max(n.x, m.x)
            oy0 = max(n.y, m.y)
            ox1 = min(n.x + n.w, m.x + m.w)
            oy1 = min(n.y + n.h, m.y + m.h)
            if ox0 >= ox1 or oy0 >= oy1:
                continue
            inner = (m.x <= n.x + bw and m.y <= n.y + bw
                     and m.x + m.w >= n.x + n.w - bw
                     and m.y + m.h >= n.y + n.h - bw)
            covers_band = inner or (
                ox0 < n.x + bw or oy0 < n.y + bw
                or ox1 > n.x + n.w - bw or oy1 > n.y + n.h - bw)
            if covers_band:
                out.append(LintFinding(
                    "FocusRingObscured",
                    f"focus ring at ({n.x:.0f},{n.y:.0f}) obscured by "
                    f"later surface {m.el.key or m.el.kind!r}",
                    n.x, n.y))
                break
    return out


def _is_scrollbar(el) -> bool:
    return bool((el.key and str(el.key).endswith("-scrollbar"))
                or (el.route_drag and str(el.route_drag)
                    .startswith("scroll-drag")))


def _scrollbar_obscures_focusable(order) -> list[LintFinding]:
    """A scrollbar thumb may not cover the CENTER of an interactive
    element painted under it (reference rule: ScrollbarObscuresFocusable
    — hit-testing is topmost-wins, so a covered center steals the
    click). Overlay scrollbars grazing a row's right edge are fine."""
    out: list[LintFinding] = []
    thumbs = [(i, lr, n) for i, _, lr, n in order if _is_scrollbar(n.el)]
    if not thumbs:
        return out
    for j, _, mlr, m in order:
        if m.el.route is None or m.w <= 0 or m.h <= 0:
            continue
        cx, cy = m.x + m.w / 2, m.y + m.h / 2
        for i, lr, n in thumbs:
            if i <= j or lr != mlr:
                continue  # painted under, or a separate overlay layer
            if n.x <= cx <= n.x + n.w and n.y <= cy <= n.y + n.h:
                out.append(LintFinding(
                    "ScrollbarObscuresFocusable",
                    f"scrollbar {n.el.key or n.el.route_drag!r} covers "
                    f"center of route {m.el.route!r}", m.x, m.y))
                break
    return out
