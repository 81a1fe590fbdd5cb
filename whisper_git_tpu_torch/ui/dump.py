"""Golden-dump backends: SVG and layout-tree text.

The reference's `dump_bundles` writes `*.svg` + `*.tree.txt` + `*.lint.txt`
per fixture scene (reference: src/bin/dump_bundles.rs:20-76) — these are
the CPU-only regression artifacts. Same trio here.
"""

from __future__ import annotations

from xml.sax.saxutils import escape

from .layout import LayoutNode


def _css(color) -> str:
    r, g, b = (int(c * 255) for c in color[:3])
    a = color[3] if len(color) > 3 else 1.0
    return f"rgba({r},{g},{b},{a:.3f})"


def to_svg(root: LayoutNode, width: float, height: float) -> str:
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
        f'height="{height:.0f}" viewBox="0 0 {width:.0f} {height:.0f}">',
        '<style>text{font-family:system-ui,sans-serif}</style>',
    ]
    for node in root.walk():
        el = node.el
        if el.fill is not None or el.border is not None:
            fill = _css(el.fill) if el.fill else "none"
            stroke = (f' stroke="{_css(el.border)}" stroke-width="{el.border_width}"'
                      if el.border else "")
            parts.append(
                f'<rect x="{node.x:.1f}" y="{node.y:.1f}" width="{node.w:.1f}" '
                f'height="{node.h:.1f}" rx="{el.radius:.1f}" fill="{fill}"{stroke}/>')
        if el.kind == "text" and el.text:
            color = _css(el.color) if el.color else "#F8FAFC"
            weight = ' font-weight="bold"' if el.bold else ""
            ty = node.y + el.font_size  # baseline approximation
            parts.append(
                f'<text x="{node.x:.1f}" y="{ty:.1f}" font-size="{el.font_size}"'
                f' fill="{color}"{weight}>{escape(el.text)}</text>')
        if el.kind == "image":
            parts.append(
                f'<rect x="{node.x:.1f}" y="{node.y:.1f}" width="{node.w:.1f}" '
                f'height="{node.h:.1f}" fill="#888" opacity="0.5"/>')
        for prim in el.prims:
            parts.append(_prim_svg(prim, node.x, node.y))
    parts.append("</svg>")
    return "\n".join(parts)


def _prim_svg(prim, ox: float, oy: float) -> str:
    kind = prim[0]
    if kind == "vline":
        _, x, y0, y1, w, color = prim
        return (f'<line x1="{ox + x:.1f}" y1="{oy + y0:.1f}" x2="{ox + x:.1f}" '
                f'y2="{oy + y1:.1f}" stroke="{_css(color)}" stroke-width="{w}"/>')
    if kind == "cubic":
        _, p0, p1, p2, p3, w, color = prim
        d = (f"M {ox + p0[0]:.1f} {oy + p0[1]:.1f} "
             f"C {ox + p1[0]:.1f} {oy + p1[1]:.1f}, {ox + p2[0]:.1f} "
             f"{oy + p2[1]:.1f}, {ox + p3[0]:.1f} {oy + p3[1]:.1f}")
        return (f'<path d="{d}" fill="none" stroke="{_css(color)}" '
                f'stroke-width="{w}"/>')
    if kind == "circle":
        _, cx, cy, r, color = prim
        return (f'<circle cx="{ox + cx:.1f}" cy="{oy + cy:.1f}" r="{r:.1f}" '
                f'fill="{_css(color)}"/>')
    return ""


def to_tree_text(root: LayoutNode) -> str:
    lines: list[str] = []

    def walk(node: LayoutNode, depth: int):
        el = node.el
        desc = el.kind
        if el.kind == "text":
            desc += f" {el.text[:40]!r}"
        if el.route:
            desc += f" route={el.route}"
        if el.key:
            desc += f" key={el.key}"
        lines.append(f"{'  ' * depth}{desc} "
                     f"[{node.x:.0f},{node.y:.0f} {node.w:.0f}x{node.h:.0f}]")
        for c in node.children:
            walk(c, depth + 1)

    walk(root, 0)
    return "\n".join(lines)
