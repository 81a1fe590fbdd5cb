"""Theme tokens.

Capability parity with the reference's theme (reference:
docs/render_engine.md "Theme Colors" — the dark slate palette) plus the
metric constants its views use.
"""

from __future__ import annotations

from dataclasses import dataclass


def _hex(s: str, a: float = 1.0) -> tuple[float, float, float, float]:
    s = s.lstrip("#")
    return (int(s[0:2], 16) / 255.0, int(s[2:4], 16) / 255.0,
            int(s[4:6], 16) / 255.0, a)


@dataclass(frozen=True)
class Theme:
    background: tuple = _hex("0F172A")
    surface: tuple = _hex("1E293B")
    surface_raised: tuple = _hex("283548")
    surface_hover: tuple = _hex("334155")
    border: tuple = _hex("334155")
    border_light: tuple = _hex("475569")
    text: tuple = _hex("F8FAFC")
    text_bright: tuple = _hex("FFFFFF")
    text_muted: tuple = _hex("94A3B8")
    accent: tuple = _hex("3B82F6")
    success: tuple = _hex("22C55E")
    warning: tuple = _hex("EAB308")
    danger: tuple = _hex("EF4444")
    info: tuple = _hex("3B82F6")
    # Diff colors
    diff_add_bg: tuple = _hex("14532D", 0.45)
    diff_del_bg: tuple = _hex("7F1D1D", 0.45)
    diff_add_hl: tuple = _hex("16A34A", 0.55)
    diff_del_hl: tuple = _hex("DC2626", 0.55)
    diff_hunk: tuple = _hex("A855F7")
    # Pills
    pill_local: tuple = _hex("3B82F6")
    pill_remote: tuple = _hex("06B6D4")
    pill_tag: tuple = _hex("F59E0B")
    pill_head: tuple = _hex("22C55E")
    pill_orphan: tuple = _hex("F97316")
    pill_worktree: tuple = _hex("EAB308")
    # Metrics
    font_size: float = 13.0
    font_size_small: float = 11.0
    font_size_large: float = 16.0
    line_height: float = 1.4
    radius: float = 6.0
    radius_pill: float = 9.0
    pad: float = 8.0


DARK = Theme()
