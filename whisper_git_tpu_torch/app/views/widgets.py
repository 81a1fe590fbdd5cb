"""Shared overlay widgets: context menus and toast notifications.

Capability parity with the reference's context-menu builders
(ui_app.rs:4546-4788) and toast system (color-coded, stacking ≤3,
bottom-center — README "Toast Notifications").
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ...ui import El, column, rect, row, spacer, text
from ...ui.theme import DARK as T

TOAST_LIFETIME = 4.0   # seconds
TOAST_FADE = 1.0
MAX_VISIBLE_TOASTS = 3


@dataclass(frozen=True)
class MenuItem:
    label: str
    route: str
    destructive: bool = False
    separator_before: bool = False


@dataclass
class ContextMenuState:
    """reference: ContextMenuState/ContextTarget, ui_app.rs:213-241."""

    items: list[MenuItem]
    x: float
    y: float
    target: str = ""            # e.g. "commit:abc123"
    selected_index: int = 0


_MENU_ROW_H = 24.0
_MENU_GAP = 1.0
_MENU_PAD = 5.0
_MENU_W = 230.0
_MENU_SEP_H = 1.0


def context_menu(state: ContextMenuState,
                 viewport: tuple | None = None) -> El:
    rows: list[El] = []
    for i, item in enumerate(state.items):
        if item.separator_before:
            rows.append(rect(width="fill", height=_MENU_SEP_H,
                             fill=T.border))
        color = T.danger if item.destructive else T.text
        rows.append(rect(
            text(item.label, font_size=T.font_size, color=color),
            width="fill", height=_MENU_ROW_H, radius=4,
            padding=(3, 10, 3, 10),
            fill=T.surface_hover if i == state.selected_index else None,
            hover_fill=T.surface_hover, route=item.route,
            key=f"menu-item:{item.route}"))
    menu = rect(column(*rows, gap=_MENU_GAP, width=_MENU_W,
                       padding=(_MENU_PAD,) * 4),
                fill=T.surface_raised, border=T.border_light, border_width=1,
                radius=8, shadow=True, key="context-menu")
    # Clamp into the viewport: a right-click near the bottom/right edge
    # must not park most items offscreen (unclickable, scrim-only exit).
    # The estimate derives from the SAME constants the construction
    # uses, so a styling change cannot silently break the clamp.
    x, y = state.x, state.y
    if viewport is not None:
        n = len(state.items)
        n_sep = sum(1 for it in state.items if it.separator_before)
        est_h = (n * _MENU_ROW_H + n_sep * (_MENU_SEP_H + _MENU_GAP)
                 + max(n - 1, 0) * _MENU_GAP + 2 * _MENU_PAD + 2.0)
        x = max(0.0, min(x, viewport[0] - _MENU_W - 22.0))
        y = max(0.0, min(y, viewport[1] - est_h))
    # Position wrapper: scrim catches outside clicks.
    return rect(
        rect(menu, padding=(y, 0, 0, x)),
        width="fill", height="fill", route="close-menu", key="menu-scrim")


@dataclass
class Toast:
    kind: str       # success | error | info
    message: str
    created: float = field(default_factory=time.monotonic)

    def age(self) -> float:
        return time.monotonic() - self.created

    def expired(self) -> bool:
        return self.age() > TOAST_LIFETIME + TOAST_FADE

    def opacity(self) -> float:
        a = self.age()
        if a <= TOAST_LIFETIME:
            return 1.0
        return max(0.0, 1.0 - (a - TOAST_LIFETIME) / TOAST_FADE)


def toasts_overlay(toasts: list[Toast]) -> Optional[El]:
    visible = [t for t in toasts if not t.expired()][-MAX_VISIBLE_TOASTS:]
    if not visible:
        return None
    colors = {"success": T.success, "error": T.danger, "info": T.info}
    cards = []
    for t in visible:
        c = colors.get(t.kind, T.info)
        cards.append(rect(
            row(rect(width=8, height=8, radius=4, fill=c),
                text(t.message[:90], color=T.text, font_size=T.font_size),
                gap=8, align="center"),
            fill=T.surface_raised, border=(c[0], c[1], c[2], 0.5),
            border_width=1, radius=8, padding=(7, 12, 7, 12),
            opacity=t.opacity(), shadow=True))
    stackcol = column(*cards, gap=6, align="center")
    return rect(
        column(spacer(), stackcol, spacer(12), align="center",
               width="fill", height="fill"),
        width="fill", height="fill", key="toasts")


def palette_overlay(state) -> El:
    """Command palette overlay: centered query box + ranked result rows.

    `state` is an app.palette.PaletteState. Matched characters in each
    label render in the accent color (spans composed from the matcher's
    position list). The scrim click closes; rows run `palette-run:<i>`.
    """
    matches = state.matches()
    rows: list[El] = []
    query_label = state.query if state.query else "Type a command…"
    rows.append(rect(
        row(text(">", font_size=T.font_size, color=T.accent, bold=True),
            text(query_label, font_size=T.font_size,
                 color=T.text_bright if state.query else T.text_muted),
            rect(width=2, height=15, fill=T.accent, volatile=True),
            gap=7, align="center"),
        width="fill", height=30, padding=(4, 10, 4, 10),
        fill=T.background, radius=6, border=T.border_light, border_width=1,
        key="palette-query"))
    sel = min(state.selected, max(0, len(matches) - 1))
    for i, (cmd, positions) in enumerate(matches):
        pos = set(positions)
        spans: list[El] = []
        run_start = 0
        # Coalesce adjacent chars with the same match-state into runs so
        # a row stays a handful of text elements, not one per character.
        label = cmd.label
        for j in range(1, len(label) + 1):
            if j == len(label) or (j in pos) != (run_start in pos):
                seg = label[run_start:j]
                hit = run_start in pos
                spans.append(text(seg, font_size=T.font_size,
                                  color=T.accent if hit else T.text,
                                  bold=hit))
                run_start = j
        cells = [row(*spans) if spans else
                 text(label, font_size=T.font_size, color=T.text)]
        if cmd.hint:
            cells += [spacer(),
                      text(cmd.hint, font_size=10, color=T.text_muted)]
        rows.append(rect(
            row(*cells, align="center", width="fill"),
            width="fill", height=26, radius=4, padding=(3, 10, 3, 10),
            fill=T.surface_hover if i == sel else None,
            hover_fill=T.surface_hover, route=f"palette-run:{i}",
            key=f"palette-item:{i}"))
    if not matches:
        rows.append(rect(text("No matching commands", font_size=T.font_size,
                              color=T.text_muted),
                         width="fill", height=26, padding=(4, 10, 4, 10)))
    panel = rect(column(*rows, gap=3, width=440, padding=(8, 8, 8, 8)),
                 fill=T.surface_raised, border=T.border_light,
                 border_width=1, radius=10, shadow=True, key="palette-panel")
    return rect(
        column(spacer(60), panel, spacer(), align="center",
               width="fill", height="fill"),
        width="fill", height="fill", route="close-palette",
        key="palette-scrim")


_CURSOR_FREEZE: bool | None = None


def freeze_cursor(visible: bool | None) -> None:
    """Pin the caret blink (goldens/screenshot tests need byte-for-byte
    determinism — same rationale as freeze_pulse)."""
    global _CURSOR_FREEZE
    _CURSOR_FREEZE = visible


def cursor_visible() -> bool:
    """~1 Hz caret blink shared by every text input (reference README:
    "Cursor blinking in text inputs at approximately 1Hz")."""
    if _CURSOR_FREEZE is not None:
        return _CURSOR_FREEZE
    return int(time.time() * 2) % 2 == 0


def pulse_period(n_dirty: int) -> float:
    """"The Pulse" (design_feedback_feb2026.md:339-347): the
    working-directory indicator pulses when dirty, rate scaling with the
    dirty file count — gentle 2 s, medium 1 s, urgent 0.5 s."""
    if n_dirty > 20:
        return 0.5
    if n_dirty > 5:
        return 1.0
    return 2.0


_PULSE_FREEZE: float | None = None


def freeze_pulse(at: float | None) -> None:
    """Pin the pulse clock (tests and golden dumps need deterministic
    pixels; two renders of the same state must match byte-for-byte)."""
    global _PULSE_FREEZE
    _PULSE_FREEZE = at


def pulse_alpha(n_dirty: int, now: float | None = None) -> float:
    """Sinusoidal 0.35‥1.0 opacity at the count-scaled period, QUANTIZED
    to 1/16 steps: discrete opacities recur every cycle, so the per-frame
    volatile blob's content hash recurs too and the device-resident blob
    cache keeps steady-state frames at zero upload (a continuous alpha
    made every frame's blob novel, one upload per frame)."""
    import math

    if now is None:
        now = _PULSE_FREEZE if _PULSE_FREEZE is not None \
            else time.monotonic()
    period = pulse_period(n_dirty)
    t = now % period
    a = 0.675 + 0.325 * math.sin(2.0 * math.pi * t / period)
    return round(a * 16.0) / 16.0


def input_text_el(value: str, cursor, anchor, caret_on: bool,
                  color, font_size: float) -> El:
    """Single-line input content with selection highlight: the
    anchor↔caret span renders on an accent wash (reference text inputs
    paint selections; src/host.rs keyboard selection). Falls back to the
    plain caret rendering when no selection is active."""
    from ...ui import insert_caret

    n = len(value)
    a = None if anchor is None else max(0, min(anchor, n))
    c = n if cursor is None else max(0, min(cursor, n))
    if a is None or a == c:
        shown = insert_caret(value, cursor) if caret_on else value
        return text(shown, color=color, font_size=font_size)
    lo, hi = min(a, c), max(a, c)
    pre, sel, post = value[:lo], value[lo:hi], value[hi:]
    if caret_on:
        if c <= lo:
            pre = insert_caret(pre, c)
        else:
            post = insert_caret(post, c - hi)
    parts: list[El] = []
    if pre:
        parts.append(text(pre, color=color, font_size=font_size))
    parts.append(rect(text(sel, color=color, font_size=font_size),
                      fill=(T.accent[0], T.accent[1], T.accent[2], 0.35),
                      radius=2))
    if post:
        parts.append(text(post, color=color, font_size=font_size))
    return row(*parts, align="center")
