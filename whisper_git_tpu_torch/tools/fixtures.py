"""Shared synthetic UI fixtures (no git, no wall clock, no network).

A copy of `whisper_git_tpu/tools/fixtures.py`. `steady_window_tree` is THE
canonical steady-state frame shape: a virtualized scroll window of
cache-keyed rows (recorded as a device-resident window) plus a volatile
scrollbar thumb (the per-frame dynamic tail) over static chrome, the
structure the interactive history view produces every frame. The mesh
tests (`tests/test_torch_parallel.py`, as the reference's
`tests/test_parallel.py`) and `chip_smoke.py`'s phase `mesh` build this
tree, so what the card certifies is by construction the frame shape the
tests pin. (`tools/goldens.py` keeps its own self-contained variant on
purpose: golden scenes are pinned to checked-in PNGs and must not drift
when a shared fixture evolves.)
"""

from __future__ import annotations


def steady_window_tree(off: float, key_prefix: str = "steady"):
    """Scroll window of cache-keyed rows + volatile thumb over chrome."""
    from ..ui import column, rect, row, scroll, spacer, stack, text
    from ..ui.theme import DARK as T

    def make_row(i):
        return rect(
            row(text(f"row {i} subject line", color=T.text),
                spacer(),
                text("2h", color=T.text_muted, font_size=11),
                gap=8, align="center", width="fill", height="fill"),
            width="fill", height=28,
            fill=T.surface if i % 2 else T.background,
            cache_key=(f"{key_prefix}-row", i, i % 2))

    body = scroll(40, make_row, offset=float(off),
                  row_heights=[28.0] * 40, key=f"{key_prefix}-scroll",
                  width="fill", flex=1)
    thumb = rect(width=6, height=40, fill=T.accent, radius=3,
                 volatile=True)
    return stack(
        column(
            rect(text("steady state", bold=True, color=T.text_bright),
                 fill=T.surface_raised, height=28, width="fill",
                 padding=(4, 8, 4, 8)),
            body, width="fill", height="fill"),
        stack(thumb, width=6, height=40),
        width="fill", height="fill", fill=T.background)


def steady_window_scene(renderer, off: float, size=(384, 256),
                        key_prefix: str = "steady"):
    """Layout + compile the steady tree at `size` (records the window)."""
    from ..ui.theme import DARK

    root = renderer.layout(steady_window_tree(off, key_prefix), size)
    return renderer.compile(root, size, DARK.background)
