"""Retained-mode UI toolkit (L1) — the rebuild's equivalent of the
reference's external `aetna-core` crate: a declarative El tree, a flex
layout pass, theme tokens, lints over the laid-out tree, SVG/text golden
dumps, and a Runner that hit-tests and paints through the TPU rasterizer.
"""

from .el import (El, column, row, stack, rect, text, spacer, image,
                 path, scroll, insert_caret)
from .layout import LayoutNode, layout_tree
from .runner import Runner
from .theme import Theme, DARK

__all__ = [
    "DARK", "El", "LayoutNode", "Runner", "Theme", "column", "image",
    "insert_caret", "layout_tree", "path", "rect", "row", "scroll",
    "spacer", "stack", "text",
]
