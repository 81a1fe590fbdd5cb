"""Runner — the pointer/keyboard front-end over the laid-out El tree.

The rebuild's equivalent of aetna's `Runner` (reference: host.rs:268-301
translates winit pointer events through `Runner::pointer_down` hit-tests
into string-routed `UiEvent`s). The Runner owns the latest layout root,
hit-tests pointer coordinates against it, synthesizes click counts
(double-click within 400 ms / 4 px fires `route_double` — the reference's
double-click-to-stage, README "Stage/unstage individual files
(double-click)"), tracks the hovered route for hover restyling, and
forwards keys/wheel to the app.
"""

from __future__ import annotations

import time
from typing import Optional

from ..tracing import span
from .layout import LayoutNode, layout_tree

DOUBLE_CLICK_S = 0.4
DOUBLE_CLICK_PX = 4.0


class Runner:
    def __init__(self, app, measurer=None):
        self.app = app
        self.measurer = measurer
        self.root: Optional[LayoutNode] = None
        self.hover_route: Optional[str] = None
        self._last_click = (0.0, -1e9, -1e9, None)  # t, x, y, route
        self._drag: Optional[tuple] = None  # (route_drag, last_x, last_y)

    # -- frame ---------------------------------------------------------------

    def prepare(self, viewport: tuple[float, float]) -> LayoutNode:
        """Build + lay out the app's current El tree (aetna
        Runner::prepare's layout step; painting goes through render/)."""
        with span("build"):
            tree = self.app.build(viewport)
        kw = {"measurer": self.measurer} if self.measurer else {}
        with span("layout"):
            self.root = layout_tree(tree, viewport, **kw)
        return self.root

    # -- pointer -------------------------------------------------------------

    def pointer_down(self, x: float, y: float, button: str = "left",
                     now: float | None = None) -> Optional[str]:
        """Hit-test and dispatch. Returns the dispatched route (or None).
        Left clicks repeat-dispatch their single-click route; a second
        click on the same route within the double-click window dispatches
        `route_double` instead when the element declares one."""
        if self.root is None:
            return None
        if button == "right":
            route = self.root.find_route_at(x, y, attr="route_right")
            if route:
                self.app.handle_action(route, x, y)
            return route
        if button == "middle":
            # Middle-click is the PRIMARY-selection paste gesture
            # (host/loop.py; reference src/host.rs:874-897): it may only
            # move focus to an input under the pointer — dispatching
            # arbitrary click routes would fire Push/Discard/confirm
            # buttons on an accidental paste.
            route = self.root.find_route_at(x, y)
            if route and route.startswith("focus-input:"):
                self.app.handle_action(route, x, y)
                return route
            return None
        drag = self.root.find_route_at(x, y, attr="route_drag")
        self._drag = (drag, x, y) if drag else None
        node = self.root.find_route_node_at(x, y)
        route = None if node is None else node.el.route
        if route is not None and route.startswith("focus-input:"):
            # Click-to-caret: hand the app the click x relative to the
            # input's content origin plus this runner's measurer, so
            # _act_focus_input can map it to a logical caret index
            # (exact through bidi/Arabic via the shaped caret map).
            self.app.pending_click_text_x = \
                x - (node.x + float(node.el.padding[3]))
            self.app.click_measurer = self.measurer
        t = time.monotonic() if now is None else now
        lt, lx, ly, lroute = self._last_click
        is_double = (route is not None and route == lroute
                     and t - lt <= DOUBLE_CLICK_S
                     and abs(x - lx) <= DOUBLE_CLICK_PX
                     and abs(y - ly) <= DOUBLE_CLICK_PX)
        self._last_click = (t, x, y, None if is_double else route)
        if is_double:
            dbl = self.root.find_route_at(x, y, attr="route_double")
            if dbl:
                self.app.handle_action(dbl, x, y)
                return dbl
        if route:
            self.app.handle_action(route, x, y)
        return route

    def pointer_move(self, x: float, y: float) -> bool:
        """Track the hovered routed element; returns True when the hover
        target changed (caller should redraw for hover restyling)."""
        if self.root is None:
            return False
        route = self.root.find_route_at(x, y)
        changed = route != self.hover_route
        self.hover_route = route
        # The app repaints hover at build time (ui.hover.apply_hover).
        if changed and hasattr(self.app, "hover_route"):
            self.app.hover_route = route
        return changed

    def pointer_drag(self, x: float, y: float) -> bool:
        """Pointer moved with the button held: dispatch the captured drag
        route with the move delta. Returns True when a drag consumed the
        move (caller should redraw)."""
        if self._drag is None:
            return False
        route, lx, ly = self._drag
        dx, dy = x - lx, y - ly
        if dx == 0.0 and dy == 0.0:
            return False
        self._drag = (route, x, y)
        self.app.handle_action(f"{route}:{dx:.2f}:{dy:.2f}", x, y)
        return True

    def pointer_up(self) -> None:
        self._drag = None

    # -- keyboard / wheel ----------------------------------------------------

    def key_down(self, key: str, ctrl: bool = False,
                 shift: bool = False) -> None:
        self.app.on_key(key, ctrl=ctrl, shift=shift)

    def wheel(self, dy: float, x: float, y: float) -> None:
        self.app.on_scroll(dy, x, y)
