"""Terminal keyboard input for the display-less host loop.

The reference's windowed host translates winit keyboard events into app
keys (reference: host.rs:747 map_key). With no display server here, the
interactive mode reads raw terminal input instead: escape sequences map
to the same key names `WhisperApp.on_key` expects, control bytes map to
Ctrl chords, and printable characters route to `on_text` via the app's
focus rules.
"""

from __future__ import annotations

import os
import select
import sys
import termios
import tty
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KeyEvent:
    key: str
    ctrl: bool = False
    shift: bool = False


@dataclass(frozen=True)
class PasteEvent:
    """Bracketed paste (DECSET 2004): the terminal wraps pasted text in
    ESC[200~ … ESC[201~ so a multi-line paste arrives as one event
    instead of a keystroke storm (which would, e.g., trigger hotkeys)."""

    text: str


@dataclass(frozen=True)
class ModeReport:
    """DECRQM response (`ESC [ ? mode ; value $ y`) — used to confirm
    SGR-Pixels (1016) support so the display flips to pixel mapping."""

    mode: int
    value: int  # 1/3 = set, 0/2/4 = unsupported or reset


@dataclass(frozen=True)
class MouseEvent:
    """One SGR-encoded (DECSET 1006) terminal mouse event. col/row are
    1-based terminal cells; the host maps them to app pixels."""

    kind: str   # down | up | move | wheel
    col: int
    row: int
    button: str = "left"   # left | middle | right | none
    wheel: int = 0         # +1 up, -1 down
    shift: bool = False
    ctrl: bool = False


_ESC_MAP = {
    "[A": "Up", "[B": "Down", "[C": "Right", "[D": "Left",
    "[5~": "PageUp", "[6~": "PageDown",
    "[H": "Home", "[F": "End", "[3~": "Delete",
    "[Z": "ShiftTab",
    # SS3 variants (DECCKM application cursor mode — e.g. a prior TUI
    # crashed without resetting it): arrows/Home/End must keep working.
    "OA": "Up", "OB": "Down", "OC": "Right", "OD": "Left",
    "OH": "Home", "OF": "End",
}


def parse_sgr_mouse(body: str, final: str) -> Optional[MouseEvent]:
    """Decode `ESC [ < Cb ; Cx ; Cy (M|m)` (xterm SGR mouse, DECSET 1006).
    `body` is "Cb;Cx;Cy", `final` is "M" (press/move/wheel) or "m"
    (release)."""
    try:
        cb_s, cx_s, cy_s = body.split(";")
        cb, col, row = int(cb_s), int(cx_s), int(cy_s)
    except ValueError:
        return None
    shift = bool(cb & 4)
    ctrl = bool(cb & 16)
    motion = bool(cb & 32)
    low = cb & 3
    if cb & 64:  # wheel
        return MouseEvent("wheel", col, row, "none",
                          wheel=1 if low == 0 else -1,
                          shift=shift, ctrl=ctrl)
    button = ("left", "middle", "right", "none")[low]
    if motion:
        return MouseEvent("move", col, row, button, shift=shift, ctrl=ctrl)
    if final == "m":
        return MouseEvent("up", col, row, button, shift=shift, ctrl=ctrl)
    return MouseEvent("down", col, row, button, shift=shift, ctrl=ctrl)


class TerminalInput:
    """Raw-mode stdin reader. Use as a context manager."""

    def __init__(self, fd: Optional[int] = None):
        self.fd = fd if fd is not None else sys.stdin.fileno()
        self._saved = None
        self._pushback: list[bytes] = []  # bytes returned to the stream
        self._eof = False

    def __enter__(self):
        try:
            self._saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        except (termios.error, OSError):
            self._saved = None
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            try:
                termios.tcsetattr(self.fd, termios.TCSADRAIN, self._saved)
            except (termios.error, OSError):
                pass

    def _read_byte(self, timeout: float) -> Optional[bytes]:
        if self._pushback:
            return self._pushback.pop(0)
        ready, _, _ = select.select([self.fd], [], [], timeout)
        if not ready:
            return None
        data = os.read(self.fd, 1)
        if not data:
            # EOF: select reports the fd ready FOREVER — without this
            # flag the host input-drain loop would busy-spin at 100% CPU.
            self._eof = True
            return None
        return data

    def poll(self, timeout: float = 0.0):
        """→ KeyEvent | MouseEvent | None."""
        if self._eof:
            if timeout > 0:
                import time as _time
                _time.sleep(timeout)  # honor the caller's frame budget
            return None
        b = self._read_byte(timeout)
        if b is None:
            return None
        c = b[0]
        if c == 0x1B:  # ESC: sequence or bare Escape
            seq = b""
            while len(seq) < 14:
                nxt = self._read_byte(0.01)
                if nxt is None:
                    break
                seq += nxt
                if len(seq) == 1 and seq not in (b"[", b"O"):
                    # Not a sequence introducer: this is Escape followed
                    # by buffered input (or Alt+key). Put the byte back
                    # and deliver the Escape — consuming up to 14 bytes
                    # of typed text here used to swallow both.
                    self._pushback.append(nxt)
                    return KeyEvent("Escape")
                if seq == b"[<":  # SGR mouse: read until M/m
                    body = b""
                    while len(body) < 16:
                        nxt = self._read_byte(0.01)
                        if nxt is None:
                            return None
                        if nxt in (b"M", b"m"):
                            return parse_sgr_mouse(
                                body.decode("latin1"),
                                nxt.decode("latin1"))
                        body += nxt
                    return None
                if seq.decode("latin1") in _ESC_MAP:
                    break
                # CSI/SS3 sequences terminate on a final byte (0x40-0x7E
                # after the introducer); stop collecting there so an
                # unknown chord is consumed whole.
                if len(seq) >= 2 and seq[:1] in (b"[", b"O") \
                        and 0x40 <= seq[-1] <= 0x7E and seq != b"[":
                    break
            if not seq:
                return KeyEvent("Escape")  # a bare Escape press
            if seq == b"[200~":  # bracketed paste: read until ESC[201~
                buf = b""
                while len(buf) < 1 << 20:
                    nxt = self._read_byte(0.05)
                    if nxt is None:
                        break
                    buf += nxt
                    if buf.endswith(b"\x1b[201~"):
                        buf = buf[:-6]
                        break
                return PasteEvent(buf.decode("utf-8", "replace"))
            name = _ESC_MAP.get(seq.decode("latin1"))
            if name == "ShiftTab":
                return KeyEvent("Tab", shift=True)
            if name is not None:
                return KeyEvent(name)
            # Modified CSI: ESC [ 1 ; m X — m encodes modifiers
            # (2 Shift, 5 Ctrl, 6 Shift+Ctrl), X the key. Shift+arrows
            # drive in-input selection (reference text inputs).
            txt = seq.decode("latin1")
            if (len(txt) == 5 and txt.startswith("[1;")
                    and txt[3] in "2345678"
                    and "[" + txt[4] in _ESC_MAP):
                mod = int(txt[3]) - 1
                return KeyEvent(_ESC_MAP["[" + txt[4]],
                                shift=bool(mod & 1), ctrl=bool(mod & 4))
            # DECRQM report: ESC [ ? <mode> ; <value> $ y
            if txt.startswith("[?") and txt.endswith("$y"):
                try:
                    mode_s, val_s = txt[2:-2].split(";")
                    return ModeReport(int(mode_s), int(val_s))
                except ValueError:
                    return None
            # Unknown sequence (F1-F4 SS3, Alt+key, unmapped CSI): swallow
            # it rather than synthesizing Escape — a stray Escape would
            # close the user's modal/search state (reference Escape ladder).
            return None
        if c in (0x0D, 0x0A):
            return KeyEvent("Enter")
        if c == 0x09:
            return KeyEvent("Tab")
        if c in (0x7F, 0x08):
            return KeyEvent("Backspace")
        if 0x01 <= c <= 0x1A:  # Ctrl+A..Ctrl+Z
            letter = chr(c + 0x60)
            return KeyEvent(letter, ctrl=True)
        ch = b.decode("utf-8", "replace")
        # Multi-byte UTF-8: read continuation bytes.
        if c >= 0xC0:
            need = 1 + (c >= 0xE0) + (c >= 0xF0)
            rest = b""
            for _ in range(need):
                nxt = self._read_byte(0.01)
                if nxt is None:
                    break
                rest += nxt
            ch = (b + rest).decode("utf-8", "replace")
        return KeyEvent(ch, shift=ch.isupper())


def dispatch(app, ev) -> None:
    """Route one key or paste event through the app's keyboard rules."""
    if isinstance(ev, PasteEvent):
        app.on_paste(ev.text)
        return
    if ev.ctrl or len(ev.key) > 1:
        app.on_key(ev.key, ctrl=ev.ctrl, shift=ev.shift)
    else:
        # Single printable char: on_key handles focus-aware routing
        # (it forwards to on_text when an input is focused).
        app.on_key(ev.key, ctrl=False, shift=ev.shift)
