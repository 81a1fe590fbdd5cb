"""Diff viewer widget: GitHub-shaped unified/split diff with virtualized
rows, gutter line numbers, row washes, word-level highlight overlays, and
per-hunk Stage/Unstage/Discard buttons.

Capability parity with reference src/widgets/diff.rs (DiffData :65,
DiffMode :76) + src/diff_view.rs (commit vs working source adapter :17-146).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...gitcore.types import DiffFile, DiffLine
from ...ui import El, column, rect, row, scroll, spacer, text
from ...ui.theme import DARK as T

ROW_H = 18.0
MONO_SIZE = 12.0


@dataclass(frozen=True)
class DiffRowModel:
    """One renderable row of the diff stream."""

    kind: str   # "file" | "hunk" | "line"
    file_index: int
    hunk_index: int = -1
    line: Optional[DiffLine] = None
    label: str = ""


def build_diff_rows(files: list[DiffFile]) -> list[DiffRowModel]:
    """Flatten DiffFiles into the virtualized row stream
    (reference: widgets/diff.rs rendering model)."""
    rows: list[DiffRowModel] = []
    for fi, f in enumerate(files):
        label = f.path if not f.old_path else f"{f.old_path} → {f.path}"
        rows.append(DiffRowModel("file", fi, label=label))
        if f.is_binary:
            rows.append(DiffRowModel("line", fi, label="(binary file)"))
            continue
        for hi, h in enumerate(f.hunks):
            rows.append(DiffRowModel("hunk", fi, hi, label=h.header))
            for line in h.lines:
                rows.append(DiffRowModel("line", fi, hi, line=line))
    return rows


@dataclass(frozen=True)
class SplitRowModel:
    """One row of the split (side-by-side) stream: old on the left, new on
    the right (reference: DiffMode::Split, widgets/diff.rs:76)."""

    kind: str  # "file" | "hunk" | "pair"
    file_index: int
    hunk_index: int = -1
    left: Optional[DiffLine] = None
    right: Optional[DiffLine] = None
    label: str = ""


def build_split_rows(files: list[DiffFile]) -> list[SplitRowModel]:
    """Pair −/+ runs positionally (same pairing as the word-level
    highlighter) so changed lines face each other; context lines mirror."""
    rows: list[SplitRowModel] = []
    for fi, f in enumerate(files):
        label = f.path if not f.old_path else f"{f.old_path} → {f.path}"
        rows.append(SplitRowModel("file", fi, label=label))
        if f.is_binary:
            rows.append(SplitRowModel("pair", fi, label="(binary file)"))
            continue
        for hi, h in enumerate(f.hunks):
            rows.append(SplitRowModel("hunk", fi, hi, label=h.header))
            lines = list(h.lines)
            i = 0
            while i < len(lines):
                ln = lines[i]
                if ln.origin == " ":
                    rows.append(SplitRowModel("pair", fi, hi, left=ln,
                                              right=ln))
                    i += 1
                    continue
                j = i
                while j < len(lines) and lines[j].origin == "-":
                    j += 1
                k = j
                while k < len(lines) and lines[k].origin == "+":
                    k += 1
                minus = lines[i:j]
                plus = lines[j:k]
                for n in range(max(len(minus), len(plus))):
                    rows.append(SplitRowModel(
                        "pair", fi, hi,
                        left=minus[n] if n < len(minus) else None,
                        right=plus[n] if n < len(plus) else None))
                i = k
    return rows


def _line_el(model: DiffRowModel, hscroll: float) -> El:
    line = model.line
    if line is None:
        return rect(text(model.label, font_size=MONO_SIZE,
                         color=T.text_muted),
                    width="fill", height=ROW_H, padding=(1, 8, 1, 88))
    wash = None
    hl_color = None
    if line.origin == "+":
        wash = T.diff_add_bg
        hl_color = T.diff_add_hl
    elif line.origin == "-":
        wash = T.diff_del_bg
        hl_color = T.diff_del_hl

    old_no = str(line.old_lineno) if line.old_lineno else ""
    new_no = str(line.new_lineno) if line.new_lineno else ""
    gutter = row(
        text(old_no.rjust(4), font_size=10, color=T.text_muted),
        text(new_no.rjust(4), font_size=10, color=T.text_muted),
        gap=6, width=76)

    content = line.content
    cells: list[El] = [gutter,
                       text(line.origin, font_size=MONO_SIZE,
                            color=T.text_muted, width=10)]
    # Word-level highlight overlay: split at the highlight byte range.
    if line.highlights and hl_color is not None:
        start, end = line.highlights[0]
        raw = content.encode()
        pre = raw[:start].decode("utf-8", "replace")
        mid = raw[start:end].decode("utf-8", "replace")
        post = raw[end:].decode("utf-8", "replace")
        content_el = row(
            text(pre, font_size=MONO_SIZE, color=T.text),
            rect(text(mid, font_size=MONO_SIZE, color=T.text_bright),
                 fill=hl_color, radius=2),
            text(post, font_size=MONO_SIZE, color=T.text),
            align="center")
    else:
        content_el = text(content, font_size=MONO_SIZE, color=T.text)
    # Gutter + origin stay fixed; the code column pans by hscroll
    # (reference README: "Horizontal scrolling with Shift+ScrollWheel or
    # Left/Right arrow keys").
    cells.append(row(content_el, scroll_x=hscroll, clip=True,
                     flex=1, height="fill", align="center"))
    return rect(row(*cells, gap=4, align="center", height="fill"),
                width="fill", height=ROW_H, fill=wash, clip=True)


def _hunk_header_el(model: DiffRowModel, fi: int, hi: int,
                    source: str) -> El:
    buttons: list[El] = []

    def btn(label, route):
        buttons.append(rect(text(label, font_size=10, color=T.accent),
                            route=route, radius=3, padding=(0, 6, 0, 6),
                            hover_fill=T.surface_hover))

    # Hunk actions depend on the diff source (reference: per-hunk
    # Stage/Unstage/Discard buttons on working diffs only).
    if source == "unstaged":
        btn("Stage", f"stage-hunk:{fi}:{hi}")
        btn("Discard", f"confirm-discard-hunk:{fi}:{hi}")
    elif source == "staged":
        btn("Unstage", f"unstage-hunk:{fi}:{hi}")
    return rect(
        row(text(model.label[:100], font_size=MONO_SIZE, color=T.diff_hunk),
            spacer(), *buttons, gap=6, align="center", width="fill",
            height="fill"),
        width="fill", height=ROW_H + 4, fill=(0.66, 0.33, 0.97, 0.10),
        padding=(1, 8, 1, 8))


def _split_cell(line: Optional[DiffLine], kind: str,
                hscroll: float = 0.0) -> El:
    if line is None:
        return rect(width="fill", height="fill", fill=(1, 1, 1, 0.03))
    wash = hl = None
    if line.origin == "+":
        wash, hl = T.diff_add_bg, T.diff_add_hl
    elif line.origin == "-":
        wash, hl = T.diff_del_bg, T.diff_del_hl
    no = line.old_lineno if kind == "left" else line.new_lineno
    cells: list[El] = [text(str(no or "").rjust(4), font_size=10,
                            color=T.text_muted, width=34)]
    if line.highlights and hl is not None:
        start, end = line.highlights[0]
        raw = line.content.encode()
        content_el = row(
            text(raw[:start].decode("utf-8", "replace"),
                 font_size=MONO_SIZE, color=T.text),
            rect(text(raw[start:end].decode("utf-8", "replace"),
                      font_size=MONO_SIZE, color=T.text_bright),
                 fill=hl, radius=2),
            text(raw[end:].decode("utf-8", "replace"),
                 font_size=MONO_SIZE, color=T.text),
            align="center")
    else:
        content_el = text(line.content, font_size=MONO_SIZE, color=T.text)
    cells.append(row(content_el, scroll_x=hscroll, clip=True,
                     flex=1, height="fill", align="center"))
    return rect(row(*cells, gap=4, align="center", height="fill"),
                width="fill", height="fill", fill=wash, clip=True)


_ROW_MODEL_MEMO: dict = {}


def _row_models(files: list, mode: str):
    """(rows, heights) memoized by the files list's identity — build()
    runs on every frame wake and wheel event, and rebuilding the full
    row model of a 50k-line diff in Python before virtualization kicks
    in is visible scroll jank (same pattern as the history view's
    segment memo)."""
    key = (id(files), mode)
    hit = _ROW_MODEL_MEMO.pop(key, None)
    if hit is not None and hit[0] is files:
        _ROW_MODEL_MEMO[key] = hit  # LRU re-insert
        return hit[1], hit[2]
    rows = build_split_rows(files) if mode == "split" \
        else build_diff_rows(files)
    heights = [ROW_H + 8 if m.kind == "file"
               else ROW_H + 4 if m.kind == "hunk" else ROW_H for m in rows]
    # Small LRU: entries strongly reference full DiffFile lists + row
    # models (tens of MB for giant diffs) — closed diffs must not pin
    # memory for the session.
    while len(_ROW_MODEL_MEMO) >= 4:
        _ROW_MODEL_MEMO.pop(next(iter(_ROW_MODEL_MEMO)))
    _ROW_MODEL_MEMO[key] = (files, rows, heights)
    return rows, heights


def diff_view(files: list[DiffFile], scroll_offset: float = 0.0,
              hscroll: float = 0.0, source: str = "commit",
              title: str = "", mode: str = "unified") -> El:
    """The diff pane. source: "commit" | "staged" | "unstaged";
    mode: "unified" | "split"."""
    if not files:
        # Keep the header: without it the ✕ close and mode toggle vanish
        # and a mouse-only user has no way to dismiss the empty pane.
        return rect(
            column(_diff_header(title, mode),
                   rect(text("No changes", color=T.text_muted),
                        fill=T.background, width="fill", flex=1,
                        align="center"),
                   width="fill", height="fill"),
            fill=T.background, width="fill", height="fill", key="diff")
    if mode == "split":
        return _split_diff_view(files, scroll_offset, source, title,
                                hscroll)
    rows, heights = _row_models(files, "unified")

    def build(i: int) -> El:
        model = rows[i]
        if model.kind == "file":
            f = files[model.file_index]
            return rect(
                row(text(model.label, font_size=T.font_size, bold=True,
                         color=T.text),
                    spacer(),
                    text(f"+{f.additions} −{f.deletions}", font_size=10,
                         color=T.text_muted),
                    gap=8, align="center", width="fill", height="fill"),
                width="fill", height=ROW_H + 8, fill=T.surface_raised,
                padding=(2, 8, 2, 8), radius=4)
        if model.kind == "hunk":
            return _hunk_header_el(model, model.file_index, model.hunk_index,
                                   source)
        return _line_el(model, hscroll)

    header = _diff_header(title, "unified")
    return rect(
        column(header,
               scroll(len(rows), build, offset=scroll_offset,
                      row_heights=heights, width="fill", flex=1,
                      key="diff-scroll"),
               width="fill", height="fill"),
        fill=T.background, width="fill", height="fill", clip=True,
        key="diff")


def _diff_header(title: str, mode: str) -> El:
    other = "split" if mode == "unified" else "unified"
    return rect(
        row(text(title or "Diff", font_size=T.font_size, bold=True,
                 color=T.text),
            spacer(),
            rect(text(other.capitalize(), font_size=10, color=T.accent),
                 route="toggle-diff-mode", radius=3, padding=(1, 6, 1, 6),
                 hover_fill=T.surface_hover, key="diff-mode-toggle"),
            rect(text("✕", font_size=11, color=T.text_muted),
                 route="close-diff", radius=3, padding=(0, 5, 0, 5),
                 hover_fill=T.surface_hover),
            gap=8, align="center", width="fill"),
        width="fill", height=26, padding=(3, 8, 3, 8), fill=T.surface_raised)


def _split_diff_view(files: list[DiffFile], scroll_offset: float,
                     source: str, title: str,
                     hscroll: float = 0.0) -> El:
    rows, heights = _row_models(files, "split")

    def build(i: int) -> El:
        model = rows[i]
        if model.kind == "file":
            f = files[model.file_index]
            return rect(
                row(text(model.label, font_size=T.font_size, bold=True,
                         color=T.text),
                    spacer(),
                    text(f"+{f.additions} −{f.deletions}", font_size=10,
                         color=T.text_muted),
                    gap=8, align="center", width="fill", height="fill"),
                width="fill", height=ROW_H + 8, fill=T.surface_raised,
                padding=(2, 8, 2, 8), radius=4)
        if model.kind == "hunk":
            return _hunk_header_el(model, model.file_index,
                                   model.hunk_index, source)
        return rect(
            row(_split_cell(model.left, "left", hscroll),
                rect(width=1, height="fill", fill=T.border),
                _split_cell(model.right, "right", hscroll),
                width="fill", height="fill"),
            width="fill", height=ROW_H)

    return rect(
        column(_diff_header(title, "split"),
               scroll(len(rows), build, offset=scroll_offset,
                      row_heights=heights, width="fill", flex=1,
                      key="diff-scroll"),
               width="fill", height="fill"),
        fill=T.background, width="fill", height="fill", clip=True,
        key="diff")
