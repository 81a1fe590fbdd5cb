"""Diff engine: unified-diff parsing into DiffFile/DiffHunk/DiffLine and
word-level intra-line highlighting.

Capability parity with reference src/git/diff.rs: commit-vs-parent diffs,
working-file diffs (staged = HEAD→index, unstaged = index→workdir,
pathspec-filtered), single-file-in-commit diffs, and the word-level
highlight algorithm (pair consecutive −/+ runs, common prefix/suffix byte
ranges, UTF-8 boundary snapping — diff.rs:135-250).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from .cli import run_git
from .repo import GitRepo
from .types import DiffFile, DiffHunk, DiffLine, FileStatus

_HUNK_RE = re.compile(r"^@@ -(\d+)(?:,(\d+))? \+(\d+)(?:,(\d+))? @@(.*)$")

_NAME_STATUS_MAP = {
    "A": FileStatus.ADDED, "M": FileStatus.MODIFIED, "D": FileStatus.DELETED,
    "R": FileStatus.RENAMED, "C": FileStatus.RENAMED, "T": FileStatus.TYPECHANGE,
    "U": FileStatus.CONFLICTED,
}


# ---------------------------------------------------------------------------
# Word-level intra-line highlights (reference: diff.rs:135-250).
# ---------------------------------------------------------------------------

def _common_prefix_suffix(a: bytes, b: bytes) -> tuple[int, int]:
    n = min(len(a), len(b))
    p = 0
    while p < n and a[p] == b[p]:
        p += 1
    s = 0
    while s < n - p and a[len(a) - 1 - s] == b[len(b) - 1 - s]:
        s += 1
    return p, s


def _snap_utf8(data: bytes, idx: int, forward: bool) -> int:
    """Snap a byte index off a UTF-8 continuation byte (reference:
    diff.rs:238 boundary snapping)."""
    n = len(data)
    idx = max(0, min(idx, n))
    step = 1 if forward else -1
    while 0 < idx < n and (data[idx] & 0xC0) == 0x80:
        idx += step
    return max(0, min(idx, n))


def intra_line_highlight(old: str, new: str) -> tuple[tuple[int, int], tuple[int, int]]:
    """Byte ranges (start, end) of the differing middle of a paired −/+ line.

    Returns ((old_start, old_end), (new_start, new_end)); an empty range
    means the whole line matched (no highlight).
    """
    a, b = old.encode(), new.encode()
    p, s = _common_prefix_suffix(a, b)
    oa, ob = _snap_utf8(a, p, False), _snap_utf8(a, len(a) - s, True)
    na, nb = _snap_utf8(b, p, False), _snap_utf8(b, len(b) - s, True)
    if oa >= ob:
        oa = ob = 0
    if na >= nb:
        na = nb = 0
    return (oa, ob), (na, nb)


# Above this many pairs, highlight computation runs batched on the
# accelerator (ops.diffword) in one dispatch instead of per-pair Python.
_BATCH_THRESHOLD = 64


def compute_intra_line_highlights(lines: list[DiffLine]) -> list[DiffLine]:
    """Pair consecutive runs of '-' then '+' lines positionally and compute
    highlights for each pair (reference: diff.rs:135). Large diffs batch
    all pairs through one device dispatch."""
    # First pass: collect paired indices.
    pair_idx: list[tuple[int, int]] = []  # (minus_index, plus_index)
    i = 0
    n = len(lines)
    while i < n:
        if lines[i].origin == "-":
            j = i
            while j < n and lines[j].origin == "-":
                j += 1
            k = j
            while k < n and lines[k].origin == "+":
                k += 1
            for idx in range(min(j - i, k - j)):
                pair_idx.append((i + idx, j + idx))
            i = k
        else:
            i += 1
    if not pair_idx:
        return lines

    if len(pair_idx) >= _BATCH_THRESHOLD:
        from ..ops.diffword import batched_highlights

        ranges = batched_highlights([lines[a].content for a, _ in pair_idx],
                                    [lines[b].content for _, b in pair_idx])
    else:
        ranges = [intra_line_highlight(lines[a].content, lines[b].content)
                  for a, b in pair_idx]

    from dataclasses import replace

    out = list(lines)
    for ((a, b), ((oa, ob), (na, nb))) in zip(pair_idx, ranges):
        # dataclasses.replace: other fields (e.g. no_newline) must ride
        # through the highlight rebuild untouched.
        if ob > oa:
            out[a] = replace(out[a], highlights=((oa, ob),))
        if nb > na:
            out[b] = replace(out[b], highlights=((na, nb),))
    return out


# ---------------------------------------------------------------------------
# Unified-diff parsing (reference: diff.rs:253-324 parses the git2 patch
# stream; here we parse `git diff` text directly).
# ---------------------------------------------------------------------------

def parse_unified_diff(text: str, highlight: bool = True) -> list[DiffFile]:
    files: list[DiffFile] = []
    cur: Optional[dict] = None
    hunk: Optional[dict] = None
    old_no = new_no = 0

    def flush_hunk():
        nonlocal hunk
        if cur is not None and hunk is not None:
            lines = hunk["lines"]
            if highlight:
                lines = compute_intra_line_highlights(lines)
            cur["hunks"].append(DiffHunk(
                header=hunk["header"], old_start=hunk["old_start"],
                old_lines=hunk["old_lines"], new_start=hunk["new_start"],
                new_lines=hunk["new_lines"], lines=tuple(lines)))
        hunk = None

    def flush_file():
        nonlocal cur
        flush_hunk()
        if cur is not None:
            adds = sum(1 for h in cur["hunks"] for l in h.lines if l.origin == "+")
            dels = sum(1 for h in cur["hunks"] for l in h.lines if l.origin == "-")
            status = cur["status"]
            if status is None:
                status = FileStatus.MODIFIED
            files.append(DiffFile(
                path=cur["path"], old_path=cur["old_path"], status=status,
                hunks=tuple(cur["hunks"]), is_binary=cur["binary"],
                additions=adds, deletions=dels))
        cur = None

    for raw in text.split("\n"):
        if raw.startswith("diff --git "):
            flush_file()
            m = re.match(r'^diff --git (?:"?a/(.*?)"?) (?:"?b/(.*?)"?)$', raw)
            a_path = m.group(1) if m else raw.split(" b/")[-1]
            b_path = m.group(2) if m else a_path
            cur = {"path": b_path, "old_path": a_path if a_path != b_path else None,
                   "status": None, "hunks": [], "binary": False}
        elif cur is None:
            continue
        elif raw.startswith("new file"):
            cur["status"] = FileStatus.ADDED
        elif raw.startswith("deleted file"):
            cur["status"] = FileStatus.DELETED
        elif raw.startswith("rename from "):
            cur["old_path"] = raw[len("rename from "):]
            cur["status"] = FileStatus.RENAMED
        elif raw.startswith("rename to "):
            cur["path"] = raw[len("rename to "):]
        elif raw.startswith("Binary files") or raw.startswith("GIT binary patch"):
            cur["binary"] = True
        elif raw.startswith("@@"):
            flush_hunk()
            m = _HUNK_RE.match(raw)
            if not m:
                continue
            old_start = int(m.group(1))
            old_lines = int(m.group(2) or "1")
            new_start = int(m.group(3))
            new_lines = int(m.group(4) or "1")
            hunk = {"header": raw, "old_start": old_start, "old_lines": old_lines,
                    "new_start": new_start, "new_lines": new_lines, "lines": []}
            old_no, new_no = old_start, new_start
        elif hunk is not None and raw[:1] in ("+", "-", " "):
            origin = raw[0]
            content = raw[1:]
            if origin == "+":
                hunk["lines"].append(DiffLine("+", content, None, new_no))
                new_no += 1
            elif origin == "-":
                hunk["lines"].append(DiffLine("-", content, old_no, None))
                old_no += 1
            else:
                hunk["lines"].append(DiffLine(" ", content, old_no, new_no))
                old_no += 1
                new_no += 1
        elif hunk is not None and raw.startswith("\\"):
            # "\ No newline at end of file" applies to the PREVIOUS line;
            # record it so hunk patches can re-emit the marker (git apply
            # rejects a rebuilt patch that lost it).
            if hunk["lines"]:
                from dataclasses import replace
                hunk["lines"][-1] = replace(hunk["lines"][-1],
                                            no_newline=True)
    flush_file()
    return files


# ---------------------------------------------------------------------------
# Diff sources.
# ---------------------------------------------------------------------------

_DIFF_ARGS = ["--no-color", "--no-ext-diff", "-U3"]


def commit_diff(repo: GitRepo, oid: str) -> list[DiffFile]:
    """Commit vs first parent (root commits diff against the empty tree;
    reference: diff.rs:63)."""
    out = run_git(repo.root, "show", *_DIFF_ARGS, "--format=", "-m",
                  "--first-parent", oid, "--", check=False)
    if not out.ok:
        return []
    return parse_unified_diff(out.stdout)


def range_diff(repo: GitRepo, base: str, head: str) -> list[DiffFile]:
    """Combined diff of `head` relative to `base` — the compare view for
    a commit-range selection (reference design review's richer selection
    model, design_feedback_feb2026.md:492-506; the reference itself only
    ever diffs one commit against its parent)."""
    out = run_git(repo.root, "diff", *_DIFF_ARGS, base, head, "--",
                  check=False)
    if not out.ok:
        return []
    return parse_unified_diff(out.stdout)


def range_commit_count(repo: GitRepo, base: str, head: str) -> int:
    """Number of commits reachable from head but not base."""
    out = run_git(repo.root, "rev-list", "--count", f"{base}..{head}",
                  check=False)
    try:
        return int(out.stdout.strip()) if out.ok else 0
    except ValueError:
        return 0


def range_oids(repo: GitRepo, base: str, head: str,
               cap: int = 2000) -> frozenset:
    """The EXACT oid set of base..head — the history view's range wash
    must not mark interleaved other-branch commits that the compare diff
    excludes (a list-index interval would)."""
    out = run_git(repo.root, "rev-list", f"--max-count={cap}",
                  f"{base}..{head}", check=False)
    if not out.ok:
        return frozenset()
    return frozenset(out.stdout.split())


def file_in_commit_diff(repo: GitRepo, oid: str, path: str) -> list[DiffFile]:
    """Single file within a commit (reference: diff.rs:107)."""
    out = run_git(repo.root, "show", *_DIFF_ARGS, "--format=", "-m",
                  "--first-parent", oid, "--", path, check=False)
    if not out.ok:
        return []
    return parse_unified_diff(out.stdout)


def working_file_diff(repo: GitRepo, path: str, staged: bool) -> list[DiffFile]:
    """Working-file diff: staged = HEAD→index, unstaged = index→workdir
    (reference: diff.rs:86). Untracked files synthesize an all-added diff."""
    if staged:
        out = run_git(repo.root, "diff", *_DIFF_ARGS, "--cached", "--", path, check=False)
        return parse_unified_diff(out.stdout) if out.ok else []
    out = run_git(repo.root, "diff", *_DIFF_ARGS, "--", path, check=False)
    if out.ok and out.stdout.strip():
        return parse_unified_diff(out.stdout)
    # Untracked: diff against /dev/null (exit code 1 when content differs).
    tracked = run_git(repo.root, "ls-files", "--error-unmatch", "--", path, check=False)
    if not tracked.ok:
        full = os.path.join(repo.workdir or repo.root, path)
        nn = run_git(repo.root, "diff", *_DIFF_ARGS, "--no-index", "--",
                     os.devnull, full, check=False)
        parsed = parse_unified_diff(nn.stdout)
        fixed: list[DiffFile] = []
        for f in parsed:
            fixed.append(DiffFile(path=path, old_path=None, status=FileStatus.ADDED,
                                  hunks=f.hunks, is_binary=f.is_binary,
                                  additions=f.additions, deletions=f.deletions))
        return fixed
    return []


def _parse_numstat_z(out: str) -> dict[str, tuple[int, int]]:
    """`--numstat -z` → {post-change path: (adds, dels)}. Renames emit
    "a\\td\\t\\0old\\0new\\0" (empty path field, then two NUL-separated
    paths) — keying by the NEW path makes the name-status join exact
    for EVERY path, including ones literally containing " => " (which
    the non-z arrow spelling cannot disambiguate)."""
    counts: dict[str, tuple[int, int]] = {}
    toks = out.split("\x00")
    i = 0
    while i < len(toks):
        entry = toks[i]
        if not entry:
            i += 1
            continue
        m = re.match(r"^(\d+|-)\t(\d+|-)\t(.*)$", entry, re.S)
        if not m:
            i += 1
            continue
        a = int(m.group(1)) if m.group(1) != "-" else 0
        d = int(m.group(2)) if m.group(2) != "-" else 0
        path = m.group(3)
        if path == "":  # rename/copy: next two tokens are old, new
            new = toks[i + 2] if i + 2 < len(toks) else ""
            if new:
                counts[new] = (a, d)
            i += 3
        else:
            counts[path] = (a, d)
            i += 1  # the NUL terminator was the split separator
    return counts


def parse_name_status(repo: GitRepo, oid: str) -> list[DiffFile]:
    """Per-file status + ± counts for a commit, no hunks (details pane;
    reference computes these alongside full_commit_info, refs.rs:403)."""
    ns = run_git(repo.root, "show", "--format=", "--name-status", "-z", "-m",
                 "--first-parent", oid, "--", check=False)
    stats = run_git(repo.root, "show", "--format=", "--numstat", "-z",
                    "-m", "--first-parent", oid, "--", check=False)
    counts: dict[str, tuple[int, int]] = {}
    if stats.ok:
        counts = _parse_numstat_z(stats.stdout)
    files: list[DiffFile] = []
    if ns.ok:
        toks = [t for t in ns.stdout.split("\x00")]
        i = 0
        while i < len(toks):
            code = toks[i]
            if not code:
                i += 1
                continue
            kind = code[0]
            status = _NAME_STATUS_MAP.get(kind, FileStatus.MODIFIED)
            if kind in ("R", "C") and i + 2 < len(toks) + 1:
                old_path = toks[i + 1] if i + 1 < len(toks) else None
                path = toks[i + 2] if i + 2 < len(toks) else old_path or ""
                i += 3
            else:
                old_path = None
                path = toks[i + 1] if i + 1 < len(toks) else ""
                i += 2
            a, d = counts.get(path, (0, 0))
            files.append(DiffFile(path=path, old_path=old_path, status=status,
                                  additions=a, deletions=d))
    return files


def staged_diff_text(repo: GitRepo, max_bytes: int = 200_000) -> str:
    """Raw staged diff text for AI commit-message generation, truncated
    (reference: mod.rs:536 staged_diff_text(max_bytes))."""
    out = run_git(repo.root, "diff", "--cached", "--no-color", check=False)
    text = out.stdout if out.ok else ""
    if len(text.encode()) > max_bytes:
        enc = text.encode()[:max_bytes]
        text = enc.decode("utf-8", "ignore") + "\n… (truncated)"
    return text
