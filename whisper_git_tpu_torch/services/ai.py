"""AI commit-message generation.

Capability parity with reference src/ai.rs: capture `git diff --cached`,
refuse empty, shell out to `claude -p … --model haiku --output-format
json`, parse `{"result"}`, split subject/body at the first blank line,
clamp the subject to 72 chars; provider enum for future backends.
"""

from __future__ import annotations

import json
import queue
import shutil
import subprocess
import threading
from typing import Optional

from ..gitcore.diff import staged_diff_text
from ..gitcore.repo import GitRepo

SUBJECT_CLAMP = 72  # reference: ai.rs:187
MAX_DIFF_BYTES = 200_000

PROMPT = (
    "Write a git commit message for this staged diff. First line: concise "
    "subject (<72 chars, imperative mood). Optionally after a blank line: "
    "a short body. Output ONLY the commit message.\n\nDiff:\n"
)


def find_claude_binary() -> Optional[str]:
    """reference: ai.rs:110 binary discovery."""
    return shutil.which("claude")


def split_subject_body(text: str) -> tuple[str, str]:
    """Split at the first blank line; clamp subject (reference: ai.rs:180)."""
    text = text.strip()
    if not text:
        return "", ""
    parts = text.split("\n\n", 1)
    first_block = parts[0].strip()
    lines = first_block.split("\n")
    subject = lines[0].strip()
    rest = "\n".join(lines[1:]).strip()
    body = (rest + ("\n\n" if rest and len(parts) > 1 else "")
            + (parts[1].strip() if len(parts) > 1 else "")).strip()
    if len(subject) > SUBJECT_CLAMP:
        # Reserve a column for the ellipsis: '…' appended to a full
        # 72-char cut would yield 73 and break the documented clamp.
        cut = subject[:SUBJECT_CLAMP - 1]
        if " " in cut[40:]:
            cut = cut[:cut.rfind(" ")]
        body = (subject[len(cut):].strip() + ("\n" + body if body else "")).strip()
        subject = cut.rstrip() + "…" if not cut.endswith("…") else cut
    return subject, body


def _invoke_claude(prompt: str, model: str, timeout: float,
                   err_label: str) -> dict:
    """ONE claude-CLI invocation shape for every AI feature (commit
    message, tagline, branch intent): binary lookup, `-p … --model …
    --output-format json`, timeout/exit handling, `{"result"}` parse.
    Returns {ok, result|error}; callers post-process `result`."""
    binary = find_claude_binary()
    if binary is None:
        return {"ok": False, "error": "claude CLI not found in PATH"}
    try:
        # Prompt via STDIN, not argv: Linux caps a single argv string at
        # 128 KiB (MAX_ARG_STRLEN) and diffs run up to MAX_DIFF_BYTES —
        # an oversized arg raises E2BIG and would kill the worker.
        proc = subprocess.run(
            [binary, "-p", "--model", model, "--output-format", "json"],
            input=prompt.encode("utf-8"),
            capture_output=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"{err_label} timed out"}
    except OSError as exc:
        return {"ok": False, "error": f"{err_label} failed: {exc}"}
    if proc.returncode != 0:
        return {"ok": False,
                "error": proc.stderr.decode("utf-8", "replace")[:200]
                or "claude CLI failed"}
    try:
        payload = json.loads(proc.stdout.decode("utf-8", "replace"))
        result = payload.get("result", "")
    except json.JSONDecodeError:
        result = proc.stdout.decode("utf-8", "replace")
    return {"ok": True, "result": result}


def generate_via_claude_cli(diff: str, model: str = "haiku",
                            timeout: float = 120.0) -> dict:
    """reference: ai.rs:130-194 (claude_cli::generate)."""
    out = _invoke_claude(PROMPT + diff, model, timeout, "AI generation")
    if not out["ok"]:
        return out
    subject, body = split_subject_body(out["result"])
    if not subject:
        return {"ok": False, "error": "AI returned an empty message"}
    return {"ok": True, "subject": subject, "body": body}


# -- worktree taglines (reference: docs/user_needs.md "LLM-Generated
# Descriptions" — specified but never implemented there: "Each working
# tree or dirty directory can get a quick tagline explaining the
# changes") ------------------------------------------------------------------

TAGLINE_MAX_DIFF = 30_000

TAGLINE_PROMPT = (
    "Summarize what these uncommitted changes are doing in ONE short "
    "phrase (max 8 words, no quotes, no trailing period, lowercase "
    "start). Output ONLY the phrase.\n\nChanges:\n"
)


def working_tree_summary_text(workdir: str,
                              max_bytes: int = TAGLINE_MAX_DIFF) -> str:
    """`git diff HEAD` plus untracked names, truncated — the tagline
    input for one working tree."""
    from ..gitcore.cli import run_git
    try:
        diff = run_git(workdir, "diff", "HEAD").stdout
        untracked = run_git(workdir, "ls-files", "--others",
                            "--exclude-standard").stdout
    except Exception:
        return ""
    parts = []
    if untracked.strip():
        parts.append("Untracked files:\n" + untracked.strip())
    if diff.strip():
        parts.append(diff)
    return "\n\n".join(parts)[:max_bytes]


def clamp_tagline(text: str, limit: int = 60) -> str:
    line = text.strip().strip('"').strip("'").split("\n")[0].rstrip(".")
    if len(line) > limit:
        cut = line[:limit]
        if " " in cut[30:]:
            cut = cut[:cut.rfind(" ")]
        line = cut.rstrip() + "…"
    return line


def generate_tagline_via_claude_cli(changes: str, model: str = "haiku",
                                    timeout: float = 60.0) -> dict:
    out = _invoke_claude(TAGLINE_PROMPT + changes, model, timeout,
                         "tagline generation")
    if not out["ok"]:
        return out
    tagline = clamp_tagline(out["result"])
    if not tagline:
        return {"ok": False, "error": "AI returned an empty tagline"}
    return {"ok": True, "tagline": tagline}


def spawn_tagline_async(workdir: str, proxy=None
                        ) -> Optional["queue.Queue[dict]"]:
    """Returns None when the working tree has nothing to describe."""
    changes = working_tree_summary_text(workdir)
    if not changes.strip():
        return None
    rx: "queue.Queue[dict]" = queue.Queue(maxsize=1)

    def worker():
        rx.put(generate_tagline_via_claude_cli(changes))
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="ai-tagline").start()
    return rx


def spawn_generate_async(repo: GitRepo, proxy=None,
                         provider: str = "claude-cli"
                         ) -> Optional["queue.Queue[dict]"]:
    """Returns None when nothing is staged (reference: ai.rs refuses empty
    diffs before spawning)."""
    diff = staged_diff_text(repo, MAX_DIFF_BYTES)
    if not diff.strip():
        return None
    rx: "queue.Queue[dict]" = queue.Queue(maxsize=1)

    def worker():
        result = generate_via_claude_cli(diff)
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="ai-generate").start()
    return rx


# -- branch intent summarization ---------------------------------------------
# Reference design review: "Branch intent summarization — what is this
# branch FOR? not just what files changed"
# (design_feedback_feb2026.md:423). Same claude-CLI plumbing as commit
# messages/taglines; fed the branch's unique commits + diffstat.

INTENT_PROMPT = (
    "Here are the commit subjects and file-level stats unique to one git "
    "branch. In one or two short sentences, say what this branch is FOR — "
    "the intent of the work, not a list of files. Output ONLY the "
    "summary.\n\n"
)
INTENT_CLAMP = 280
MAX_INTENT_BYTES = 20_000


def generate_intent_via_claude_cli(text: str, model: str = "haiku",
                                   timeout: float = 60.0) -> dict:
    out = _invoke_claude(INTENT_PROMPT + text, model, timeout,
                         "intent summarization")
    if not out["ok"]:
        return out
    summary = " ".join(out["result"].split()).strip()[:INTENT_CLAMP]
    if not summary:
        return {"ok": False, "error": "AI returned an empty summary"}
    return {"ok": True, "summary": summary}


def spawn_branch_intent_async(repo: GitRepo, head_oid: str, tip: str,
                              proxy=None) -> "queue.Queue[dict]":
    """EVERY git subprocess (merge-base + log + diff --stat) runs on the
    worker thread — any of them can take hundreds of ms cold on a large
    repo, which would hitch the frame loop if run up front. A branch
    with no unique commits signals {ok: True, empty: True} through the
    queue; git errors surface as {ok: False} — a failed log must not
    read as "no commits of its own"."""
    from ..gitcore.cli import run_git

    rx: "queue.Queue[dict]" = queue.Queue(maxsize=1)

    def worker():
        mb = run_git(repo.root, "merge-base", head_oid, tip, check=False)
        base = (mb.stdout.strip()
                if mb.ok and mb.stdout.strip() else head_oid)
        log = run_git(repo.root, "log", "--oneline", "--no-decorate",
                      f"{base}..{tip}", check=False)
        if not log.ok:
            rx.put({"ok": False,
                    "error": "git log failed for this branch range"})
        elif not log.stdout.strip():
            rx.put({"ok": True, "empty": True})
        else:
            stat = run_git(repo.root, "diff", "--stat", base, tip,
                           check=False)
            text = (f"Commits:\n{log.stdout}\n"
                    f"Diffstat:\n{stat.stdout if stat.ok else ''}"
                    )[:MAX_INTENT_BYTES]
            rx.put(generate_intent_via_claude_cli(text))
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True,
                     name="ai-branch-intent").start()
    return rx
