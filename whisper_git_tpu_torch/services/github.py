"""GitHub Actions CI client.

Capability parity with reference src/github.rs: remote-URL parsing
(HTTPS + SSH, :23), `GET /repos/{o}/{r}/actions/runs` with Bearer token +
per_page 50 (:158), dedupe runs by workflow name keeping the max run id,
head-SHA-only branch summary (:194-260), per-commit rollups sorted
fail > pending > pass (:263), rich HTTP error classification
(401 / 403-SSO / 403-rate-limit / 404-private, :75-128), and an async
fetch thread (:308).
"""

from __future__ import annotations

import json
import queue
import re
import threading
import urllib.error
import urllib.request
from typing import Optional

from .ci import CiCommitRollup, CiCounts, CiProvider, CiRun, CiState, CiStatus

API = "https://api.github.com"
PER_PAGE = 50


def parse_remote_url(url: str) -> Optional[tuple[str, str]]:
    """HTTPS + SSH GitHub URL → (owner, repo) (reference: github.rs:23)."""
    if not url:
        return None
    patterns = [
        r"^https?://github\.com/([^/]+)/([^/]+?)(?:\.git)?/?$",
        r"^git@github\.com:([^/]+)/([^/]+?)(?:\.git)?$",
        r"^ssh://git@github\.com/([^/]+)/([^/]+?)(?:\.git)?/?$",
    ]
    for pat in patterns:
        m = re.match(pat, url.strip())
        if m:
            return m.group(1), m.group(2)
    return None


_STATE_MAP = {
    ("completed", "success"): CiState.SUCCESS,
    ("completed", "failure"): CiState.FAILURE,
    ("completed", "timed_out"): CiState.FAILURE,
    ("completed", "startup_failure"): CiState.FAILURE,
    ("completed", "cancelled"): CiState.UNKNOWN,
    ("completed", "skipped"): CiState.UNKNOWN,
    ("completed", "neutral"): CiState.UNKNOWN,
}


def map_run_state(status: str, conclusion: Optional[str]) -> CiState:
    if status in ("queued", "in_progress", "waiting", "pending",
                  "requested"):
        return CiState.PENDING
    if status == "completed":
        return _STATE_MAP.get(("completed", conclusion or ""),
                              CiState.UNKNOWN)
    return CiState.UNKNOWN


def classify_http_error(code: int, body: str = "") -> str:
    """reference: github.rs:75-128."""
    if code == 401:
        return "GitHub token rejected (401). Update your token in Settings."
    if code == 403:
        if "SAML" in body or "SSO" in body:
            return ("Token lacks SSO authorization for this organization. "
                    "Authorize it on GitHub.")
        if "rate limit" in body.lower():
            return "GitHub API rate limit exceeded. Try again later."
        return "GitHub access forbidden (403)."
    if code == 404:
        return ("Repository not found (404) — private repos need a token "
                "with repo scope.")
    return f"GitHub API error (HTTP {code})"


def parse_runs_payload(payload: dict, branch: str,
                       head_sha: str) -> CiStatus:
    """Pure summary builder (unit-testable; reference: github.rs:194-260):
    dedupe runs by workflow name keeping the max run id, then count only
    runs for the branch head SHA."""
    runs_raw = payload.get("workflow_runs", [])
    by_name: dict[str, CiRun] = {}
    all_runs: list[CiRun] = []
    for r in runs_raw:
        run = CiRun(name=r.get("name", "?"),
                    state=map_run_state(r.get("status", ""),
                                        r.get("conclusion")),
                    run_id=int(r.get("id", 0)),
                    head_sha=r.get("head_sha", ""),
                    url=r.get("html_url", ""))
        all_runs.append(run)
        if run.head_sha != head_sha:
            continue
        prev = by_name.get(run.name)
        if prev is None or run.run_id > prev.run_id:
            by_name[run.name] = run
    counts = CiCounts()
    for run in by_name.values():
        counts.add(run.state)
    return CiStatus(provider=CiProvider.GITHUB, branch=branch,
                    head_sha=head_sha, counts=counts,
                    runs=all_runs)


def per_commit_rollups(status: CiStatus,
                       oids: list[str]) -> dict[str, CiCommitRollup]:
    """Dots per commit, dedupe by workflow name keeping the newest run per
    commit (reference: github.rs:263)."""
    out: dict[str, CiCommitRollup] = {}
    for oid in oids:
        best: dict[str, CiRun] = {}
        for run in status.runs:
            if run.head_sha != oid:
                continue
            prev = best.get(run.name)
            if prev is None or run.run_id > prev.run_id:
                best[run.name] = run
        if best:
            out[oid] = CiCommitRollup.from_runs(oid, best.values())
    return out


def fetch_runs(owner: str, repo: str, token: Optional[str],
               branch: str, head_sha: str, timeout: float = 15.0) -> CiStatus:
    url = f"{API}/repos/{owner}/{repo}/actions/runs?per_page={PER_PAGE}"
    req = urllib.request.Request(url)
    req.add_header("Accept", "application/vnd.github+json")
    req.add_header("User-Agent", "whisper-git-tpu")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = json.loads(resp.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        body = ""
        try:
            body = e.read().decode("utf-8", "replace")
        except Exception:
            pass
        return CiStatus(provider=CiProvider.GITHUB, branch=branch,
                        head_sha=head_sha,
                        error=classify_http_error(e.code, body))
    except (urllib.error.URLError, OSError, TimeoutError, ValueError) as e:
        # ValueError covers JSONDecodeError: a captive portal / proxy
        # returning 200 with an HTML body must not kill the worker (a
        # dead worker never rx.put()s, and ci_poll's in-flight guard
        # would wedge ALL future CI/PR fetches for the tab).
        return CiStatus(provider=CiProvider.GITHUB, branch=branch,
                        head_sha=head_sha,
                        error=f"Network error: {e}")
    return parse_runs_payload(payload, branch, head_sha)


def fetch_ci_status_async(owner: str, repo: str, token: Optional[str],
                          branch: str, head_sha: str, proxy=None
                          ) -> "queue.Queue[CiStatus]":
    """reference: github.rs:308."""
    rx: "queue.Queue[CiStatus]" = queue.Queue(maxsize=1)

    def worker():
        try:
            status = fetch_runs(owner, repo, token, branch, head_sha)
        except Exception as exc:  # last-ditch: a dead worker wedges polling
            status = CiStatus(provider=CiProvider.GITHUB, branch=branch,
                              head_sha=head_sha,
                              error=f"CI fetch failed: {exc}")
        rx.put(status)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="ci-github").start()
    return rx
