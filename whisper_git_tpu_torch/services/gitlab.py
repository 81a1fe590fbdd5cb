"""GitLab pipelines CI client.

Capability parity with reference src/gitlab.rs: hostname-contains-"gitlab"
heuristic incl. self-hosted (:26), `/api/v4/projects/{path}/pipelines`
(:107), status mapping (:133), head-SHA branch summary (:154), per-commit
latest-pipeline rollup (:218).
"""

from __future__ import annotations

import json
import queue
import re
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from .ci import CiCommitRollup, CiCounts, CiProvider, CiRun, CiState, CiStatus


def parse_remote_url(url: str,
                     known_hosts: Optional[list[str]] = None
                     ) -> Optional[tuple[str, str]]:
    """→ (host, project_path). Matches gitlab.com, any host containing
    'gitlab', and registered self-hosted instances (reference: gitlab.rs:26)."""
    if not url:
        return None
    m = (re.match(r"^https?://([^/]+)/(.+?)(?:\.git)?/?$", url.strip())
         or re.match(r"^git@([^:]+):(.+?)(?:\.git)?$", url.strip())
         or re.match(r"^ssh://git@([^/]+)/(.+?)(?:\.git)?/?$", url.strip()))
    if not m:
        return None
    host, path = m.group(1), m.group(2)
    hosts = set(known_hosts or [])
    if "gitlab" in host.lower() or host in hosts:
        return host, path
    return None


_STATE_MAP = {
    "success": CiState.SUCCESS,
    "failed": CiState.FAILURE,
    "canceled": CiState.UNKNOWN,
    "skipped": CiState.UNKNOWN,
    "manual": CiState.UNKNOWN,
    "running": CiState.PENDING,
    "pending": CiState.PENDING,
    "created": CiState.PENDING,
    "waiting_for_resource": CiState.PENDING,
    "preparing": CiState.PENDING,
    "scheduled": CiState.PENDING,
}


def map_pipeline_state(status: str) -> CiState:
    """reference: gitlab.rs:133."""
    return _STATE_MAP.get(status, CiState.UNKNOWN)


def parse_pipelines_payload(payload: list, branch: str,
                            head_sha: str) -> CiStatus:
    """Head-SHA summary over the pipeline list (reference: gitlab.rs:154)."""
    runs: list[CiRun] = []
    counts = CiCounts()
    for p in payload:
        run = CiRun(name=f"pipeline #{p.get('id', 0)}",
                    state=map_pipeline_state(p.get("status", "")),
                    run_id=int(p.get("id", 0)),
                    head_sha=p.get("sha", ""),
                    url=p.get("web_url", ""))
        runs.append(run)
    # Latest pipeline per SHA; count only the branch head.
    latest: Optional[CiRun] = None
    for run in runs:
        if run.head_sha == head_sha and (latest is None
                                         or run.run_id > latest.run_id):
            latest = run
    if latest is not None:
        counts.add(latest.state)
    return CiStatus(provider=CiProvider.GITLAB, branch=branch,
                    head_sha=head_sha, counts=counts, runs=runs)


def per_commit_rollups(status: CiStatus,
                       oids: list[str]) -> dict[str, CiCommitRollup]:
    """Latest-pipeline-per-commit rollup (reference: gitlab.rs:218)."""
    out: dict[str, CiCommitRollup] = {}
    for oid in oids:
        latest: Optional[CiRun] = None
        for run in status.runs:
            if run.head_sha == oid and (latest is None
                                        or run.run_id > latest.run_id):
                latest = run
        if latest is not None and latest.state is not CiState.UNKNOWN:
            out[oid] = CiCommitRollup.from_runs(oid, [latest])
    return out


def http_error_message(code: int) -> str:
    """ONE GitLab HTTP-error phrasebook (CI pipelines AND the PR/MR
    client use this — keeps the copies from drifting)."""
    return {401: "GitLab token rejected (401).",
            403: "GitLab access forbidden (403).",
            404: "Project not found (404) — private projects need a "
                 "token."}.get(code, f"GitLab API error (HTTP {code})")


def fetch_pipelines(host: str, project_path: str, token: Optional[str],
                    branch: str, head_sha: str,
                    timeout: float = 15.0) -> CiStatus:
    proj = urllib.parse.quote(project_path, safe="")
    url = f"https://{host}/api/v4/projects/{proj}/pipelines?per_page=50"
    req = urllib.request.Request(url)
    req.add_header("User-Agent", "whisper-git-tpu")
    if token:
        req.add_header("PRIVATE-TOKEN", token)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = json.loads(resp.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        return CiStatus(provider=CiProvider.GITLAB, branch=branch,
                        head_sha=head_sha, error=http_error_message(e.code))
    except (urllib.error.URLError, OSError, TimeoutError, ValueError) as e:
        # ValueError covers JSONDecodeError (see github.fetch_runs).
        return CiStatus(provider=CiProvider.GITLAB, branch=branch,
                        head_sha=head_sha, error=f"Network error: {e}")
    if not isinstance(payload, list):
        payload = []
    return parse_pipelines_payload(payload, branch, head_sha)


def fetch_ci_status_async(host: str, project_path: str,
                          token: Optional[str], branch: str, head_sha: str,
                          proxy=None) -> "queue.Queue[CiStatus]":
    rx: "queue.Queue[CiStatus]" = queue.Queue(maxsize=1)

    def worker():
        try:
            status = fetch_pipelines(host, project_path, token, branch,
                                     head_sha)
        except Exception as exc:  # a dead worker wedges polling
            status = CiStatus(provider=CiProvider.GITLAB, branch=branch,
                              head_sha=head_sha,
                              error=f"CI fetch failed: {exc}")
        rx.put(status)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name="ci-gitlab").start()
    return rx
