"""Pull-request / merge-request integration (GitHub + GitLab).

Beyond-reference: "Pull request integration" sits on the reference's
Deferred list (docs/user_needs.md, Deferred section). Mirrors the CI
client shape (services/github.py, reference src/github.rs:308): pure
payload parsers unit-tested offline, one fetch thread per provider,
results folded into the tab on the frame loop's poll.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Optional

PER_PAGE = 50


@dataclass
class PullRequestInfo:
    provider: str            # "github" | "gitlab"
    number: int              # PR number / MR iid
    title: str
    source_branch: str
    target_branch: str
    url: str
    author: str = ""
    draft: bool = False
    state: str = "open"      # open | merged | closed


@dataclass
class PrResult:
    provider: str
    prs: list[PullRequestInfo] = field(default_factory=list)
    error: Optional[str] = None


def parse_github_prs(payload: list) -> list[PullRequestInfo]:
    """`GET /repos/{o}/{r}/pulls?state=open` items → PullRequestInfo."""
    out: list[PullRequestInfo] = []
    if not isinstance(payload, list):
        return out
    for p in payload:
        head = p.get("head") or {}
        base = p.get("base") or {}
        user = p.get("user") or {}
        out.append(PullRequestInfo(
            provider="github",
            number=int(p.get("number", 0)),
            title=p.get("title", "") or "",
            source_branch=head.get("ref", "") or "",
            target_branch=base.get("ref", "") or "",
            url=p.get("html_url", "") or "",
            author=user.get("login", "") or "",
            draft=bool(p.get("draft", False)),
            state=p.get("state", "open") or "open"))
    return out


def parse_gitlab_mrs(payload: list) -> list[PullRequestInfo]:
    """`/api/v4/projects/{p}/merge_requests?state=opened` items."""
    out: list[PullRequestInfo] = []
    if not isinstance(payload, list):
        return out
    for p in payload:
        author = p.get("author") or {}
        state = p.get("state", "opened") or "opened"
        out.append(PullRequestInfo(
            provider="gitlab",
            number=int(p.get("iid", 0)),
            title=p.get("title", "") or "",
            source_branch=p.get("source_branch", "") or "",
            target_branch=p.get("target_branch", "") or "",
            url=p.get("web_url", "") or "",
            author=author.get("username", "") or "",
            draft=bool(p.get("draft", p.get("work_in_progress", False))),
            state={"opened": "open"}.get(state, state)))
    return out


def by_branch(prs: list[PullRequestInfo]) -> dict[str, PullRequestInfo]:
    """source branch → its open PR (first wins: providers return newest
    first, and one open PR per source branch is the platform norm)."""
    out: dict[str, PullRequestInfo] = {}
    for pr in prs:
        if pr.source_branch and pr.source_branch not in out:
            out[pr.source_branch] = pr
    return out


def create_pr_url(remote_url: str, branch: str,
                  base: str = "",
                  known_gitlab_hosts: Optional[list[str]] = None
                  ) -> Optional[str]:
    """Browser URL to open a new PR/MR for `branch` on the remote's
    forge, or None when the remote is neither GitHub nor GitLab."""
    from . import github, gitlab
    gh = github.parse_remote_url(remote_url)
    if gh is not None:
        owner, repo = gh
        frag = f"{base}...{branch}" if base else branch
        return (f"https://github.com/{owner}/{repo}/compare/"
                f"{urllib.parse.quote(frag, safe='./')}?expand=1")
    gl = gitlab.parse_remote_url(remote_url, known_gitlab_hosts)
    if gl is not None:
        host, path = gl
        q = urllib.parse.urlencode(
            {"merge_request[source_branch]": branch,
             **({"merge_request[target_branch]": base} if base else {})})
        return f"https://{host}/{path}/-/merge_requests/new?{q}"
    return None


def _http_json(url: str, headers: dict, timeout: float):
    req = urllib.request.Request(url)
    req.add_header("User-Agent", "whisper-git-tpu")
    for k, v in headers.items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def fetch_github_prs(owner: str, repo: str, token: Optional[str],
                     timeout: float = 15.0) -> PrResult:
    from .github import classify_http_error
    url = (f"https://api.github.com/repos/{owner}/{repo}/pulls"
           f"?state=open&per_page={PER_PAGE}")
    headers = {"Accept": "application/vnd.github+json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    try:
        payload = _http_json(url, headers, timeout)
    except urllib.error.HTTPError as e:
        body = ""
        try:
            body = e.read().decode("utf-8", "replace")
        except Exception:
            pass
        return PrResult("github", error=classify_http_error(e.code, body))
    except (urllib.error.URLError, OSError, TimeoutError, ValueError) as e:
        return PrResult("github", error=f"Network error: {e}")
    return PrResult("github", prs=parse_github_prs(payload))


def fetch_gitlab_mrs(host: str, project_path: str, token: Optional[str],
                     timeout: float = 15.0) -> PrResult:
    proj = urllib.parse.quote(project_path, safe="")
    url = (f"https://{host}/api/v4/projects/{proj}/merge_requests"
           f"?state=opened&per_page={PER_PAGE}")
    headers = {"PRIVATE-TOKEN": token} if token else {}
    try:
        payload = _http_json(url, headers, timeout)
    except urllib.error.HTTPError as e:
        from .gitlab import http_error_message
        return PrResult("gitlab", error=http_error_message(e.code))
    except (urllib.error.URLError, OSError, TimeoutError, ValueError) as e:
        return PrResult("gitlab", error=f"Network error: {e}")
    return PrResult("gitlab", prs=parse_gitlab_mrs(payload))


def fetch_prs_async(kind: str, a: str, b: str, token: Optional[str],
                    proxy=None) -> "queue.Queue[PrResult]":
    """kind='github' → (owner, repo); kind='gitlab' → (host, path)."""
    rx: "queue.Queue[PrResult]" = queue.Queue(maxsize=1)

    def worker():
        try:
            result = (fetch_github_prs(a, b, token) if kind == "github"
                      else fetch_gitlab_mrs(a, b, token))
        except Exception as exc:  # a dead worker wedges polling
            result = PrResult(kind, error=f"PR fetch failed: {exc}")
        rx.put(result)
        if proxy is not None:
            proxy.send_event()

    threading.Thread(target=worker, daemon=True, name=f"pr-{kind}").start()
    return rx


def drain_receivers(tab) -> bool:
    """Fold completed PR fetches into tab.pr_by_branch. Returns True
    when anything landed."""
    landed = False
    still = []
    for rx in tab.pr_receivers:
        try:
            result = rx.get_nowait()
        except queue.Empty:
            still.append(rx)
            continue
        landed = True
        if result.error is None:
            merged = dict(tab.pr_by_branch)
            # Replace this provider's entries wholesale (a closed PR must
            # drop its pill), keep the other provider's.
            merged = {br: pr for br, pr in merged.items()
                      if pr.provider != result.provider}
            merged.update(by_branch(result.prs))
            tab.pr_by_branch = merged
            tab.pr_error = None  # recovered — stale errors must not stick
        else:
            tab.pr_error = result.error
    tab.pr_receivers = still
    return landed
