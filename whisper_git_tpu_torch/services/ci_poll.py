"""CI polling orchestration: dynamic cadence + receiver draining.

Capability parity with the reference's CI poll loop (ui_app.rs:3612-3650
+ repo_tab.rs:1438-1496 trigger_ci_fetch): 15 s cadence while pipelines
are pending or within 5 min of a push, 300 s otherwise; keychain token
lookup; one fetch thread per provider; GitLab self-hosted host
auto-registration; per-commit rollup rebuild on arrival.
"""

from __future__ import annotations

import queue

from . import github, gitlab, pr, token_store

CI_POLL_FAST_SECS = 15.0
CI_POLL_SLOW_SECS = 300.0
CI_FAST_WINDOW_AFTER_PUSH = 300.0


def cadence_for(tab, now: float) -> float:
    """reference: ui_app.rs:114-127."""
    any_pending = any(
        getattr(st, "counts", None) and st.counts.pending
        for st in tab.ci_results.values())
    recent_push = (tab.last_push_time
                   and now - tab.last_push_time < CI_FAST_WINDOW_AFTER_PUSH)
    return CI_POLL_FAST_SECS if (any_pending or recent_push) \
        else CI_POLL_SLOW_SECS


def trigger_fetch(app, tab, proxy=None) -> int:
    """Spawn provider fetch threads for this tab's remotes. Returns the
    number of fetches started."""
    started = 0
    branch = tab.current_branch or ""
    head = tab.head_oid or ""
    if not head:
        return 0
    for remote, url in tab.remote_urls.items():
        gh = github.parse_remote_url(url)
        if gh is not None:
            token = token_store.get_token("github", "github.com")
            rx = github.fetch_ci_status_async(gh[0], gh[1], token, branch,
                                              head, proxy)
            tab.ci_receivers.append(("github", rx))
            tab.pr_receivers.append(
                pr.fetch_prs_async("github", gh[0], gh[1], token, proxy))
            started += 1
            continue
        gl = gitlab.parse_remote_url(url, app.config.gitlab_hosts)
        if gl is not None:
            host, path = gl
            if host != "gitlab.com" and host not in app.config.gitlab_hosts:
                app.config.register_gitlab_host(host)
                app.config.save()
            token = token_store.get_token("gitlab", host)
            rx = gitlab.fetch_ci_status_async(host, path, token, branch,
                                              head, proxy)
            tab.ci_receivers.append(("gitlab", rx))
            tab.pr_receivers.append(
                pr.fetch_prs_async("gitlab", host, path, token, proxy))
            started += 1
    return started


def drain_receivers(tab) -> bool:
    """Fold completed fetches into tab.ci_results and rebuild the
    per-commit rollups. Returns True when anything landed."""
    landed = False
    still = []
    for provider, rx in tab.ci_receivers:
        try:
            status = rx.get_nowait()
        except queue.Empty:
            still.append((provider, rx))
            continue
        landed = True
        tab.ci_results[provider] = status
        if status.error is None:
            oids = [c.oid for c in tab.commits if not c.is_synthetic][:200]
            mod = github if provider == "github" else gitlab
            rollups = mod.per_commit_rollups(status, oids)
            # Merge: keep other providers' entries, replace ours.
            for oid, roll in rollups.items():
                tab.ci_rollups[oid] = roll
    tab.ci_receivers = still
    return landed


def poll(app, tab, now: float) -> None:
    drain_receivers(tab)
    if pr.drain_receivers(tab):
        if tab.pr_error:
            # PR fetch failures have no pill surface to render on (unlike
            # CI errors, which land in ci_results and draw) — surface
            # each DISTINCT error once as a toast instead of dead state.
            if tab.pr_error != getattr(tab, "_pr_error_toasted", None):
                tab._pr_error_toasted = tab.pr_error
                app.toast("error", f"PR fetch: {tab.pr_error[:110]}")
        else:
            # Recovered: forget the last-toasted message, so the SAME
            # error recurring later (token expired again) toasts again.
            tab._pr_error_toasted = None
    if not tab.remote_urls or not tab.initial_refresh_done:
        return
    if tab.ci_receivers or tab.pr_receivers:
        return  # fetches in flight
    if now - tab.last_ci_fetch >= cadence_for(tab, now):
        tab.last_ci_fetch = now
        trigger_fetch(app, tab, app.proxy)
