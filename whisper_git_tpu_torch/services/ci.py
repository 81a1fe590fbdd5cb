"""Provider-agnostic CI status core.

Capability parity with reference src/ci.rs: CiProvider, CiState,
CiCounts.overall_state (failure > pending > success), branch-level
CiStatus, per-commit CiCommitRollup, cross-provider merge.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Iterable, Optional


class CiProvider(Enum):
    GITHUB = "github"
    GITLAB = "gitlab"


class CiState(Enum):
    SUCCESS = "success"
    FAILURE = "failure"
    PENDING = "pending"
    UNKNOWN = "unknown"


@dataclass
class CiCounts:
    success: int = 0
    failure: int = 0
    pending: int = 0

    def overall_state(self) -> Optional[str]:
        """failure > pending > success (reference: ci.rs CiCounts)."""
        if self.failure:
            return "failure"
        if self.pending:
            return "pending"
        if self.success:
            return "success"
        return None

    def add(self, state: CiState) -> None:
        if state is CiState.SUCCESS:
            self.success += 1
        elif state is CiState.FAILURE:
            self.failure += 1
        elif state is CiState.PENDING:
            self.pending += 1


@dataclass
class CiRun:
    name: str
    state: CiState
    run_id: int = 0
    head_sha: str = ""
    url: str = ""


@dataclass
class CiStatus:
    """Branch-level summary for one provider."""

    provider: CiProvider
    branch: str = ""
    head_sha: str = ""
    counts: CiCounts = field(default_factory=CiCounts)
    runs: list = field(default_factory=list)
    error: Optional[str] = None

    def overall(self) -> Optional[str]:
        return self.counts.overall_state()


@dataclass
class CiCommitRollup:
    """Per-commit dot strip, sorted fail > pending > pass
    (reference: github.rs:263)."""

    oid: str
    states: list = field(default_factory=list)  # ["failure", "pending", ...]

    @staticmethod
    def from_runs(oid: str, runs: Iterable[CiRun]) -> "CiCommitRollup":
        order = {"failure": 0, "pending": 1, "success": 2, "unknown": 3}
        states = sorted((r.state.value for r in runs
                         if r.state is not CiState.UNKNOWN),
                        key=lambda s: order.get(s, 9))
        return CiCommitRollup(oid=oid, states=states)


def merge_statuses(statuses: Iterable[CiStatus]) -> CiCounts:
    """Cross-provider merge (reference: ci.rs:120)."""
    total = CiCounts()
    for st in statuses:
        total.success += st.counts.success
        total.failure += st.counts.failure
        total.pending += st.counts.pending
    return total


def overall_of_results(statuses: Iterable) -> Optional[str]:
    return merge_statuses(
        [s for s in statuses if isinstance(s, CiStatus)]).overall_state()
