"""The one result type every analysis pass emits (a copy of the JAX
package's `repro.analysis.findings`)."""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    """One contract violation, pinned to ``path:line`` for the CI log."""

    rule: str      # e.g. "sync-coercion", "registry-coherence"
    path: str      # repo-relative where possible
    line: int
    message: str
    col: int = 0

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return asdict(self)
