"""Policy registry of the port: the array and serving sides of the one
name table.

The JAX package resolves every buffer policy — event engine, array
backend, serving path — through ``repro.core.policy_registry``.  The
port keeps its own copy of the array and serving sides with the **same
names, the same registration order and the same stable integer ids**
(result rows and stacked configs carry them): ``lru`` = 0, ``pbm`` = 1,
``cscan`` = 2, ``opt`` = 3.  ``names(backend="serving")`` is
``["lru", "cscan", "pbm", "opt"]`` as in the JAX package.

``cscan`` is registered with its id but its array substrate
(``array_sim.coop``) is not ported yet: resolving its array policy raises
``NotImplementedError`` so a lane labelled ``cscan`` can never run as
another policy.  Its serving realisation (``ServingCScan``) needs no
substrate and resolves.  Event-engine factories arrive with that slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = [
    "PolicyEntry", "register", "get", "names", "array_policy",
    "array_ids", "array_name", "serving_policy",
]


@dataclass(frozen=True)
class PolicyEntry:
    """One policy.  ``array_factory() -> ArrayPolicy`` builds the array
    policy; ``array_id`` is the stable integer a config carries.
    ``serving_factory() -> ServingPolicy`` builds the paged-KV-cache
    policy the serving engine's driver consults."""

    name: str
    summary: str
    paper: bool = False
    cooperative: bool = False
    array_factory: Optional[Callable[[], object]] = None
    array_id: Optional[int] = None
    serving_factory: Optional[Callable[[], object]] = None

    @property
    def backends(self) -> tuple:
        """Which backends can run this policy ("array", "serving")."""
        out = []
        if self.array_factory is not None:
            out.append("array")
        if self.serving_factory is not None:
            out.append("serving")
        return tuple(out)


_REGISTRY: Dict[str, PolicyEntry] = {}


def register(entry: PolicyEntry) -> PolicyEntry:
    """Add a policy to the registry (name and array_id must be unused)."""
    if entry.name in _REGISTRY:
        raise ValueError(f"policy {entry.name!r} already registered")
    if (entry.array_factory is None) or (entry.array_id is None):
        raise ValueError(
            f"policy {entry.name!r}: array_factory and array_id must both "
            "be given"
        )
    taken = {e.array_id: e.name for e in _REGISTRY.values()}
    if entry.array_id in taken:
        raise ValueError(
            f"array_id {entry.array_id} of {entry.name!r} is already used "
            f"by {taken[entry.array_id]!r} (ids are a stable result "
            "contract; pick a fresh one)"
        )
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> PolicyEntry:
    """Look up a policy by name; unknown names list what exists."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered policies: "
            f"{sorted(_REGISTRY)} (see repro_torch.core.policy_registry)"
        ) from None


def names(backend: Optional[str] = None, paper_only: bool = False,
          ) -> List[str]:
    """Registered policy names, in registration order.

    ``backend="array"|"serving"`` restricts to policies that backend can
    run; ``paper_only`` restricts to the paper's four-way comparison."""
    out = []
    for e in _REGISTRY.values():
        if backend is not None and backend not in e.backends:
            continue
        if paper_only and not e.paper:
            continue
        out.append(e.name)
    return out


def array_policy(name: str):
    """Resolve ``name`` to a fresh ``ArrayPolicy`` instance."""
    return get(name).array_factory()


def serving_policy(name: str):
    """Resolve ``name`` to a fresh ``ServingPolicy`` instance for the
    paged-KV serving engine (imports ``repro_torch.serving`` lazily)."""
    e = get(name)
    if e.serving_factory is None:
        raise KeyError(
            f"policy {name!r} has no serving realisation; serving-capable "
            f"policies: {names(backend='serving')}"
        )
    return e.serving_factory()


def array_ids() -> Dict[str, int]:
    """name -> stable array id."""
    return {e.name: e.array_id for e in _REGISTRY.values()}


def array_name(array_id: int) -> Optional[str]:
    """Inverse of :func:`array_ids` (None for unknown ids)."""
    for e in _REGISTRY.values():
        if e.array_id == array_id:
            return e.name
    return None


def _array_lru():
    from .array_sim.policies import ArrayLRU
    return ArrayLRU()


def _array_pbm():
    from .array_sim.policies import ArrayPBM
    return ArrayPBM()


def _array_cscan():
    raise NotImplementedError("array-CScan: not ported yet")


def _array_opt():
    from .array_sim.policies import ArrayOPT
    return ArrayOPT()


def _serving_lru():
    from ..serving.policy_driver import ServingLRU
    return ServingLRU()


def _serving_pbm():
    from ..serving.policy_driver import ServingPBM
    return ServingPBM()


def _serving_cscan():
    from ..serving.policy_driver import ServingCScan
    return ServingCScan()


def _serving_opt():
    from ..serving.policy_driver import ServingOPT
    return ServingOPT()


# Registration order and ids mirror the JAX package's registry.
register(PolicyEntry(
    name="lru", summary="least-recently-used eviction (paper baseline)",
    paper=True, array_factory=_array_lru, array_id=0,
    serving_factory=_serving_lru,
))
register(PolicyEntry(
    name="cscan",
    summary="Cooperative Scans: ABM chunk scheduling (paper §2)",
    paper=True, cooperative=True, array_factory=_array_cscan, array_id=2,
    serving_factory=_serving_cscan,
))
register(PolicyEntry(
    name="pbm",
    summary="Predictive Buffer Manager: bucketed consumption timeline "
            "(paper §3)",
    paper=True, array_factory=_array_pbm, array_id=1,
    serving_factory=_serving_pbm,
))
register(PolicyEntry(
    name="opt",
    summary="Belady bound on exact next-consumption distances (paper §4)",
    paper=True, array_factory=_array_opt, array_id=3,
    serving_factory=_serving_opt,
))
