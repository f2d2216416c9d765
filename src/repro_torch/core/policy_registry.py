"""Policy registry of the port: the one name table of its three
backends.

The JAX package resolves every buffer policy — event engine, array
backend, serving path — through ``repro.core.policy_registry``.  The
port keeps its own copy with the **same entries, in the same order, with
the same summaries, backends and stable integer ids** (result rows and
stacked configs carry the ids): ``lru`` = 0, ``pbm`` = 1, ``cscan`` = 2,
``opt`` = 3, and the event-only ``mru``, ``pbm_lru`` and ``attach``.

* the **event engine** (``repro_torch.core.engine.run_workload``)
  instantiates ``entry.event_factory(config)``, or drives the
  cooperative ABM itself when ``entry.cooperative`` is set;
* the **array backend** instantiates ``entry.array_factory()`` (array-
  CScan runs on the cooperative substrate ``array_sim.coop``) and
  carries ``entry.array_id`` in its configs;
* the **serving path** instantiates ``entry.serving_factory()``, the
  policy the ``ServingEngine``'s driver consults.

``python -m repro_torch.core.policy_registry --check`` resolves every
entry on each backend it declares and drives the serving engine under
each serving policy (:func:`_check`).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = [
    "PolicyEntry", "register", "get", "names", "event_policy",
    "array_policy", "array_ids", "array_name", "serving_policy",
]


@dataclass(frozen=True)
class PolicyEntry:
    """One policy, every backend.

    ``event_factory(config) -> Policy`` builds the dict-engine policy
    from an :class:`~repro_torch.core.engine.EngineConfig` (``None`` for
    array-only entries and for the cooperative mode, where the engine
    builds the ABM itself).  ``array_factory() -> ArrayPolicy`` builds
    the array-backend policy (``None`` for event-only entries).
    ``array_id`` is the stable integer the array backend carries in
    traced configs — part of the result-JSON contract, never reused.
    ``serving_factory() -> ServingPolicy`` builds the paged-KV-cache
    policy the serving engine's driver consults (``None`` for entries
    with no serving realisation).
    """

    name: str
    summary: str
    paper: bool = False          # one of the paper's four-way comparison
    cooperative: bool = False    # event engine drives it through the ABM
    event_factory: Optional[Callable[..., object]] = None
    array_factory: Optional[Callable[[], object]] = None
    array_id: Optional[int] = None
    serving_factory: Optional[Callable[[], object]] = None

    @property
    def backends(self) -> tuple:
        """Which backends can run this policy ("event", "array",
        "serving")."""
        out = []
        if self.event_factory is not None or self.cooperative:
            out.append("event")
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
    if not entry.backends:
        raise ValueError(
            f"policy {entry.name!r} has no event, array, or serving "
            "factory — register at least one backend"
        )
    if entry.array_id is not None:
        taken = {e.array_id: e.name for e in _REGISTRY.values()
                 if e.array_id is not None}
        if entry.array_id in taken:
            raise ValueError(
                f"array_id {entry.array_id} of {entry.name!r} is already "
                f"used by {taken[entry.array_id]!r} (ids are a stable "
                "result-JSON contract; pick a fresh one)"
            )
    if (entry.array_factory is not None) != (entry.array_id is not None):
        raise ValueError(
            f"policy {entry.name!r}: array_factory and array_id must be "
            "given together"
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

    ``backend="event"|"array"|"serving"`` restricts to policies that
    backend can run; ``paper_only`` restricts to the paper's four-way
    comparison.
    """
    out = []
    for e in _REGISTRY.values():
        if backend is not None and backend not in e.backends:
            continue
        if paper_only and not e.paper:
            continue
        out.append(e.name)
    return out


def event_policy(name: str, config):
    """Resolve ``name`` for the event engine.

    Returns ``(policy, cooperative)``: the instantiated ``Policy`` (or
    ``None`` in cooperative mode, where the engine owns the ABM).
    """
    e = get(name)
    if "event" not in e.backends:
        raise KeyError(
            f"policy {name!r} is array-only; event-backend policies: "
            f"{names(backend='event')}"
        )
    if e.cooperative:
        return None, True
    return e.event_factory(config), False


def array_policy(name: str):
    """Resolve ``name`` to a fresh ``ArrayPolicy`` instance (imports the
    array backend lazily)."""
    e = get(name)
    if e.array_factory is None:
        raise KeyError(
            f"policy {name!r} is event-engine-only; array-backend "
            f"policies: {names(backend='array')}"
        )
    return e.array_factory()


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
    """name -> stable array id, for every array-capable policy."""
    return {e.name: e.array_id for e in _REGISTRY.values()
            if e.array_id is not None}


def array_name(array_id: int) -> Optional[str]:
    """Inverse of :func:`array_ids` (None for unknown ids)."""
    for e in _REGISTRY.values():
        if e.array_id == array_id:
            return e.name
    return None


# ---------------------------------------------------------------------------
# Registrations.  array_id values are a stable contract (result JSONs and
# stacked configs carry them): lru=0 and pbm=1 predate the registry.
# ---------------------------------------------------------------------------

def _event_lru(config):
    from .policies.lru import LRUPolicy
    return LRUPolicy()


def _event_mru(config):
    from .policies.lru import MRUPolicy
    return MRUPolicy()


def _event_pbm(config):
    from .policies.pbm import PBMPolicy
    return PBMPolicy(time_slice=config.pbm_time_slice)


def _event_opt(config):
    from .policies.opt import OraclePolicy
    return OraclePolicy()


def _event_pbm_lru(config):
    from .policies.pbm_lru import PBMLRUPolicy
    return PBMLRUPolicy(time_slice=config.pbm_time_slice)


def _event_attach(config):
    from .policies.attach_throttle import AttachThrottlePBM
    return AttachThrottlePBM(time_slice=config.pbm_time_slice)


def _array_lru():
    from .array_sim.policies import ArrayLRU
    return ArrayLRU()


def _array_pbm():
    from .array_sim.policies import ArrayPBM
    return ArrayPBM()


def _array_cscan():
    from .array_sim.policies import ArrayCScan
    return ArrayCScan()


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


register(PolicyEntry(
    name="lru", summary="least-recently-used eviction (paper baseline)",
    paper=True, event_factory=_event_lru,
    array_factory=_array_lru, array_id=0,
    serving_factory=_serving_lru,
))
register(PolicyEntry(
    name="cscan",
    summary="Cooperative Scans: ABM chunk scheduling (paper §2)",
    paper=True, cooperative=True,
    array_factory=_array_cscan, array_id=2,
    serving_factory=_serving_cscan,
))
register(PolicyEntry(
    name="pbm",
    summary="Predictive Buffer Manager: bucketed consumption timeline "
            "(paper §3)",
    paper=True, event_factory=_event_pbm,
    array_factory=_array_pbm, array_id=1,
    serving_factory=_serving_pbm,
))
register(PolicyEntry(
    name="opt",
    summary="Belady bound on exact next-consumption distances (paper §4)",
    paper=True, event_factory=_event_opt,
    array_factory=_array_opt, array_id=3,
    serving_factory=_serving_opt,
))
register(PolicyEntry(
    name="mru", summary="most-recently-used eviction (beyond-paper)",
    event_factory=_event_mru,
))
register(PolicyEntry(
    name="pbm_lru",
    summary="PBM with LRU inside buckets (paper §5, sketched)",
    event_factory=_event_pbm_lru,
))
register(PolicyEntry(
    name="attach",
    summary="Attach&Throttle PBM (paper §5, sketched)",
    event_factory=_event_attach,
))


def _check_serving(name: str) -> None:
    """Drive the serving engine end to end under ``name``: resolve the
    policy, run a tiny oversubscribed workload, and require every request
    to complete — a serving capability flag that doesn't actually serve
    is a registry lie."""
    from ..serving import PagePool, Request, ServingEngine

    pol = serving_policy(name)
    assert pol.name == name, (pol.name, name)
    eng = ServingEngine(
        PagePool(n_pages=12, page_size=4, page_bytes=256),
        lambda reqs: [0 for _ in reqs], policy=name, max_batch=3,
    )
    for _ in range(4):
        eng.submit(Request(prompt=[1, 2, 3, 4, 5, 6], max_new_tokens=8))
    eng.run_to_completion(max_steps=500)
    assert len(eng.finished) == 4, f"{name}: {len(eng.finished)}/4 served"


def _check(verbose: bool = True) -> int:
    """Registry completeness: every entry resolves on each backend it
    declares (or is explicitly single-backend).  The serving check runs a
    real mini-workload through the ServingEngine."""
    from .engine import EngineConfig

    cfg = EngineConfig()
    failures = 0
    for name in names():
        e = get(name)
        marks = []
        for backend in ("event", "array", "serving"):
            if backend not in e.backends:
                marks.append(f"{backend}-skip")
                continue
            try:
                if backend == "event":
                    pol, coop = event_policy(name, cfg)
                    assert coop or pol is not None
                elif backend == "array":
                    assert array_policy(name) is not None
                else:
                    _check_serving(name)
                marks.append(f"{backend}-ok")
            except Exception as exc:  # noqa: BLE001
                marks.append(f"{backend}-FAIL({exc})")
                failures += 1
        if verbose:
            tag = "paper" if e.paper else "extra"
            only = ("" if len(e.backends) > 1
                    else f" [{e.backends[0]}-only]")
            print(f"  {name:8s} ({tag}){only}: {' '.join(marks)}")
    return failures


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="verify every registered policy resolves on its "
                         "declared backends")
    args = ap.parse_args()
    if args.check:
        n = _check()
        if n:
            raise SystemExit(f"{n} registry entries failed to resolve")
        print("policy registry OK:",
              f"{len(names())} policies,",
              f"event={names(backend='event')},",
              f"array={names(backend='array')},",
              f"serving={names(backend='serving')}")
    else:
        for nm in names():
            e = get(nm)
            print(f"{nm:8s} backends={'/'.join(e.backends)} "
                  f"paper={e.paper} — {e.summary}")
