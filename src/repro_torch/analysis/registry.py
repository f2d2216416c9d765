"""Registry-coherence rule: declared capabilities vs implemented methods.

The JAX package's ``repro.analysis.registry``, run against the port's
``repro_torch.core.policy_registry`` with the same rule id and messages
(it is not the resolution check of ``policy_registry --check``, which
builds and runs each entry).

A :class:`~repro_torch.core.policy_registry.PolicyEntry` *declares* backends
(event / array / serving) through which factories it carries; nothing
used to check that the object a factory builds actually *implements*
that backend's decision method.  A capability without an implementation
is then a runtime ``NotImplementedError`` in the middle of a sweep (or,
worse, a silently-inherited base-class default).  This pass makes it a
lint finding instead:

* ``event``   — the policy must override ``Policy.choose_victims``
  (cooperative entries are exempt: the engine drives the ABM itself);
* ``array``   — the policy must be an ``ArrayPolicy`` overriding
  ``score_victims``, carry the entry's ``name``, and have an
  ``array_id``;
* ``serving`` — the policy must override ``ServingPolicy.victim_key``
  and carry the entry's ``name``.

Findings point at the ``register(PolicyEntry(...))`` call site in
``policy_registry.py`` where one exists, else at the factory's class.
"""

from __future__ import annotations

import ast
import contextlib
import inspect
from typing import Dict, List, Optional

from .findings import Finding

__all__ = ["check_registry"]

_RULE = "registry-coherence"


def _entry_lines() -> Dict[str, int]:
    """name -> line of its ``register(PolicyEntry(name=...))`` call."""
    from ..core import policy_registry as reg

    out: Dict[str, int] = {}
    try:
        tree = ast.parse(inspect.getsource(reg))
    except (OSError, TypeError):
        return out
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "register"):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Call):
                for kw in arg.keywords:
                    if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                        out[kw.value.value] = node.lineno
    return out


def _registry_path() -> str:
    from ..core import policy_registry as reg

    path = getattr(reg, "__file__", "policy_registry.py") or "?"
    marker = "src/"
    return path[path.index(marker):] if marker in path else path


def _overrides(obj: object, base: type, method: str) -> bool:
    impl = getattr(type(obj), method, None)
    return impl is not None and impl is not getattr(base, method)


def check_registry(registry: Optional[dict] = None) -> List[Finding]:
    """Cross-check every entry's declared backends against what its
    factories build.  ``registry`` (name -> PolicyEntry) defaults to the
    live :mod:`repro_torch.core.policy_registry` table — tests pass a copy with
    a broken entry to exercise the negative direction."""
    from ..core import policy_registry as reg

    entries = dict(reg._REGISTRY) if registry is None else dict(registry)
    lines = _entry_lines()
    path = _registry_path()
    findings: List[Finding] = []

    def emit(entry, message: str, obj: object = None) -> None:
        line = lines.get(entry.name, 0)
        loc = path
        if line == 0 and obj is not None:
            # dynamically-registered entry: point at the implementing class
            with contextlib.suppress(OSError, TypeError):
                loc = inspect.getsourcefile(type(obj)) or path
                line = inspect.getsourcelines(type(obj))[1]
        findings.append(Finding(rule=_RULE, path=loc, line=line,
                                message=f"policy {entry.name!r}: {message}"))

    for entry in entries.values():
        if not entry.backends:
            emit(entry, "declares no backend at all")
        if entry.cooperative and "event" not in entry.backends:
            emit(entry, "cooperative flag set but the event backend is "
                        "not declared (the ABM runs in the event engine)")

        if "event" in entry.backends and not entry.cooperative:
            from ..core.policies.base import Policy as EventPolicy

            obj = _build(entry, "event_factory", emit, _event_config())
            if obj is not None and not _overrides(
                    obj, EventPolicy, "choose_victims"):
                emit(entry, "declares the event backend but "
                     f"{type(obj).__name__} does not override "
                     "Policy.choose_victims", obj)

        if "array" in entry.backends:
            from ..core.array_sim.policies import ArrayPolicy

            obj = _build(entry, "array_factory", emit)
            if obj is not None:
                if not isinstance(obj, ArrayPolicy):
                    emit(entry, "array_factory returned "
                         f"{type(obj).__name__}, not an ArrayPolicy", obj)
                elif not _overrides(obj, ArrayPolicy, "score_victims"):
                    emit(entry, "declares the array backend but "
                         f"{type(obj).__name__} does not override "
                         "ArrayPolicy.score_victims", obj)
                elif getattr(obj, "name", None) != entry.name:
                    emit(entry, "array policy reports name "
                         f"{getattr(obj, 'name', None)!r} (result rows "
                         "would be mislabeled)", obj)
            if entry.array_id is None:
                emit(entry, "array backend without an array_id (stacked "
                            "configs cannot encode the lane)")

        if "serving" in entry.backends:
            from ..serving.policy_driver import ServingPolicy

            obj = _build(entry, "serving_factory", emit)
            if obj is not None:
                if not _overrides(obj, ServingPolicy, "victim_key"):
                    emit(entry, "declares the serving backend but "
                         f"{type(obj).__name__} does not override "
                         "ServingPolicy.victim_key", obj)
                elif getattr(obj, "name", None) != entry.name:
                    emit(entry, "serving policy reports name "
                         f"{getattr(obj, 'name', None)!r}", obj)

    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def _event_config():
    from ..core.engine import EngineConfig

    return EngineConfig()


def _build(entry, factory_name: str, emit, *args):
    factory = getattr(entry, factory_name)
    if factory is None:
        # backends is derived from the factories, so this only happens on
        # a hand-built (test) entry claiming a capability it cannot build
        emit(entry, f"declares a backend but {factory_name} is None")
        return None
    try:
        return factory(*args)
    except NotImplementedError:
        emit(entry, f"{factory_name} itself raises NotImplementedError")
    except Exception as exc:  # noqa: BLE001 — any factory crash is a finding
        emit(entry, f"{factory_name} raised {type(exc).__name__}: {exc}")
    return None
