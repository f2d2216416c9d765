"""Telemetry of the port's simulator — three tiers, as in the JAX
package's ``repro.obs``.

1. **Carried counters** (:mod:`repro_torch.obs.counters`): a lane-major
   :class:`Telemetry` tuple threaded through the step's carry behind
   ``make_runner(telemetry=True)``; off, the step runs not one operator
   more.
2. **Flight recorder** (:mod:`repro_torch.obs.trace`): the host-looped
   :class:`~repro_torch.obs.trace.TraceSession`, exporting Chrome /
   Perfetto JSON per macro-step, plus the serving engine's structured
   events converter.
3. **Provenance** (:mod:`repro_torch.obs.manifest`): the manifest dict
   stamped onto a run's results.

``trace`` imports the simulator lazily, so importing :mod:`repro_torch.obs`
from inside ``array_sim`` is free of cycles.
"""

from .counters import (  # noqa: F401
    N_BINS,
    Telemetry,
    count,
    hist,
    init_telemetry,
    lane_slice,
    log2_bin,
    summarize,
)
from .manifest import collect as collect_manifest, spec_hash  # noqa: F401

__all__ = [
    "N_BINS", "Telemetry", "count", "hist", "init_telemetry",
    "lane_slice", "log2_bin", "summarize", "collect_manifest",
    "spec_hash",
]
