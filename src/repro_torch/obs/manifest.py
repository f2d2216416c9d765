"""Run provenance: the manifest dict stamped onto a run's results.

Counterpart of the JAX package's ``repro.obs.manifest``.  A difference
between two runs is only actionable if the runs are *attributable* —
same code? same PyTorch and CUDA? same card? same compiled workload?  The
manifest answers that: the git sha, the torch and CUDA versions, the
device, a content hash of the ``SimSpec`` arrays (the same 12 hex
characters as the JAX package's for the same workload), the time engine
of the runner and, when the run collected one, the telemetry summary.
Everything here runs on the host after the run.
"""

from __future__ import annotations

import hashlib
import platform
import subprocess
import sys
from typing import Optional

import numpy as np

_GIT_SHA: Optional[str] = None


def git_sha() -> str:
    """Current commit sha (cached; ``"unknown"`` outside a checkout)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        try:
            _GIT_SHA = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                capture_output=True, text=True, timeout=10, check=True,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA = "unknown"
    return _GIT_SHA


def spec_hash(spec) -> str:
    """Content hash of a :class:`SimSpec` (12 hex chars): the arrays and
    static dims that define the compiled workload.  Two runs with equal
    hashes stepped the same machine."""
    h = hashlib.sha1()
    for name, v in sorted(spec._asdict().items()):
        h.update(name.encode())
        if isinstance(v, np.ndarray):
            h.update(v.tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()[:12]


def collect(*, spec=None, runner=None, device=None,
            stepper: Optional[str] = None, sanitize: Optional[bool] = None,
            telemetry: Optional[dict] = None, **extra) -> dict:
    """Build one manifest dict.  ``runner`` (a ``make_runner`` product)
    contributes its stepper, device, sanitize mode and ``trace_count``
    (the config signatures it ran: an eager runner traces nothing);
    explicit keywords win; ``extra`` keys pass through.  The JAX package's
    ``jax`` / ``jaxlib`` become ``torch`` / ``cuda`` here."""
    import torch

    if runner is not None:
        if stepper is None:
            stepper = getattr(runner, "stepper", None)
        if device is None:
            device = getattr(runner, "device", None)
        if sanitize is None:
            sanitize = getattr(runner, "sanitize", None)
    man = {
        "git_sha": git_sha(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": sys.platform,
    }
    if device is not None:
        dev = torch.device(device)
        man["device"] = (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else dev.type)
    if spec is not None:
        man["spec_hash"] = spec_hash(spec)
    if stepper is not None:
        man["stepper"] = stepper
    if sanitize is not None:
        man["sanitize"] = bool(sanitize)
    if runner is not None and hasattr(runner, "trace_count"):
        man["trace_count"] = runner.trace_count()
    if telemetry is not None:
        man["telemetry"] = telemetry
    man.update(extra)
    return man
