"""The port's contract checker: static analysis of the step regions, the
policy registry and the kernels, and the runtime gates on the card.

Counterpart of the JAX package's ``repro.analysis``, restated for eager
PyTorch and hand-written CUDA:

* :mod:`repro_torch.analysis.lint` — stdlib-``ast`` lint over
  ``src/repro_torch``: no device-to-host sync (coercion, control flow,
  data-dependent shapes, host calls, ``print``) inside a step region,
  no resurrected deprecated surface;
* :mod:`repro_torch.analysis.registry` — capability cross-check of every
  :class:`~repro_torch.core.policy_registry.PolicyEntry` against the
  methods its factories' classes override;
* :mod:`repro_torch.analysis.kernels` — the kernels' contracts: each
  wrapper pairs with a plain version, integer keys never pass through a
  float, byte prefixes are f64, every C entry is bound; the build gate on
  the libraries; the table of contract cases;
* :mod:`repro_torch.analysis.absint` — the contract cases on the card
  under ``compute-sanitizer`` (memcheck, racecheck, initcheck);
* :mod:`repro_torch.analysis.sanitize` — the runtime half of the
  simulator: ``make_runner(sanitize=True)`` over the smoke points;
* ``python -m repro_torch.analysis --check`` — the static gate (exit 1 on
  any finding; no device touched).
"""

from .findings import Finding
from .kernels import verify_kernels
from .lint import lint_paths, lint_source, repo_src_root
from .registry import check_registry

__all__ = [
    "Finding",
    "check_registry",
    "lint_paths",
    "lint_source",
    "repo_src_root",
    "run_checks",
    "verify_kernels",
]


def run_checks(root=None, registry: bool = True, kernels: bool = True):
    """Run every static check; returns the combined finding list.  None
    touches a device: ``kernels`` toggles the kernels' AST rules (the
    contracts on the card are ``absint``'s, run by ``--sanitizers``)."""
    findings = lint_paths(root)
    if registry:
        findings += check_registry()
    if kernels:
        findings += verify_kernels(root=root)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
