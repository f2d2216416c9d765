"""The kernel contracts on the card: guard zones, poisoned buffers and
repeats, and NVIDIA's ``compute-sanitizer`` where it runs.

Counterpart of the JAX package's ``repro.analysis.absint``.  There, each
``pallas_call``'s grid and BlockSpec geometry is interpreted abstractly
and checked for coverage, index bounds, write races and the VMEM budget.
A CUDA kernel computes its own offsets, so its geometry is not data a
checker can read; instead every case of
:data:`~repro_torch.analysis.kernels.CONTRACTS` runs on the card and is
held to its plain version (the wrapper's CPU path) at its tolerance, under
two kinds of check.

:func:`device_checks`, in the process, on every case:

* ``bounds`` — every input, and every buffer the wrapper allocates
  (outputs and scratch, through ``torch.empty`` / ``torch.empty_like``),
  lies between guard zones of 4 KB; after the call every guard byte must
  be as it was.  An input's guards hold 0xFF bytes (NaN for a float, -1
  for an integer), so a read beyond an input moves the result away from
  the plain version's;
* ``coverage`` — the wrapper's buffers are filled with a poison pattern
  before the kernel runs, once with 0xFF bytes and once with 0x00 bytes;
  the outputs of the two runs must be equal and equal to the plain
  version's, so no output element is left unwritten and no uninitialised
  scratch is read (``initcheck``'s property);
* ``repeat`` — every run of one pattern is bit-equal to the first: a
  shared-memory race that changes a result shows as a difference (one
  that never changes a result this cannot see; ``racecheck`` could).

:func:`sanitize_contracts` runs every case in a child process under
``compute-sanitizer`` (``memcheck``, ``racecheck``, ``initcheck``) with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` (inside the caching allocator's
blocks an allocation has no bounds that memcheck can see).
:func:`sanitizer_probe` first runs the tool on a program with no kernel
of this repository: where the tool refuses the device ("Device not
supported"), that refusal is the tool's own limit, recorded, and every
(kernel, tool) pair is excluded by it (ROADMAP §C).  A missing tool raises.

:func:`shared_memory_rows` checks each kernel's shared memory per block
against the device's opt-in limit (the VMEM budget's counterpart).

``python -m repro_torch.analysis --sanitizers`` runs all of it on ``cuda``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from .findings import Finding

__all__ = ["EXCLUDED", "TOOLS", "contracts_on_card", "device_checks",
           "find_sanitizer", "sanitize_contracts", "sanitizer_probe",
           "shared_memory_rows"]

TOOLS = ("memcheck", "racecheck", "initcheck")
#: (CUDA kernel name, tool) -> why that tool's report there is its own
#: limit and not the kernel's fault
EXCLUDED: Dict[tuple, str] = {}
#: the line the child prints its results on
_MARK = "CONTRACT_ROWS "


def find_sanitizer() -> str:
    """The ``compute-sanitizer`` executable: on PATH, under
    ``$CUDA_HOME/bin`` or ``$CUDA_HOME/compute-sanitizer`` (default
    ``/usr/local/cuda``).  Raises ``FileNotFoundError`` if absent."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("compute-sanitizer"),
                 os.path.join(home, "bin", "compute-sanitizer"),
                 os.path.join(home, "compute-sanitizer",
                              "compute-sanitizer")):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        "compute-sanitizer not found (looked on PATH, under $CUDA_HOME/bin "
        "and $CUDA_HOME/compute-sanitizer): the kernel contracts cannot be "
        "checked")


#: bytes of guard zone before and after every guarded buffer (a multiple of
#: 512: the views keep the caching allocator's alignment)
GUARD = 4096
#: the two poison patterns of the coverage check
PATTERNS = (0xFF, 0x00)


class _Guarded:
    """Buffers placed between guard zones, and their check."""

    def __init__(self, device):
        self.device = device
        self.buffers = []          # (raw uint8 buffer, nbytes, guard byte)

    def place(self, shape, dtype, fill: int, guard: int):
        n = int(torch.Size(shape).numel()) * _EMPTY(
            (), dtype=dtype).element_size()
        body = -(-max(n, 1) // 512) * 512
        raw = _EMPTY((GUARD + body + GUARD,), dtype=torch.uint8,
                     device=self.device)
        raw.fill_(guard)
        raw[GUARD:GUARD + n].fill_(fill)
        self.buffers.append((raw, n, guard))
        return raw[GUARD:GUARD + n].view(dtype).view(shape)

    def guard_writes(self) -> int:
        """Guard bytes that no longer hold their pattern."""
        bad = 0
        for raw, n, guard in self.buffers:
            bad += int((raw[:GUARD] != guard).sum())
            bad += int((raw[GUARD + n:] != guard).sum())
        return bad


#: torch.empty and torch.empty_like, unpatched
_EMPTY, _EMPTY_LIKE = torch.empty, torch.empty_like


def _guarded_allocations(g: "_Guarded", pattern: int):
    """A context in which ``torch.empty`` / ``torch.empty_like`` on the
    checked device return a view between guard zones, filled with
    ``pattern``."""
    import contextlib

    empty, empty_like = _EMPTY, _EMPTY_LIKE
    kind = g.device.type

    def guarded_empty(*size, dtype=None, device=None, **kw):
        shape = size[0] if len(size) == 1 and isinstance(
            size[0], (tuple, list, torch.Size)) else size
        if device is None or torch.device(device).type != kind or kw:
            return empty(*size, dtype=dtype, device=device, **kw)
        return g.place(tuple(shape), dtype or torch.get_default_dtype(),
                       pattern, 0xA5)

    def guarded_empty_like(t, *, dtype=None, device=None, **kw):
        dev = torch.device(device) if device is not None else t.device
        if dev.type != kind or kw:
            return empty_like(t, dtype=dtype, device=device, **kw)
        return g.place(tuple(t.shape), dtype or t.dtype, pattern, 0xA5)

    @contextlib.contextmanager
    def ctx():
        torch.empty, torch.empty_like = guarded_empty, guarded_empty_like
        try:
            yield
        finally:
            torch.empty, torch.empty_like = empty, empty_like

    return ctx()


def device_checks(names: Optional[Sequence[str]] = None, device="cuda",
                  repeats: int = 2) -> tuple:
    """The bounds, coverage and repeat checks (module docstring) over the
    contracts (all, or those ``names``): ``(rows, findings)``, one row a
    contract.  On ``cpu`` the same checks run the plain versions (a test
    of the checker itself)."""
    import numpy as np

    from ..core.array_sim.convert import resolve_device
    from ..kernels import ops
    from .kernels import CONTRACTS

    dev = resolve_device(device)
    rows, findings = [], []
    for i, c in enumerate(CONTRACTS):
        if names is not None and c.name not in names:
            continue
        args, static = c.build(np.random.default_rng(100 + i))
        fn = getattr(ops, c.kernel)
        t0 = time.perf_counter()
        with torch.no_grad():
            want = fn(*args, **static)
        want = want if isinstance(want, tuple) else (want,)
        g = _Guarded(dev)
        dev_args = []
        for a in args:
            v = g.place(tuple(a.shape), a.dtype, 0, 0xFF)
            v.copy_(a)
            dev_args.append(v)
        outs = {}
        for pattern in PATTERNS:
            for r in range(repeats):
                with _guarded_allocations(g, pattern), torch.no_grad():
                    got = fn(*dev_args, **static)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                got = got if isinstance(got, tuple) else (got,)
                outs[(pattern, r)] = [x.cpu().clone() for x in got]
        first = outs[(PATTERNS[0], 0)]
        repeat_differs = sum(
            int((a != b).sum()) for (p, r), o in outs.items() if r
            for a, b in zip(outs[(p, 0)], o))
        pattern_differs = sum(int((a != b).sum()) for a, b in zip(
            first, outs[(PATTERNS[1], 0)]))
        bad, worst = 0, 0.0
        for got_t, w in zip(first, want):
            if c.tol == 0.0:
                bad += int((got_t != w).sum())
            else:
                gd, wd = got_t.double(), w.double()
                bad += int((~torch.isclose(gd, wd, rtol=c.tol, atol=c.tol,
                                           equal_nan=False)).sum())
                worst = max(worst, float((gd - wd).abs().nan_to_num(
                    float("inf")).max()))
        row = {"contract": c.name, "kernel": c.kernel, "mismatches": bad,
               "max_abs_err": worst, "guard_writes": g.guard_writes(),
               "pattern_differs": pattern_differs,
               "repeat_differs": repeat_differs,
               "guarded_buffers": len(g.buffers),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        for key, rule in (("mismatches", "kernel-contract-mismatch"),
                          ("guard_writes", "kernel-bounds"),
                          ("pattern_differs", "kernel-coverage"),
                          ("repeat_differs", "kernel-repeat")):
            if row[key]:
                findings.append(Finding(
                    rule=rule, path="repro_torch/kernels/csrc", line=0,
                    message=f"{c.name}: {key} = {row[key]}"))
    return rows, findings


def sanitizer_probe(timeout_s: float = 120.0) -> dict:
    """``compute-sanitizer --tool memcheck`` on a program with no kernel of
    this repository (one PyTorch fill and sum on the card): whether the
    tool runs on this device.  Raises if the tool is absent."""
    sanitizer = find_sanitizer()
    prog = ("import torch; x = torch.ones(1024, device='cuda'); "
            "print('sum', float(x.sum()))")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sanitizer, "--tool", "memcheck", sys.executable, "-c", prog],
        capture_output=True, text=True, timeout=timeout_s, env=_child_env())
    text = proc.stdout + proc.stderr
    refused = "Device not supported" in text
    return {"sanitizer": sanitizer, "supported": not refused and
            proc.returncode == 0 and "sum 1024.0" in text,
            "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "message": next((ln.strip("= ").strip() for ln in text.splitlines()
                             if "Error" in ln or "error" in ln), "")}


_ERRORS_RE = re.compile(r"ERROR SUMMARY:\s*(\d+) error")
_RACE_RE = re.compile(r"RACECHECK SUMMARY:\s*(\d+) hazards? displayed "
                      r"\((\d+) errors?, (\d+) warnings?\)")
#: a report's kernel: "... in <kernel>(...)" or "... in <kernel><...>"
_KERNEL_RE = re.compile(r"=+\s+(?:at .* )?in ([A-Za-z_][\w:]*)[<(]")


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def sanitize_contracts(tools: Sequence[str] = TOOLS,
                       names: Optional[Sequence[str]] = None,
                       timeout_s: float = 600.0,
                       log_dir: Optional[str] = None) -> tuple:
    """Every contract under each of ``tools``: ``(rows, findings)``.
    ``rows``: one per tool, with its errors, the kernels its reports
    name, the contracts' results in that child and its seconds.  A tool's
    error not in ``EXCLUDED``, a contract that disagrees with its plain
    version, or a child that fails is a finding.  ``log_dir`` keeps each
    tool's whole report.  Raises without a GPU or without the tool."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel contracts run on the card: "
                           "torch.cuda.is_available() is False")
    sanitizer = find_sanitizer()
    findings: List[Finding] = []
    rows = []
    for tool in tools:
        cmd = [sanitizer, "--tool", tool, "--error-exitcode", "9",
               "--print-limit", "100"]
        if tool == "racecheck":
            cmd += ["--racecheck-report", "hazard"]
        cmd += [sys.executable, "-m", "repro_torch.analysis.absint", "--run"]
        if names:
            cmd += ["--names", ",".join(names)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout_s, env=_child_env())
        seconds = time.perf_counter() - t0
        text = proc.stdout + proc.stderr
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            Path(log_dir, f"sanitizer_{tool}.log").write_text(text)
        m = _ERRORS_RE.search(text)
        errors = int(m.group(1)) if m else None
        race = _RACE_RE.search(text)
        kernels = sorted(set(_KERNEL_RE.findall(text)))
        contract_rows = []
        for line in proc.stdout.splitlines():
            if line.startswith(_MARK):
                contract_rows = json.loads(line[len(_MARK):])
        excluded = [k for k in kernels if (k, tool) in EXCLUDED]
        row = {"tool": tool, "errors": errors, "rc": proc.returncode,
               "kernels_reported": kernels, "excluded": excluded,
               "contracts": len(contract_rows),
               "mismatches": sum(r["mismatches"] for r in contract_rows),
               "seconds": seconds}
        if race:
            row["hazards"] = {"errors": int(race.group(2)),
                              "warnings": int(race.group(3))}
        rows.append(row)
        where = "repro_torch/kernels/csrc"
        if errors is None or not contract_rows:
            findings.append(Finding(
                rule="kernel-sanitizer", path=where, line=0,
                message=f"{tool}: the child did not finish (rc "
                        f"{proc.returncode}): {text[-2000:]}"))
            continue
        if errors and set(kernels) - set(excluded) or errors and not kernels:
            findings.append(Finding(
                rule="kernel-sanitizer", path=where, line=0,
                message=f"{tool}: {errors} error(s), in {kernels or '?'}"))
        for r in contract_rows:
            for key in ("mismatches", "guard_writes", "pattern_differs",
                        "repeat_differs"):
                if r[key]:
                    findings.append(Finding(
                        rule="kernel-contract-mismatch", path=where, line=0,
                        message=f"{r['contract']}: {key} = {r[key]} "
                                f"({tool} run)"))
    return rows, findings


def shared_memory_rows(libraries: Sequence[str], device="cuda") -> tuple:
    """Each kernel's static shared memory per block (``-Xptxas -v`` of
    this process's builds, else ``cuobjdump -res-usage`` of the library)
    against the device's opt-in limit: ``(rows, findings)``."""
    from ..kernels import _build
    from .kernels import resource_usage

    limit = torch.cuda.get_device_properties(
        torch.device(device)).shared_memory_per_block_optin
    rows, findings = [], []
    for lib in libraries:
        if _build.ptxas_usage.get(lib):
            usage = [(r["kernel"], r["smem_bytes"])
                     for r in _build.ptxas_usage[lib]]
        else:
            usage = [(r["kernel"], r["shared_bytes"] or 0)
                     for r in resource_usage(lib)]
        worst = max((b for _, b in usage), default=0)
        rows.append({"library": lib, "kernels": len(usage),
                     "max_static_smem_bytes": worst, "optin_limit": limit})
        for kernel, b in usage:
            if b > limit:
                findings.append(Finding(
                    rule="kernel-shared-memory", path=f"{lib}.cu", line=0,
                    message=f"{kernel}: {b} bytes of static shared memory, "
                            f"the device allows {limit}"))
    return rows, findings


def contracts_on_card(log_dir: Optional[str] = None) -> tuple:
    """Everything above on the card: :func:`device_checks`,
    :func:`shared_memory_rows` over every library, :func:`sanitizer_probe`
    and, where the tool runs on the device, :func:`sanitize_contracts`.
    ``(report, findings)``; a tool that refuses the device is reported
    (``report["sanitizer"]``) with every (kernel, tool) pair excluded by
    that refusal, not a finding."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel contracts run on the card: "
                           "torch.cuda.is_available() is False")
    t0 = time.perf_counter()
    from .kernels import LIBRARIES

    rows, findings = device_checks()
    smem, found = shared_memory_rows(LIBRARIES)
    findings += found
    probe = sanitizer_probe()
    report = {"device_checks": rows, "shared_memory": smem,
              "sanitizer": probe}
    if probe["supported"]:
        tool_rows, found = sanitize_contracts(log_dir=log_dir)
        report["sanitizer_tools"] = tool_rows
        findings += found
    else:
        report["sanitizer_excluded"] = {
            "pairs": [f"{c}/{t}" for c in sorted({r["kernel"] for r in rows})
                      for t in TOOLS],
            "why": "compute-sanitizer refuses this device on a program with "
                   "no kernel of this repository: " + probe["message"]}
    report["seconds"] = time.perf_counter() - t0
    return report, findings


def main(argv=None) -> int:
    """The child under ``compute-sanitizer``: ``--run [--names a,b]`` runs
    :func:`device_checks` and prints its rows on one line."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.absint")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--names", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.run:
        ap.error("nothing to do: pass --run")
    names = [n for n in args.names.split(",") if n] or None
    rows, findings = device_checks(names, device=args.device)
    print(_MARK + json.dumps(rows), flush=True)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
