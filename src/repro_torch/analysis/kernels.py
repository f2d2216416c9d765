"""Kernel contract verifier for the port's hand-written CUDA kernels.

Counterpart of the JAX package's ``repro.analysis.kernels``, in three
parts.

Layer 1 — AST rules over ``src/repro_torch/kernels`` (stdlib ``ast``,
file:line findings, no imports of the checked code):

* ``kernel-missing-oracle`` — every public ``*_kernel`` wrapper must
  pair with a plain version in ``kernels/ref.py``: ``<stem>_ref`` by
  name, or an explicit ``# analysis: oracle=<name>`` pragma on the def;
  the page-split entries (``PAGE_SPLIT_ORACLES``) must find theirs too.
  ``chip_smoke.py`` and the CPU tests hold each kernel to that pairing.
* ``kernel-float-mantissa-cast`` — an integer ``key`` / ``keys`` must not
  be cast to a float (``.float()``, ``.half()``, ``.bfloat16()``,
  ``.to(torch.float32 / float16 / bfloat16)``) unless the function
  dispatches on ``key.dtype.is_floating_point`` (or compares
  ``key.dtype``): the 2^24 rule, since the simulator's queue keys use
  ~30 bits and f32 carries 24.
* ``kernel-prefix-dtype`` — a ``cumsum`` of bytes or sizes in
  ``kernels/`` and ``core/array_sim/`` takes ``dtype=torch.float64``: a
  byte prefix in f32 depends on the order a device adds in, and the
  simulator's CPU and CUDA runs must see the same byte counts.
* ``kernel-unbound-entry`` — every ``extern "C"`` function of
  ``kernels/csrc/*.cu`` that takes a pointer is given ``argtypes`` by a
  wrapper (ctypes passes an unannotated Python int as a 32-bit int and
  cuts the pointer), and every ``lib.<name>`` a wrapper reads exists in
  a source.

The JAX package's two Pallas-only rules (``kernel-memory-space``,
``kernel-mxu-element-type``) have no source-level counterpart in CUDA:
their intent is held on the built libraries by :func:`build_gate`
(no tensor-core instruction in ``pbm_timeline``, whose byte prefixes a
tensor-core product would round; the redesigned kernels on the units
their designs rest on; no stack frame and no local memory), which
``chip_smoke.py``'s ``build`` phase calls.

Layer 2 — :data:`CONTRACTS`: the JAX package's ten contract points (i32
keys and the ragged tails included) plus the port's own paths (bf16, the
page split), each a small set of seeded operands for one kernel path.
:mod:`repro_torch.analysis.absint` runs every one on the card under
``compute-sanitizer`` and holds it to its plain version.

``verify_kernels()`` runs layer 1; ``python -m repro_torch.analysis
--check`` wires it in (the CPU, no device touched).
"""

from __future__ import annotations

import ast
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Set

from .findings import Finding
from .lint import repo_src_root

__all__ = [
    "CONTRACTS",
    "KernelContract",
    "LIBRARIES",
    "build_gate",
    "csrc_entries",
    "kernel_lint_source",
    "lint_kernel_tree",
    "ref_oracle_names",
    "verify_kernels",
]

#: float targets and their mantissa bits (bits of exact integer headroom)
FLOAT_MANTISSA = {"float64": 53, "double": 53, "float32": 24, "float": 24,
                  "float16": 11, "half": 11, "bfloat16": 8}
#: tensor methods that cast to a float dtype
_FLOAT_METHODS = {"float": "float32", "half": "float16",
                  "bfloat16": "bfloat16", "double": "float64"}
#: parameter names treated as integer-capable sort / priority keys
_KEY_PARAM = ("key", "keys")
#: files in kernels/ that are not kernel-wrapper modules
_NON_KERNEL_FILES = {"__init__.py", "ref.py", "ops.py", "cases.py",
                     "_build.py", "autograd.py", "collective.py"}
#: the page-split entries (B1-B3 beyond one block) and their plain
#: versions in ``kernels/ref.py``
PAGE_SPLIT_ORACLES = {"batched_evict[split]": "evict_page_sharded",
                      "fifo_grant[split]": "grant_page_sharded",
                      "wake_solve[split]": "wake_solve_ref",
                      "batched_evict[ranks]": "evict_rank_sharded",
                      "fifo_grant[ranks]": "grant_rank_sharded"}
#: files whose ``cumsum`` of bytes / sizes must be f64
_PREFIX_DIRS = ("kernels/", "core/array_sim/")
_BYTE_WORDS = ("byte", "size", "sz")

_ORACLE_PRAGMA = "# analysis: oracle="


def _dotted(func: ast.expr) -> Optional[str]:
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root_name(node: ast.expr) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_key_param(name: Optional[str]) -> bool:
    return name is not None and (
        name in _KEY_PARAM or name.endswith("_key") or name.endswith("_keys")
    )


def _float_target(node: ast.expr) -> Optional[str]:
    """Float dtype name if this ``.to(...)`` argument is one, else None."""
    if isinstance(node, ast.Attribute) and node.attr in FLOAT_MANTISSA:
        return node.attr
    if isinstance(node, ast.Name) and node.id in FLOAT_MANTISSA:
        return node.id
    if isinstance(node, ast.Constant) and node.value in FLOAT_MANTISSA:
        return str(node.value)
    return None


def ref_oracle_names(ref_source: str) -> Set[str]:
    """Module-level def names of ``kernels/ref.py``."""
    try:
        tree = ast.parse(ref_source)
    except SyntaxError:
        return set()
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def _oracle_pragma(src_lines: Sequence[str], node: ast.AST) -> Optional[str]:
    """``# analysis: oracle=<name>`` on the def line or the line above."""
    for ln in (node.lineno - 1, node.lineno - 2):
        if 0 <= ln < len(src_lines):
            text = src_lines[ln]
            if _ORACLE_PRAGMA in text:
                tail = text.split(_ORACLE_PRAGMA, 1)[1]
                name = tail.split()[0].strip() if tail.split() else ""
                return name or None
    return None


def _emit(findings, rule, rel, node, message) -> None:
    findings.append(Finding(rule=rule, path=rel, line=node.lineno,
                            col=node.col_offset, message=message))


def _dtype_dispatched(fn: ast.FunctionDef) -> Set[str]:
    """Parameters whose dtype the function dispatches on: it reads
    ``<param>.dtype.is_floating_point`` or compares ``<param>.dtype``
    (the sanctioned guard: integers ride an integer path)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr == "dtype":
            root = _root_name(node.value)
            if root is not None:
                out.add(root)
    return out


class _FunctionScan(ast.NodeVisitor):
    """Per-function rule sites: float-mantissa key casts, byte prefixes."""

    def __init__(self, rel: str, findings: List[Finding],
                 params: Set[str], dispatched: Set[str], prefix: bool):
        self.rel = rel
        self.findings = findings
        self.params = params
        self.dispatched = dispatched
        self.prefix = prefix

    def _cast(self, node: ast.Call, root: Optional[str], target: str):
        if FLOAT_MANTISSA[target] >= 32:      # every int32 key is exact
            return
        if _is_key_param(root) and root in self.params \
                and root not in self.dispatched:
            bits = FLOAT_MANTISSA[target]
            _emit(self.findings, "kernel-float-mantissa-cast", self.rel,
                  node,
                  f"`{ast.unparse(node)}` casts a priority key to a "
                  f"{bits}-bit-mantissa float unconditionally — integer "
                  f"keys wider than 2^{bits} collapse (the fifo_grant 2^24 "
                  f"rule).  Dispatch on {root}.dtype.is_floating_point and "
                  "keep integers on an integer path")

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            root = _root_name(func.value)
            if func.attr in _FLOAT_METHODS and not node.args:
                self._cast(node, root, _FLOAT_METHODS[func.attr])
            elif func.attr in ("to", "type"):
                target = _float_target(node.args[0]) if node.args else None
                if target is None:
                    for kw in node.keywords:
                        if kw.arg == "dtype":
                            target = _float_target(kw.value)
                if target is not None:
                    self._cast(node, root, target)
        if self.prefix and isinstance(func, ast.Attribute) \
                and func.attr == "cumsum":
            # torch.cumsum(x, ...) or x.cumsum(...): the prefix's subject
            subject = (node.args[0] if _dotted(func) == "torch.cumsum"
                       and node.args else func.value)
            dtype = next((kw.value for kw in node.keywords
                          if kw.arg == "dtype"), None)
            if any(w in ast.unparse(subject).lower() for w in _BYTE_WORDS) \
                    and not (dtype is not None
                             and _float_target(dtype) == "float64"):
                _emit(self.findings, "kernel-prefix-dtype", self.rel, node,
                      f"`{ast.unparse(node)}`: a prefix of bytes or sizes "
                      "without dtype=torch.float64 — an f32 prefix depends "
                      "on the order a device adds in")
        self.generic_visit(node)


def kernel_lint_source(source: str, rel: str,
                       ref_names: Optional[Set[str]] = None,
                       wrappers: bool = True) -> List[Finding]:
    """Layer-1 rules over one module's source.  ``ref_names`` is the set
    of plain versions in ``kernels/ref.py`` (injectable for tests;
    ``None`` skips the oracle rule); ``wrappers`` says whether the module
    is a kernel-wrapper module (the oracle and cast rules), else only the
    prefix rule applies."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as exc:
        findings.append(Finding(rule="syntax-error", path=rel,
                                line=exc.lineno or 1, message=str(exc.msg)))
        return findings
    src_lines = source.splitlines()
    prefix = any(d in rel.replace("\\", "/") for d in _PREFIX_DIRS)
    if wrappers and ref_names is not None:
        for node in tree.body:
            if not (isinstance(node, ast.FunctionDef)
                    and node.name.endswith("_kernel")
                    and not node.name.startswith("_")):
                continue
            stem = node.name[: -len("_kernel")]
            declared = _oracle_pragma(src_lines, node)
            if declared is not None:
                if declared not in ref_names:
                    findings.append(Finding(
                        rule="kernel-missing-oracle", path=rel,
                        line=node.lineno,
                        message=f"{node.name} declares oracle {declared!r} "
                                "but kernels/ref.py does not define it"))
            elif f"{stem}_ref" not in ref_names:
                findings.append(Finding(
                    rule="kernel-missing-oracle", path=rel, line=node.lineno,
                    message=f"{node.name} has no plain version: define "
                            f"`{stem}_ref` in kernels/ref.py (or declare the "
                            "pairing with `# analysis: oracle=<name>`) — the "
                            "comparison on the card is the kernel's only "
                            "executable spec"))

    class _Walk(ast.NodeVisitor):
        def visit_FunctionDef(self, fn: ast.FunctionDef) -> None:
            params = {a.arg for a in (list(fn.args.posonlyargs)
                                      + list(fn.args.args)
                                      + list(fn.args.kwonlyargs))}
            scan = _FunctionScan(rel, findings,
                                 params if wrappers else set(),
                                 _dtype_dispatched(fn), prefix)
            for stmt in fn.body:
                scan.visit(stmt)
            self.generic_visit(fn)

    _Walk().visit(tree)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------- C entries ----

_EXTERN_RE = re.compile(r'extern "C" \{(.*?)\}\s*//\s*extern "C"', re.S)
_ENTRY_RE = re.compile(
    r"^\s*(?:int|void|cudaError_t|size_t)\s+([A-Za-z_]\w*)\s*\(([^)]*)\)",
    re.M)


def csrc_entries(source: str) -> Dict[str, bool]:
    """``extern "C"`` functions of one CUDA source: name -> takes a
    pointer."""
    out: Dict[str, bool] = {}
    for block in _EXTERN_RE.findall(source):
        for name, params in _ENTRY_RE.findall(block):
            out[name] = "*" in params
    return out


def _bound_names(tree: ast.AST) -> tuple:
    """(names given argtypes, ``lib.<name>`` reads) of one wrapper module.
    A module that calls ``_build.bind(<lib>, entries, argtypes, ...)``
    gives argtypes to every string constant it holds and to
    ``<lib>_init``."""
    given: Set[str] = set()
    used: Dict[str, ast.AST] = {}
    strings: Set[str] = set()
    binds = False
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "argtypes" \
                        and isinstance(t.value, ast.Attribute):
                    given.add(t.value.attr)
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.add(node.value)
        if isinstance(node, ast.Call) and (_dotted(node.func) or "") \
                .endswith("bind") and node.args \
                and isinstance(node.args[0], ast.Constant):
            binds = True
            given.add(f"{node.args[0].value}_init")
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
                and node.value.id in ("lib", "_LIB") \
                and node.attr not in ("argtypes", "restype"):
            used.setdefault(node.attr, node)
    if binds:
        given |= strings
    return given, used


def lint_kernel_tree(root=None) -> List[Finding]:
    """Layer 1 over ``<root>/kernels`` (and the prefix rule over
    ``<root>/core/array_sim``)."""
    root = Path(root) if root is not None else repo_src_root()
    kdir = root / "kernels"
    findings: List[Finding] = []

    def rel_of(path: Path) -> str:
        try:
            return str(path.relative_to(root.parent))
        except ValueError:
            return str(path)

    ref_path = kdir / "ref.py"
    ref_names = (ref_oracle_names(ref_path.read_text(encoding="utf-8"))
                 if ref_path.exists() else set())
    for path in sorted(kdir.glob("*.py")) if kdir.is_dir() else []:
        wrappers = path.name not in _NON_KERNEL_FILES
        findings += kernel_lint_source(path.read_text(encoding="utf-8"),
                                       rel_of(path), ref_names, wrappers)
    for path in sorted((root / "core" / "array_sim").glob("*.py")):
        findings += kernel_lint_source(path.read_text(encoding="utf-8"),
                                       rel_of(path), None, wrappers=False)
    if kdir.is_dir() and ref_path.exists():
        for entry, oracle in PAGE_SPLIT_ORACLES.items():
            if oracle not in ref_names:
                findings.append(Finding(
                    rule="kernel-missing-oracle", path=rel_of(ref_path),
                    line=1, message=f"the page-split entry {entry} has no "
                                    f"plain version `{oracle}`"))
    # every pointer-taking C entry bound, every lib.<name> read defined
    entries: Dict[str, tuple] = {}
    for cu in sorted((kdir / "csrc").glob("*.cu")) if kdir.is_dir() else []:
        for name, ptr in csrc_entries(cu.read_text(encoding="utf-8")).items():
            entries[name] = (ptr, rel_of(cu))
    given: Set[str] = set()
    for path in sorted(kdir.glob("*.py")) if kdir.is_dir() else []:
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        g, used = _bound_names(tree)
        given |= g
        for name, node in sorted(used.items()):
            if entries and name not in entries:
                _emit(findings, "kernel-unbound-entry", rel_of(path), node,
                      f"`lib.{name}` is read but no extern \"C\" function "
                      "of kernels/csrc defines it")
    for name, (ptr, rel) in sorted(entries.items()):
        if ptr and name not in given:
            findings.append(Finding(
                rule="kernel-unbound-entry", path=rel, line=1,
                message=f"extern \"C\" {name} takes a pointer but no "
                        "wrapper gives it argtypes (ctypes would pass a "
                        "Python int as a 32-bit int and cut the pointer)"))
    return findings


def verify_kernels(root=None) -> List[Finding]:
    """Layer 1 (no device touched)."""
    findings = lint_kernel_tree(root)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# -------------------------------------------------------- build gate ----

#: the kernel libraries, one a source of ``kernels/csrc``
LIBRARIES = ("flash_attention", "mamba2_scan", "mlstm", "paged_attention",
             "pbm_timeline")

#: SASS instructions that show which of the card's features a library uses:
#: warpgroup MMA, warp MMA (and among those, TF32 ones), TMA tensor loads,
#: bulk copies, cp.async
SASS_OPS = ("HGMMA", "HMMA", "HMMA.TF32", "UTMALDG", "UBLKCP", "LDGSTS")
#: what each redesigned library must show (any one of the names):
#: flash_attention's bf16 arm wgmma and TMA, its f32 arm's P V TF32 warp MMA
SASS_REQUIRED = {"flash_attention": (("HGMMA",), ("UTMALDG",),
                                     ("HMMA.TF32",)),
                 "paged_attention": (("LDGSTS", "UBLKCP"),),
                 "mamba2_scan": (("HGMMA", "HMMA"),),
                 "mlstm": (("HMMA", "HGMMA"),)}
#: what a library must not show: the buffer-pool kernels sum whole byte
#: counts, which a tensor-core product would round (the JAX package's
#: ``kernel-mxu-element-type`` rule, held on the binary)
SASS_FORBIDDEN = {"pbm_timeline": ("HGMMA", "HMMA")}
#: kernels that must be listed, each with the number of its instantiations:
#: in a library outside SASS_REQUIRED the redesigned kernels, which alone
#: are held to no stack frame and no local memory (every kernel of a
#: SASS_REQUIRED library is); in mlstm the f32 and the bf16 path's kernels
#: (the JAX package's ``kernel-memory-space`` rule, held on the binary:
#: nothing of a kernel's working set is left to local memory)
NO_LOCAL_KERNELS = {"pbm_timeline": {"fifo_grant_kernel": 1,
                                     "wake_solve_kernel": 1,
                                     "batched_evict_kernel": 2,
                                     "split_evict_cand": 2,
                                     "split_queue_cand": 2,
                                     "split_sort_slices": 3,
                                     "split_rank": 1,
                                     "split_evict_finish": 1,
                                     "split_grant_finish": 1,
                                     "split_wake_finish": 1},
                    "mlstm": {"mlstm_ffma": 2, "mlstm_scores_bf16": 1,
                              "mlstm_recur_bf16": 4, "mlstm_combine": 2}}


def _cuobjdump(flag: str, name: str) -> str:
    """``cuobjdump <flag>`` of the built library of ``name``."""
    from ..kernels import _build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run(
        [cuobjdump, flag, str(_build.library_path(name))],
        capture_output=True, text=True, check=True).stdout


def sass_counts(name: str) -> dict:
    """Instructions of ``SASS_OPS`` in the built library of ``name``
    (``cuobjdump -sass``); ``HMMA.TF32`` counts the HMMA whose modifiers
    name TF32 (``HMMA.1688.F32.TF32``), which ``HMMA`` counts too."""
    counts = dict.fromkeys(SASS_OPS, 0)
    for line in _cuobjdump("-sass", name).splitlines():
        words = line.split("*/", 1)[-1].split()
        if words and words[0].startswith("@"):      # a predicate
            words = words[1:]
        parts = words[0].rstrip(";").split(".") if words else [""]
        if parts[0] in counts:
            counts[parts[0]] += 1
        if parts[0] == "HMMA" and "TF32" in parts[1:]:
            counts["HMMA.TF32"] += 1
    return counts


def resource_usage(name: str) -> list:
    """Per kernel of the built library of ``name``, its registers, stack
    frame, static shared memory and local memory as the binary records them
    (``cuobjdump -res-usage``): read from the library on disk, so a library
    that an earlier run built reports the same as a fresh build."""
    rows, kernel = [], None
    for line in _cuobjdump("-res-usage", name).splitlines():
        m = re.search(r"Function ([^\s:]+):", line)
        if m:
            kernel = m.group(1)
        if "REG:" in line:
            v = {k: int(n) for k, n in re.findall(r"(\w+):(\d+)", line)}
            rows.append({"kernel": kernel, "registers": v.get("REG"),
                         "stack_bytes": v.get("STACK"),
                         "shared_bytes": v.get("SHARED"),
                         "local_bytes": v.get("LOCAL")})
    return rows


def build_evidence_ok(usage: dict, sass: dict):
    """The redesigned kernels' libraries use the features their designs
    rest on and none they must not, and every kernel in them (in a library
    of ``NO_LOCAL_KERNELS`` outside ``SASS_REQUIRED``: each kernel named
    there) is listed by ``cuobjdump -res-usage`` with no stack frame and no
    local memory (no spill, no array in local memory).  A library or a
    named kernel (every instantiation) that is not listed fails."""
    for lib, groups in SASS_REQUIRED.items():
        for names in groups:
            if not any(sass.get(lib, {}).get(n, 0) for n in names):
                return False, f"{lib}: no {' / '.join(names)} in its SASS"
    for lib, names in SASS_FORBIDDEN.items():
        for op in names:
            if sass.get(lib, {}).get(op, 0):
                return False, f"{lib}: {op} in its SASS"
    gated = {lib: usage.get(lib, []) for lib in SASS_REQUIRED}
    for lib, kernels in NO_LOCAL_KERNELS.items():
        rows = usage.get(lib, [])
        for kernel, count in kernels.items():
            listed = sum(kernel in (row["kernel"] or "") for row in rows)
            if listed < count:
                return False, (f"{lib}: cuobjdump -res-usage lists {listed} "
                               f"of the {count} instantiations of {kernel}")
        if lib not in SASS_REQUIRED:
            gated[lib] = [row for row in rows
                          if any(k in (row["kernel"] or "") for k in kernels)]
    for lib, rows in gated.items():
        if not rows:
            return False, f"{lib}: cuobjdump -res-usage lists no kernel"
        for row in rows:
            if row["stack_bytes"] != 0 or row["local_bytes"] != 0:
                return False, f"{lib}: {row['kernel']} uses local memory"
    return True, ""


def build_gate(libraries: Sequence[str]) -> dict:
    """The build gate over the built ``libraries``: ``{"resource_usage",
    "sass", "ok", "why"}`` (``cuobjdump`` of each library)."""
    out = {"resource_usage": {name: resource_usage(name)
                              for name in libraries},
           "sass": {name: sass_counts(name) for name in libraries}}
    out["ok"], out["why"] = build_evidence_ok(out["resource_usage"],
                                              out["sass"])
    return out


# -------------------------------------------------------------- contracts --

class KernelContract(NamedTuple):
    """One kernel path and the operands it is verified at.

    ``build(rng)`` returns ``(args, static)``: CPU tensors and the
    wrapper's keyword arguments.  The contract runs ``kernels.ops.<op>``
    on the card and on the CPU (the plain version) and holds the two to
    ``tol`` (0: equal).  Shapes are the JAX package's contract points
    where it has one, small enough for a run under ``compute-sanitizer``.
    """

    name: str
    kernel: str          # the kernels.ops entry
    build: Callable
    tol: float


def _np():
    import numpy as np
    return np


def _t(x):
    import torch
    return torch.from_numpy(_np().ascontiguousarray(x))


def _evict(P: int, key_dtype: str, vmax: int, page_shards: int = 1):
    def build(rng):
        np = _np()
        L = 3
        if key_dtype == "f32":
            key = rng.choice(np.array([-0.0, 0.0, 0.5, -1.5, 2.0],
                                      np.float32), (L, P))
            key[1] = rng.normal(0.0, 1.0, P).astype(np.float32)
        else:
            key = rng.integers(2**24 - 2, 2**24 + 2, (L, P)).astype(np.int32)
        return ([_t(key), _t(rng.integers(1, 9, (L, P)).astype(np.float32)),
                 _t(rng.random((L, P)) < 0.7),
                 _t(np.array([1e3, 0.0, 1e9], np.float32))],
                {"vmax": vmax, "page_shards": page_shards})
    return build


def _queue_keys(rng, fractions, P):
    from ..kernels.cases import queue_keys
    return queue_keys(rng, fractions, P).astype(_np().int32)


def _grant(P: int, vmax: int, page_shards: int = 1):
    def build(rng):
        np = _np()
        return ([_t(_queue_keys(rng, [0.5, 0.2, 0.9], P)),
                 _t(rng.integers(1, 9, (3, P)).astype(np.float32)),
                 _t(np.array([1e9, 50.0, 4e3], np.float32)),
                 _t(np.array([5000, 8, 3000], np.int32))],
                {"vmax": vmax, "page_shards": page_shards})
    return build


def _wake(P: int, h_cap: int):
    def build(rng):
        np = _np()
        return ([_t(_queue_keys(rng, [0.3, 0.0, 0.6], P)),
                 _t(rng.integers(1, 9, (3, P)).astype(np.float32)),
                 _t(np.array([30.0, 0.0, 100.0], np.float32)),
                 _t(np.array([20.0, 5.0, -1.0], np.float32)),
                 _t(np.array([6, 3, 40], np.int32))],
                {"h_cap": h_cap})
    return build


def _paged(dtype: str):
    def build(rng):
        import torch
        np = _np()
        b, h, hk, dh = 2, 4, 2, 128
        page, per_seq, n_pages = 16, 3, 10
        # the table holds the pool's LAST page id (the JAX contract point)
        pt = np.arange(b * per_seq, dtype=np.int32).reshape(b, -1)
        pt[0, 0] = n_pages - 1
        dt = getattr(torch, dtype)
        q = _t(rng.normal(size=(b, h, dh)).astype(np.float32)).to(dt)
        kp = _t(rng.normal(size=(n_pages, page, hk, dh)).astype(np.float32))
        vp = _t(rng.normal(size=(n_pages, page, hk, dh)).astype(np.float32))
        return ([q, kp.to(dt), vp.to(dt), _t(pt),
                 _t(np.array([page * per_seq, page * per_seq - 5],
                             np.int32))], {})
    return build


def _flash(dtype: str, dh: int = 128):
    def build(rng):
        import torch
        np = _np()
        b, t, h = 1, 256, 2
        dt = getattr(torch, dtype)
        q, k, v = (_t(rng.normal(size=(b, t, h, dh)).astype(np.float32))
                   .to(dt) for _ in range(3))
        return [q, k, v], {"causal": True}
    return build


def _mamba(dtype: str):
    def build(rng):
        import torch
        np = _np()
        B, T, H, P, N = 2, 256, 2, 64, 64
        dt = getattr(torch, dtype)
        return ([_t(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(dt),
                 _t(-rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32)),
                 _t(rng.normal(size=(B, T, N)).astype(np.float32)).to(dt),
                 _t(rng.normal(size=(B, T, N)).astype(np.float32)).to(dt)],
                {})
    return build


def _flash_wide(dh: int, T: int, S: int, causal: bool, window=None,
                dtype: str = "float32"):
    """B5 off the contract point: GQA 2:1, a window, non-causal or T < S;
    a dh off 8 (padded) or past 256 (the f32 kernel's output slices)."""
    def build(rng):
        import torch
        np = _np()
        dt = getattr(torch, dtype)
        q = _t(rng.normal(size=(1, T, 4, dh)).astype(np.float32)).to(dt)
        k, v = (_t(rng.normal(size=(1, S, 2, dh)).astype(np.float32)).to(dt)
                for _ in range(2))
        return [q, k, v], {"causal": causal, "window": window}
    return build


def _mamba_wide(dtype: str, P: int, N: int):
    """B6 past its tiles: the state in slices, off-16 widths padded."""
    def build(rng):
        import torch
        np = _np()
        B, T, H = 1, 300, 2
        dt = getattr(torch, dtype)
        return ([_t(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(dt),
                 _t(rng.uniform(0.6, 1.0, (B, T, H)).astype(np.float32)),
                 _t(rng.normal(size=(B, T, N)).astype(np.float32) / 4).to(dt),
                 _t(rng.normal(size=(B, T, N)).astype(np.float32) / 4).to(dt)],
                {})
    return build


def _mlstm(dtype: str, K: int = 64, P: int = 64, T: int = 256):
    def build(rng):
        import torch
        np = _np()
        B, H = 2, 2
        dt = getattr(torch, dtype)
        qk = [_t(rng.normal(size=(B, T, H, K)).astype(np.float32)
                 / (8 if K <= 64 else 2)).to(dt) for _ in range(2)]
        return ([*qk,
                 _t(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(dt),
                 _t(-rng.uniform(0.0, 0.3, (B, T, H)).astype(np.float32)),
                 _t(rng.normal(size=(B, T, H)).astype(np.float32))], {})
    return build


#: every kernel path of B1-B7: the JAX package's ten contract points
#: (``repro.analysis.kernels.CONTRACTS``), then the port's own paths
CONTRACTS = (
    KernelContract("batched_evict", "batched_evict", _evict(4096, "f32", 64),
                   0.0),
    KernelContract("batched_evict[i32]", "batched_evict",
                   _evict(4096, "i32", 64), 0.0),
    KernelContract("fifo_grant", "fifo_grant", _grant(4096, 384), 0.0),
    KernelContract("fifo_grant[tail]", "fifo_grant",
                   _grant(3 * 512 + 129, 384), 0.0),
    KernelContract("wake_solve", "wake_solve", _wake(4096, 16), 0.0),
    KernelContract("wake_solve[tail]", "wake_solve",
                   _wake(3 * 512 + 129, 16), 0.0),
    KernelContract("paged_attention", "paged_attention", _paged("float32"),
                   3e-5),
    KernelContract("flash_attention", "flash_attention", _flash("float32"),
                   3e-5),
    KernelContract("mamba2_scan", "mamba2_scan", _mamba("float32"), 2e-3),
    KernelContract("mlstm_chunked", "mlstm_chunked", _mlstm("float32"), 2e-3),
    # the port's paths: B1's whole row, the page split (sharded and beyond
    # one block), B4-B7 in bf16
    KernelContract("batched_evict[full]", "batched_evict",
                   _evict(3072, "f32", 2048), 0.0),
    KernelContract("batched_evict[split]", "batched_evict",
                   _evict(8832, "f32", 2048, page_shards=2), 0.0),
    KernelContract("batched_evict[split,i32]", "batched_evict",
                   _evict(20_000, "i32", 64), 0.0),
    KernelContract("fifo_grant[split]", "fifo_grant",
                   _grant(20_000, 16, page_shards=4), 0.0),
    KernelContract("wake_solve[split]", "wake_solve", _wake(20_000, 64), 0.0),
    KernelContract("paged_attention[bf16]", "paged_attention",
                   _paged("bfloat16"), 3e-2),
    KernelContract("flash_attention[bf16]", "flash_attention",
                   _flash("bfloat16"), 3e-2),
    KernelContract("flash_attention[bf16,dh64]", "flash_attention",
                   _flash("bfloat16", 64), 3e-2),
    KernelContract("mamba2_scan[bf16]", "mamba2_scan", _mamba("bfloat16"),
                   3e-2),
    KernelContract("mlstm_chunked[bf16]", "mlstm_chunked",
                   _mlstm("bfloat16"), 3e-2),
    # the widths past the model kernels' tiles, and B5's 3xTF32 f32 arm
    KernelContract("mamba2_scan[n256]", "mamba2_scan",
                   _mamba_wide("float32", 64, 256), 2e-3),
    KernelContract("mamba2_scan[bf16,n256]", "mamba2_scan",
                   _mamba_wide("bfloat16", 64, 256), 3e-2),
    KernelContract("mamba2_scan[bf16,p24,n144]", "mamba2_scan",
                   _mamba_wide("bfloat16", 24, 144), 3e-2),
    KernelContract("mlstm_chunked[k2048]", "mlstm_chunked",
                   _mlstm("float32", 2048, 64, 130), 2e-3),
    KernelContract("mlstm_chunked[bf16,k2048]", "mlstm_chunked",
                   _mlstm("bfloat16", 2048, 64, 130), 3e-2),
    KernelContract("mlstm_chunked[bf16,k1025,p512]", "mlstm_chunked",
                   _mlstm("bfloat16", 1025, 512, 70), 3e-2),
    KernelContract("flash_attention[dh64,window]", "flash_attention",
                   _flash_wide(64, 200, 200, True, 48), 3e-5),
    KernelContract("flash_attention[dh160,full]", "flash_attention",
                   _flash_wide(160, 150, 150, False), 3e-5),
    KernelContract("flash_attention[dh256,t<s]", "flash_attention",
                   _flash_wide(256, 90, 200, True), 3e-5),
    # B5 past its kernels' widths: dh off 8 (padded), past 256 (sliced;
    # bf16 on the f32 kernel)
    KernelContract("flash_attention[dh12]", "flash_attention",
                   _flash_wide(12, 200, 200, True), 3e-5),
    KernelContract("flash_attention[bf16,dh100,window]", "flash_attention",
                   _flash_wide(100, 200, 200, True, 48, "bfloat16"), 3e-2),
    KernelContract("flash_attention[dh264,full]", "flash_attention",
                   _flash_wide(264, 150, 150, False), 3e-5),
    KernelContract("flash_attention[bf16,dh320,t<s]", "flash_attention",
                   _flash_wide(320, 90, 200, True, None, "bfloat16"), 3e-2),
    KernelContract("flash_attention[dh512]", "flash_attention",
                   _flash_wide(512, 130, 130, True), 3e-5),
)
