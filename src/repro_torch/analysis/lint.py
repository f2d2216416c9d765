"""AST lint pass over ``src/repro_torch``: the step regions' sync contract.

Counterpart of the JAX package's ``repro.analysis.lint``, restated for
eager PyTorch.  In the JAX package a traced region must not coerce,
branch on, or call the host with a traced value: each of those either
fails at trace time or bakes a constant into the compiled step.  In the
port the step runs eagerly and each of them is a device-to-host
synchronisation in the middle of a step: the host waits for the device
queue to drain, then launches the rest of the step into an empty queue.
The simulator's step is bound by launch latency on the host, so every
such sync costs a step its overlap.  The runner reads the device once a
slice and once a macro-step, by design; nothing inside a step may.

Step regions (where the rules apply)
------------------------------------
The JAX package's traced regions, file for file:

* every function in ``repro_torch/kernels/*.py`` (the wrappers of
  B1-B7 and their plain versions run inside the step), except the build
  (``_build.py``) and the fuzz cases (``cases.py``), which are host tools;
* every function in ``repro_torch/core/array_sim/policies.py`` and
  ``repro_torch/core/array_sim/coop.py`` (policy hooks and the
  cooperative substrate are called from inside the step);
* every function in ``repro_torch/obs/counters.py`` (the carried
  counters; the host-side summarisers carry ``# analysis: host``);
* the *nested* functions of ``make_step`` / ``_runner`` in
  ``repro_torch/core/array_sim/sim.py`` (the enclosing bodies are host
  builders; the runner's own loop carries ``# analysis: host``).

A ``# analysis: host`` comment on (or directly above) a ``def`` opts a
host-side helper out, with the reason on the same line; ``# analysis:
traced`` opts a module-level function in.  Pragma names are validated:
an ``# analysis:`` comment naming anything outside the vocabulary
(``host`` / ``traced`` / ``obs`` / ``revisit`` / ``oracle=<name>``) is
itself a finding (rule ``unknown-analysis-pragma``), so a typo'd opt-out
fails the gate instead of opting nothing out.

Rules
-----
* ``sync-coercion``: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()`` on a tensor, or ``float`` / ``int`` / ``bool`` of one;
* ``sync-control-flow``: Python ``if`` / ``while`` / ``assert`` / a
  conditional expression / ``and`` / ``or`` / ``not`` on a tensor, or a
  ``for`` / ``range`` over one;
* ``sync-dynamic-shape``: an operator whose output shape depends on the
  data (``nonzero``, ``argwhere``, ``masked_select``, ``unique``,
  ``unique_consecutive``, ``bincount`` without ``minlength``, boolean
  indexing by a comparison or a mask expression): PyTorch must read the
  count back before it can allocate the result;
* ``host-call``: numpy, ``random`` or ``time`` applied to a tensor;
* ``step-print``: ``print`` in a step region, the counterpart of the JAX
  package's ``jit-host-callback``; ``# analysis: obs`` on a ``def`` is
  the deliberate debugging escape and silences only this rule;
* ``step-collective``: a ``torch.distributed`` call in a step region
  other than the all-gather into a tensor (and the group's size and
  rank, host values): object collectives pickle through the host, and a
  barrier, a send / receive or a broadcast of objects wait on it.  The
  page split's all-gather (``kernels.collective``) is a device collective
  on NCCL, which reads nothing back and which a capture takes; on the CPU
  (``gloo``) the whole runner is host code anyway.  A process group
  (a parameter named ``group`` or ``page_group``) is host structure, as
  ``spec`` is.

Capture rules
-------------
On a CUDA device the simulator's runner captures its steps as CUDA
graphs and replays them (``sim._Replays``).  A capture records what the
step launches and refuses what it cannot replay: a copy from pageable
host memory, and any read back.  A warm-up run of each step before its
capture makes what is made once (a cached device constant, a kernel
library's set-up) with the same arguments the capture passes.  So in a
step region:

* ``capture-host-copy``: ``torch.tensor(...)``, ``torch.as_tensor`` /
  ``torch.from_numpy`` of host data, or ``.to(device)`` / ``.cuda()`` of
  host data (a receiver the taint model calls static): a host-to-device
  copy at every replay-less call, refused under capture.  The body of a
  ``functools.lru_cache``d factory is exempt: it runs once, in the
  warm-up;
* ``capture-first-use``: a call of such a factory (one defined in the
  same file) with an argument that carries step data: its cache key
  differs call by call, so no warm-up makes the entry the capture asks
  for;
* ``capture-host-read``: ``.tolist()`` of anything (of step data it is
  also a ``sync-coercion``; of a constant tensor on the card it is still
  a read back).

Taint model
-----------
Verbatim from the JAX package: function parameters are the roots, minus
statics (``self``, ``cls``, ``spec``, int/bool/str-annotated or
-defaulted parameters, and in kernel wrappers the keyword-only ones).
Attribute reads of ``.spec`` / ``.refresh`` / the policies' static knobs
cut taint, as do the metadata attributes (``.shape``, ``.dtype``,
``.ndim``, ``.device``, ...) and methods (``.dim()``, ``.size()``,
``.numel()``, ``.is_floating_point()``, ...).  Assignments propagate
taint; Python list / tuple / dict literals and comprehensions are
containers, so iterating a list of tensors is fine and iterating a
tensor is not.

Deprecated surfaces (checked everywhere in ``src/repro_torch``)
-----------------------------------------------------------------
As in the JAX package: ``static_policy=`` (the registry's
``policies=(name,)`` replaced it), integer policy ids at call sites
(names are the API), and ``time_passed`` (renamed ``slices_done``).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

__all__ = ["lint_paths", "lint_source", "repo_src_root", "RULES"]

# ----------------------------------------------------------------- config --

#: the rule ids this pass emits (the deprecated-surface rules and the
#: pragma rule are the JAX package's, verbatim)
RULES = (
    "sync-coercion", "sync-control-flow", "sync-dynamic-shape",
    "host-call", "step-print", "step-collective", "capture-host-copy",
    "capture-first-use",
    "capture-host-read", "unknown-analysis-pragma",
    "deprecated-static-policy", "deprecated-int-policy-id",
    "deprecated-time-passed",
)
#: parameters that are always static in step regions (a process group
#: is host structure)
STATIC_PARAM_NAMES = {"self", "cls", "spec", "group", "page_group"}
#: the ``torch.distributed`` calls a step region may make: the page
#: split's device all-gather and the group's geometry
STEP_COLLECTIVES = {"all_gather_into_tensor", "get_world_size", "get_rank"}
#: attribute reads that cut taint: static workload geometry / flags —
#: ``.spec`` (SimSpec, static by construction), ``.refresh`` (the static
#: slice-boundary flag), ``.cooperative`` / ``.fifo_tie`` / ``.name``
#: (static ArrayPolicy class knobs), ``.needs_input_grad`` (autograd's
#: tuple of Python bools)
STATIC_CHAIN_ATTRS = {"spec", "refresh", "cooperative", "fifo_tie", "name",
                      "needs_input_grad"}
#: ... and tensor metadata, which lives on the host
STATIC_META_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda",
                     "layout", "requires_grad", "is_floating_point",
                     "T"}
#: tensor methods that read metadata only (no device access)
STATIC_METHODS = {"dim", "size", "numel", "nelement", "stride",
                  "is_contiguous", "is_floating_point", "is_complex",
                  "data_ptr", "element_size", "get_device", "storage_offset",
                  "untyped_storage"}
#: host modules that must not be applied to a tensor in a step region
#: (attribute constants like ``np.inf`` and calls on Python numbers are
#: fine: they touch no device)
HOST_MODULES = {"np", "numpy", "random", "time", "_time"}
#: Python builtins that read a tensor back to the host
COERCIONS = {"float", "int", "bool"}
MATERIALIZERS = {"item", "tolist", "cpu", "numpy"}
#: operators whose output shape depends on the data
DYNAMIC_SHAPE_OPS = {"nonzero", "argwhere", "masked_select", "unique",
                     "unique_consecutive", "nonzero_static"}
#: calls whose result is static structure inspection, not data
#: (``wants_grad``: grad mode and ``requires_grad``, both host flags;
#: ``takes_card_route``: the tensor's device type)
STATIC_INSPECTORS = {"isinstance", "hasattr", "len", "callable", "getattr",
                     "is_tensor", "wants_grad", "takes_card_route"}

#: pragma grammar: the ``analysis:`` comment marker, a name, optional
#: trailing prose.  The name is matched exactly (word chars and ``=``,
#: so ``oracle=<name>`` is one token and surrounding backticks in prose
#: terminate it) — a typo'd name is a finding, not a silent no-op.
_PRAGMA_RE = re.compile(r"#\s*analysis:\s*([A-Za-z_][\w=]*)")
#: the full pragma vocabulary across the analysis package: lint's
#: region pragmas plus the kernel verifier's (``revisit`` sanctions an
#: output-block revisit in absint, ``oracle=<name>`` declares a ref.py
#: pairing in kernels)
PRAGMA_NAMES = {"host", "traced", "obs", "revisit"}
_PRAGMA_PREFIXES = ("oracle=",)


def repo_src_root() -> Path:
    """The ``src/repro_torch`` package directory this module shipped in."""
    return Path(__file__).resolve().parent.parent


# ------------------------------------------------------- file classifiers --

def _norm(rel: str) -> str:
    return rel.replace("\\", "/")


def _file_kind(rel: str) -> str:
    """"kernels" | "traced" | "sim" | "host" for a repo-relative path."""
    rel = _norm(rel)
    if rel.endswith(("kernels/_build.py", "kernels/cases.py")):
        return "host"
    if "/kernels/" in rel or rel.startswith("kernels/"):
        return "kernels"
    if rel.endswith(("core/array_sim/policies.py", "core/array_sim/coop.py",
                     "obs/counters.py")):
        return "traced"
    if rel.endswith("core/array_sim/sim.py"):
        return "sim"
    return "host"


def _pragma(src_lines: Sequence[str], node: ast.AST) -> Optional[str]:
    """The ``# analysis:`` pragma on the def line or the line above.

    Returns the pragma name only when it is one of lint's region pragmas
    (``host`` / ``traced`` / ``obs``) — a kernel-verifier pragma on the
    same def (``revisit``, ``oracle=``) is someone else's and must not
    leak a region classification here."""
    for ln in (node.lineno - 1, node.lineno - 2):
        if 0 <= ln < len(src_lines):
            m = _PRAGMA_RE.search(src_lines[ln])
            if m and m.group(1) in ("host", "traced", "obs"):
                return m.group(1)
    return None


def _check_pragmas(source: str, rel: str, findings: List[Finding]) -> None:
    """Rule ``unknown-analysis-pragma``: every ``# analysis:`` comment
    must name a known pragma.  Scanned over COMMENT tokens (docstring
    *mentions* of the spelling are strings and never match), so a typo'd
    opt-out — ``# analysis: hosted`` — fails the gate instead of
    silently opting nothing out."""
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return  # the ast pass already reported the syntax error
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            continue
        name = m.group(1)
        if name in PRAGMA_NAMES or name.startswith(_PRAGMA_PREFIXES):
            continue
        findings.append(Finding(
            rule="unknown-analysis-pragma", path=rel, line=tok.start[0],
            col=tok.start[1],
            message=f"unknown `# analysis: {name}` pragma — known names: "
                    f"{sorted(PRAGMA_NAMES)} plus `oracle=<name>`; a typo "
                    "here silently opts nothing out",
        ))


# ----------------------------------------------------------- taint engine --

class _Scope:
    """Name -> (tainted, container) for one traced function body."""

    def __init__(self, parent: Optional["_Scope"] = None):
        self.tainted: Dict[str, bool] = dict(parent.tainted) if parent else {}
        self.container: Set[str] = set(parent.container) if parent else set()

    def set(self, name: str, tainted: bool, container: bool = False) -> None:
        self.tainted[name] = tainted
        if container:
            self.container.add(name)
        else:
            self.container.discard(name)

    def is_tainted(self, name: str) -> bool:
        return self.tainted.get(name, False)

    def is_container(self, name: str) -> bool:
        return name in self.container


def _static_params(fn: ast.FunctionDef, kind: str) -> Set[str]:
    """Parameter names treated as static (trace-time constants)."""
    static: Set[str] = set()
    args = fn.args
    pos = list(args.posonlyargs) + list(args.args)
    defaults = list(args.defaults)
    # align defaults with the tail of the positional params
    pad = [None] * (len(pos) - len(defaults))
    for a, d in zip(pos, pad + defaults):
        if a.arg in STATIC_PARAM_NAMES:
            static.add(a.arg)
        elif _static_annotation(a.annotation):
            static.add(a.arg)
        elif _static_default(d):
            static.add(a.arg)
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        if (
            kind == "kernels"          # wrapper idiom: kwonly = static knobs
            or a.arg in STATIC_PARAM_NAMES
            or _static_annotation(a.annotation)
            or _static_default(d)
        ):
            static.add(a.arg)
    return static


def _static_annotation(ann: Optional[ast.expr]) -> bool:
    """``int`` / ``bool`` / ``str``, or ``Optional[`` one of them ``]``."""
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id == "Optional":
        ann = ann.slice
    return isinstance(ann, ast.Name) and ann.id in ("int", "bool", "str")


def _static_default(d: Optional[ast.expr]) -> bool:
    """An int / bool / str constant, or a ``torch.<name>`` constant (a
    dtype, such as ``torch.float32``)."""
    if isinstance(d, ast.Attribute) and isinstance(d.value, ast.Name) \
            and d.value.id == "torch":
        return True
    return (
        isinstance(d, ast.Constant)
        and d.value is not None
        and isinstance(d.value, (int, bool, str))
        and not isinstance(d.value, float)
    )


def _is_host_module_call(func: ast.expr) -> Optional[str]:
    """Dotted-call root if it is a host module (``np.median`` -> "np")."""
    node = func
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name) and node.id in HOST_MODULES:
        return node.id
    return None


class _TracedChecker(ast.NodeVisitor):
    """Walks ONE traced function body, tracking taint per name."""

    def __init__(self, rel: str, kind: str, findings: List[Finding],
                 scope: _Scope, src_lines: Sequence[str] = (),
                 allow_callbacks: bool = False,
                 cached: frozenset = frozenset(), in_cached: bool = False):
        self.rel = rel
        self.kind = kind
        self.findings = findings
        self.scope = scope
        self.src_lines = src_lines
        self.allow_callbacks = allow_callbacks
        #: the file's lru_cached factories; whether this is one's body
        self.cached = cached
        self.in_cached = in_cached
        self._tested: Set[int] = set()
        #: names bound to a ``torch.is_tensor(x)`` test -> ``x``
        self.guards: Dict[str, str] = {}

    # ------------------------------------------------------------ helpers --
    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.rel, line=node.lineno,
            col=node.col_offset, message=message,
        ))

    def tainted(self, node: Optional[ast.expr]) -> bool:
        """Does this expression carry traced data?"""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return self.scope.is_tainted(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_CHAIN_ATTRS or node.attr in STATIC_META_ATTRS:
                return False
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value) or self.tainted(node.slice)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and (
                    f.attr in STATIC_METHODS or f.attr in STATIC_INSPECTORS):
                return False
            if isinstance(f, ast.Name) and f.id in STATIC_INSPECTORS:
                return False
            return (
                self.tainted(node.func)
                or any(self.tainted(a) for a in node.args)
                or any(self.tainted(k.value) for k in node.keywords)
            )
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, ast.IfExp):
            name = self._not_tensor(node.test)
            if name is not None:
                saved = self.scope.is_tainted(name)
                self.scope.set(name, False)
                other = self.tainted(node.orelse)
                self.scope.set(name, saved)
                return self.tainted(node.body) or other
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return any(self.tainted(g.iter) for g in node.generators) \
                or self.tainted(node.elt)
        if isinstance(node, ast.DictComp):
            return any(self.tainted(g.iter) for g in node.generators) \
                or self.tainted(node.key) or self.tainted(node.value)
        return any(self.tainted(c) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    def container(self, node: Optional[ast.expr]) -> bool:
        """Is this expression a *Python* container (list/tuple/dict), so
        that iterating it is host-side structure, not a traced array?"""
        if isinstance(node, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                             ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            return True
        if isinstance(node, ast.Name):
            return self.scope.is_container(node.id)
        if isinstance(node, ast.IfExp):
            return self.container(node.body) or self.container(node.orelse)
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in (
                    "list", "tuple", "dict", "zip", "enumerate", "range",
                    "sorted", "reversed", "map", "filter"):
                return True
        return False

    def _dynamic_test(self, test: ast.expr) -> bool:
        """Does a branch test depend on traced data?  ``is``/``is not``
        comparisons are static structure checks (the ``x is None``
        idiom) and never count; ``any()``/``all()`` over a Python
        container of traced leaves count only if their element test
        does."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._dynamic_test(test.operand)
        if isinstance(test, ast.BoolOp):
            return any(self._dynamic_test(v) for v in test.values)
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return False
        if isinstance(test, ast.Call):
            f = test.func
            if isinstance(f, ast.Name):
                if f.id in STATIC_INSPECTORS:
                    return False
                if f.id in ("any", "all") and len(test.args) == 1:
                    arg = test.args[0]
                    if isinstance(arg, ast.GeneratorExp):
                        # iterating a traced array is dynamic regardless
                        for g in arg.generators:
                            if self.tainted(g.iter) \
                                    and not self.container(g.iter):
                                return True
                        return self._dynamic_test(arg.elt)
        return self.tainted(test)

    def _bind_target(self, target: ast.expr, tainted: bool,
                     container: bool) -> None:
        if isinstance(target, ast.Name):
            self.scope.set(target.id, tainted, container)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, tainted, container=True)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, tainted, container=False)
        # attribute/subscript targets: no name to bind

    # --------------------------------------------------------- statements --
    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)        # rule sites inside the value first
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            about = self._not_tensor(node.value)
            if about is not None:
                self.guards[node.targets[0].id] = about
        t = self.tainted(node.value)
        c = self.container(node.value)
        for target in node.targets:
            if (isinstance(target, (ast.Tuple, ast.List))
                    and isinstance(node.value, (ast.Tuple, ast.List))
                    and len(target.elts) == len(node.value.elts)):
                for el, val in zip(target.elts, node.value.elts):
                    self._bind_target(el, self.tainted(val),
                                      self.container(val))
            else:
                self._bind_target(target, t, c)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._bind_target(node.target, self.tainted(node.value),
                              self.container(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if isinstance(node.target, ast.Name):
            t = (self.scope.is_tainted(node.target.id)
                 or self.tainted(node.value))
            self.scope.set(node.target.id, t,
                           self.scope.is_container(node.target.id))

    def _truth(self, node: ast.AST, test: ast.expr, what: str) -> None:
        """Rule ``sync-control-flow`` for a truth test on a tensor."""
        self._tested.add(id(test))
        if self._dynamic_test(test):
            self._emit(
                "sync-control-flow", node,
                f"Python {what} on a tensor inside a step region (reads it "
                "back to the host and drains the launch queue: use "
                "torch.where / a per-lane mask; static closure flags such "
                "as `refresh` MAY branch)",
            )

    def _not_tensor(self, test: ast.expr) -> Optional[str]:
        """The name a ``torch.is_tensor(name)`` test (or a name bound to
        one) is about: in the branch where it is False, ``name`` is a
        Python value and cannot sync."""
        if isinstance(test, ast.Name):
            return self.guards.get(test.id)
        if isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
                and test.func.attr == "is_tensor" and len(test.args) == 1 \
                and isinstance(test.args[0], ast.Name):
            return test.args[0].id
        return None

    def _visit_untainted(self, name: str, nodes) -> None:
        saved = self.scope.is_tainted(name), self.scope.is_container(name)
        self.scope.set(name, False)
        for n in nodes:
            self.visit(n)
        self.scope.set(name, saved[0], saved[1])

    def visit_If(self, node: ast.If) -> None:
        self._truth(node, node.test, "`if`")
        name = self._not_tensor(node.test)
        if name is None:
            self.generic_visit(node)
            return
        self.visit(node.test)
        for stmt in node.body:
            self.visit(stmt)
        self._visit_untainted(name, node.orelse)

    def visit_While(self, node: ast.While) -> None:
        self._truth(node, node.test, "`while`")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._truth(node, node.test, "`assert`")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._truth(node, node.test, "conditional expression")
        name = self._not_tensor(node.test)
        if name is None:
            self.generic_visit(node)
            return
        self.visit(node.test)
        self.visit(node.body)
        self._visit_untainted(name, [node.orelse])

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        if id(node) not in self._tested:
            self._truth(node, node, "`and` / `or`")
        self._tested.update(id(v) for v in node.values)
        self.generic_visit(node)

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if isinstance(node.op, ast.Not) and id(node) not in self._tested:
            self._truth(node, node, "`not`")
        if isinstance(node.op, ast.Not):
            self._tested.add(id(node.operand))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        sl = node.slice
        mask = (isinstance(sl, ast.Compare)
                and not all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in sl.ops)) \
            or (isinstance(sl, ast.UnaryOp) and isinstance(sl.op, ast.Invert))
        if mask and self.tainted(sl):
            self._emit(
                "sync-dynamic-shape", node,
                "boolean indexing by a tensor mask inside a step region "
                "(the result's length is read back from the device: use "
                "torch.where, or a fixed-size compaction)",
            )
        self.generic_visit(node)

    def _check_loop_iter(self, node: ast.AST, it: ast.expr) -> None:
        bare = isinstance(it, (ast.Name, ast.Attribute, ast.Subscript))
        if bare and self.tainted(it) and not self.container(it):
            self._emit(
                "sync-control-flow", node,
                "Python `for` over a tensor inside a step region (each "
                "element is read back to the host: keep the iterable a "
                "static Python sequence)",
            )
        elif isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range" \
                and any(self.tainted(a) for a in it.args):
            self._emit(
                "sync-control-flow", node,
                "`range()` over a tensor length inside a step region "
                "(lengths must be static: shapes, closure ints)",
            )

    def visit_For(self, node: ast.For) -> None:
        self._check_loop_iter(node, node.iter)
        self._bind_target(node.target, self.tainted(node.iter), False)
        self.generic_visit(node)

    def _visit_comp(self, node: ast.AST, results) -> None:
        """A comprehension in its own scope, its generators bound before
        its element is read (``ast`` lists the element first)."""
        outer, self.scope = self.scope, _Scope(self.scope)
        for g in node.generators:
            self.visit(g)
        for r in results:
            self.visit(r)
        self.scope = outer

    def visit_ListComp(self, node: ast.ListComp) -> None:
        self._visit_comp(node, [node.elt])

    visit_SetComp = visit_GeneratorExp = visit_ListComp

    def visit_DictComp(self, node: ast.DictComp) -> None:
        self._visit_comp(node, [node.key, node.value])

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._check_loop_iter(node.iter, node.iter)
        self._bind_target(node.target, self.tainted(node.iter), False)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        args_tainted = (any(self.tainted(a) for a in node.args)
                        or any(self.tainted(k.value) for k in node.keywords))
        if isinstance(func, ast.Name) and func.id in COERCIONS:
            if any(self.tainted(a) for a in node.args):
                self._emit(
                    "sync-coercion", node,
                    f"`{func.id}()` of a tensor inside a step region (reads "
                    "it back to the host mid-step: keep it a tensor, or "
                    "derive the number from static geometry)",
                )
        elif isinstance(func, ast.Attribute) and func.attr in MATERIALIZERS:
            if self.tainted(func.value):
                self._emit(
                    "sync-coercion", node,
                    f"`.{func.attr}()` of a tensor inside a step region "
                    "(a device-to-host copy that waits for the queue)",
                )
        if isinstance(func, ast.Attribute) and func.attr in DYNAMIC_SHAPE_OPS \
                and (self.tainted(func.value) or args_tainted):
            self._emit(
                "sync-dynamic-shape", node,
                f"`{func.attr}` inside a step region: its output shape "
                "depends on the data, so the count is read back before "
                "the result can be allocated (use a fixed-size form)",
            )
        if isinstance(func, ast.Attribute) and func.attr == "bincount" \
                and (self.tainted(func.value) or args_tainted) \
                and not any(k.arg == "minlength" for k in node.keywords):
            self._emit(
                "sync-dynamic-shape", node,
                "`bincount` without `minlength` inside a step region (its "
                "length is the data's maximum, read back to the host)",
            )
        root = _is_host_module_call(func)
        if root is not None and args_tainted:
            self._emit(
                "host-call", node,
                f"`{ast.unparse(func)}()` of a tensor inside a step region "
                f"({root} runs on the host: the tensor is copied back and "
                "the queue drained — use torch, or hoist to the builder)",
            )
        if isinstance(func, ast.Name) and func.id == "print" \
                and not self.allow_callbacks:
            self._emit(
                "step-print", node,
                "`print` inside a step region: per-step observability "
                "belongs in the carried counters (repro_torch.obs); mark a "
                "deliberate debugging escape with `# analysis: obs`",
            )
        called = ast.unparse(func)
        if called.startswith(("dist.", "torch.distributed.")) \
                and called.rsplit(".", 1)[1] not in STEP_COLLECTIVES:
            self._emit(
                "step-collective", node,
                f"`{called}()` inside a step region: only the all-gather "
                "into a tensor is a device collective a captured step "
                "takes; this one goes through or waits on the host")
        self._capture_rules(node, func, args_tainted)
        self.generic_visit(node)

    def _capture_rules(self, node: ast.Call, func: ast.expr,
                       args_tainted: bool) -> None:
        """The capture rules (module docstring)."""
        if isinstance(func, ast.Name) and func.id in self.cached \
                and args_tainted:
            self._emit(
                "capture-first-use", node,
                f"`{func.id}()` is an lru_cached factory called with step "
                "data: its key differs call by call, so the warm-up before "
                "a capture never makes the entry the capture asks for (key "
                "it on static geometry, dtypes and devices)")
        if isinstance(func, ast.Attribute) and func.attr == "tolist" \
                and not self.tainted(func.value):
            self._emit(
                "capture-host-read", node,
                "`.tolist()` inside a step region (a read back, which a "
                "captured step cannot make: keep the values a tensor, or "
                "hoist them to the builder)")
        if self.in_cached:
            return
        name = ast.unparse(func)
        host = False
        if name == "torch.tensor":
            host = True
        elif name in ("torch.as_tensor", "torch.asarray",
                      "torch.from_numpy"):
            host = bool(node.args) and not self.tainted(node.args[0])
        elif isinstance(func, ast.Attribute) and func.attr in ("to", "cuda") \
                and not self.tainted(func.value):
            host = func.attr == "cuda" or _names_device(node)
        if host:
            self._emit(
                "capture-host-copy", node,
                f"`{name}()` of host data inside a step region (a copy "
                "from pageable host memory at every call, which a captured "
                "step refuses: make it once in the builder, or in an "
                "lru_cached factory keyed on static values)")

    # nested defs inherit the enclosing taint environment (and may carry
    # their own pragma: `# analysis: obs` scopes the callback escape to
    # exactly one nested def)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        prag = _pragma(self.src_lines, node)
        if prag == "host":
            return
        _check_traced_function(
            node, self.rel, self.kind, self.findings, parent=self.scope,
            src_lines=self.src_lines,
            allow_callbacks=self.allow_callbacks or prag == "obs",
            cached=self.cached,
        )

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        scope = _Scope(self.scope)
        for a in node.args.args + node.args.kwonlyargs:
            scope.set(a.arg, True)
        sub = _TracedChecker(self.rel, self.kind, self.findings, scope,
                             self.src_lines, self.allow_callbacks,
                             self.cached, self.in_cached)
        sub.visit(node.body)


def _names_device(node: ast.Call) -> bool:
    """Whether a ``.to(...)`` call names a device: a ``device=`` keyword,
    or a first argument that is a string, or a name or attribute that
    reads as one (``dev``, ``device``, ``x.device``)."""
    if any(k.arg == "device" for k in node.keywords):
        return True
    if not node.args:
        return False
    a = node.args[0]
    if isinstance(a, ast.Constant):
        return isinstance(a.value, str)
    ident = a.id if isinstance(a, ast.Name) else \
        a.attr if isinstance(a, ast.Attribute) else ""
    return ident in ("dev", "device") or ident.endswith(("_dev", "_device"))


def _lru_cached(fn: ast.FunctionDef) -> bool:
    """Whether ``fn`` is decorated with ``functools.lru_cache`` / ``cache``
    (called or bare, dotted or not)."""
    for d in fn.decorator_list:
        target = d.func if isinstance(d, ast.Call) else d
        name = target.attr if isinstance(target, ast.Attribute) else \
            target.id if isinstance(target, ast.Name) else ""
        if name in ("lru_cache", "cache"):
            return True
    return False


def _check_traced_function(fn: ast.FunctionDef, rel: str, kind: str,
                           findings: List[Finding],
                           parent: Optional[_Scope] = None,
                           src_lines: Sequence[str] = (),
                           allow_callbacks: bool = False,
                           cached: frozenset = frozenset()) -> None:
    scope = _Scope(parent)
    static = _static_params(fn, kind)
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        scope.set(a.arg, a.arg not in static)
    if args.vararg is not None:
        scope.set(args.vararg.arg, True, container=True)
    if args.kwarg is not None:
        scope.set(args.kwarg.arg, True, container=True)
    checker = _TracedChecker(rel, kind, findings, scope, src_lines,
                             allow_callbacks, cached,
                             in_cached=_lru_cached(fn))
    for stmt in fn.body:
        checker.visit(stmt)


# --------------------------------------------------- deprecated surfaces --

class _DeprecatedChecker(ast.NodeVisitor):
    """Whole-file rules: resurrected pre-registry / pre-PR-5 surfaces."""

    def __init__(self, rel: str, findings: List[Finding]):
        self.rel = rel
        self.findings = findings

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.rel, line=node.lineno,
            col=node.col_offset, message=message,
        ))

    def visit_Call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg == "static_policy":
                self._emit(
                    "deprecated-static-policy", kw.value,
                    "`static_policy=` was removed; pass "
                    "`policies=(name,)` resolved through "
                    "repro.core.policy_registry",
                )
            elif kw.arg == "policy" and isinstance(kw.value, ast.Constant) \
                    and type(kw.value.value) is int:
                self._emit(
                    "deprecated-int-policy-id", kw.value,
                    "integer policy id at a call site; policy *names* are "
                    "the API — ids are a registry-owned result-JSON "
                    "contract (policy_registry.array_ids)",
                )
            elif kw.arg == "policies" and isinstance(
                    kw.value, (ast.Tuple, ast.List)) and any(
                    isinstance(el, ast.Constant) and type(el.value) is int
                    for el in kw.value.elts):
                self._emit(
                    "deprecated-int-policy-id", kw.value,
                    "integer policy ids in a `policies=` call keyword; "
                    "pass registry names",
                )
            if kw.arg == "time_passed":
                self._emit(
                    "deprecated-time-passed", kw.value,
                    "`time_passed` was renamed `slices_done`",
                )
        self.generic_visit(node)

    def _check_name(self, node: ast.AST, name: str) -> None:
        if name == "time_passed":
            self._emit(
                "deprecated-time-passed", node,
                "`time_passed` was renamed `slices_done` (it "
                "counted slices, never time; the old name must not read)",
            )

    def visit_Name(self, node: ast.Name) -> None:
        self._check_name(node, node.id)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        self._check_name(node, node.attr)
        self.generic_visit(node)

    def visit_arg(self, node: ast.arg) -> None:
        self._check_name(node, node.arg)


# -------------------------------------------------------------- file pass --

#: ``sim.py`` step/runner builders whose *nested* defs are the step
_SIM_BUILDERS = {"make_step", "_runner"}


def _walk_defs(body: Sequence[ast.stmt]):
    """Top-level and class-level defs of a module body (not nested ones —
    those belong to their enclosing traced region)."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield sub


def lint_source(source: str, rel: str) -> List[Finding]:
    """Lint one file's source; ``rel`` is its repo-relative path (used to
    classify traced regions, so virtual paths work for tests)."""
    findings: List[Finding] = []
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as exc:
        findings.append(Finding(
            rule="syntax-error", path=rel, line=exc.lineno or 1,
            message=str(exc.msg),
        ))
        return findings
    src_lines = source.splitlines()
    _check_pragmas(source, rel, findings)
    _DeprecatedChecker(rel, findings).visit(tree)

    kind = _file_kind(rel)
    cached = frozenset(fn.name for fn in _walk_defs(tree.body)
                       if _lru_cached(fn))
    if kind in ("kernels", "traced"):
        for fn in _walk_defs(tree.body):
            prag = _pragma(src_lines, fn)
            if prag != "host":
                _check_traced_function(
                    fn, rel, kind, findings, src_lines=src_lines,
                    allow_callbacks=(prag == "obs"), cached=cached)
    elif kind == "sim":
        for fn in _walk_defs(tree.body):
            prag = _pragma(src_lines, fn)
            if prag == "traced":
                _check_traced_function(fn, rel, kind, findings,
                                       src_lines=src_lines, cached=cached)
            elif fn.name in _SIM_BUILDERS:
                for sub in fn.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        sp = _pragma(src_lines, sub)
                        if sp == "host":
                            continue
                        _check_traced_function(
                            sub, rel, kind, findings, src_lines=src_lines,
                            allow_callbacks=(sp == "obs"), cached=cached)
    return findings


def lint_paths(root=None) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (default: the installed
    ``src/repro_torch`` tree)."""
    root = Path(root) if root is not None else repo_src_root()
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        try:
            rel = str(path.relative_to(root.parent))
        except ValueError:
            rel = str(path)
        findings += lint_source(path.read_text(encoding="utf-8"), rel)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
