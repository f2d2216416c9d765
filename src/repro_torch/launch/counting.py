"""What a step moves and holds, counted from the step itself on the
``meta`` device: the counterpart of the JAX dry run's collective bytes,
``memory.temp_size`` and ``hbm_bytes_accessed`` (``repro.launch.dryrun``
``collective_bytes`` / ``_analyse`` / ``build_cell``).

:class:`StepCounter` is a ``TorchDispatchMode``.  ``launch/dryrun.py``
runs a cell's step once under it and ``FlopCounterMode`` together, so it
sees every operator as the card runs them: every layer, every microbatch,
every recompute of ``remat``, and under autograd the recomputed plain
VJP of B5-B7 (``kernels.autograd``).  B5-B7 themselves are one operator
each (their stand-ins of ``kernels.accounting``), never their plain
versions; each runs every head on its own, so its output keeps its
first input's marks but on the feature dim (q's heads, x's), and an
input sharded over its feature dim (B and C over the state, a head dim
split because the heads are fewer than the ways) is all-gathered first.
No loop body is counted once, so there is nothing to scale by
a trip count and no reduced-depth probe (the JAX record's ``probes`` and
``scan_trip_counts``): the counts are of the whole step
(``COUNTED = "whole_step"``).  The same step on real CPU tensors gives the
same counts (the test holds them equal).

**Collective bytes per card, by kind, for each mesh** (a
``launch.mesh.MeshShape`` with its ``mesh_rules`` and leaf specs: a
:class:`MeshPlan`).  As the JAX dry run, each collective is counted by
the bytes of its result on one card.  The plan counted is the one the
JAX package's specs describe: activations are sharded over the rules'
``batch`` axes on their leading dimension; a parameter or cache leaf is
sharded as its spec says, and of its spec's axes, those that carry the
batch ("data", "pod": FSDP) are gathered where the leaf is used and the
others ("model": tensor, expert and sequence parallelism) are kept.  A
dimension sharded over kept axes is *marked*; marks travel through
elementwise operators and copies (aligned from the right), a product's
uncontracted dimensions, and views: to the view's dim of the same size
and stride; split by a reshape, to the part the ways divide (q / k / v
into heads); merged by a reshape with the dims beside it, to the merged
dim, whose mark then names its layout (``("data", 4, "model")``: rows
over the batch, four whole, then heads over "model"; an einsum's batch
dims merged for ``bmm``), so a split back restores it.  A view that cuts
a marked dim (a slice, a chunk: the fused projections' pieces) reshards
what it keeps, a collective-permute of its shard (it stays marked) when
the ways divide its length and an all-gather otherwise; a view that
reshapes a marked dim any other way (a split the ways do not divide, a
select along it) all-gathers it.

1. *FSDP gather*: each operator that reads a parameter leaf (or a view of
   one) whose spec names a batch axis records an all-gather of what it
   reads, divided by the ways of the kept axes it still holds; forward
   and backward uses, recomputes, each microbatch and each call site of a
   shared block count as they happen.  After :func:`shardctx.sync_grads`
   the optimizer updates each card's shard: no gather.
2. *Partial products*: an ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` whose
   contracted dimension is marked leaves partial sums: an all-reduce of
   its output (Megatron's row-parallel products in the forward, the
   column-parallel ones' input gradient in the backward, the vocab-sharded
   head's backward, the decode attention's probabilities times a
   ``kv_seq``-sharded cache).  Where the contracted dim's axes also shard
   the other operand's kept dim, or rows and columns share an axis, the
   operand (the smaller) is all-gathered along it first and the product
   is whole (the SSD's B and C, sharded over the state, against a state
   sharded over heads); where one operand's contracted dim is sharded and
   the other's is whole, the cheaper of gathering it and all-reducing the
   output (K sharded over its head dim against a whole Q).
3. *Reductions over a marked dimension*: ``sum``, ``amax`` and the like
   all-reduce their output, ``logsumexp`` twice (its maximum and its
   sum); ``softmax`` / ``log_softmax``
   all-reduce their two row statistics in f32 (the maximum and the sum),
   their backward one (the row sum); ``gather`` / ``index_select`` along a
   marked dimension and an ``embedding`` lookup in a table whose rows are
   marked (``embedding``, or ``index`` with the rows' indices) all-reduce
   their output (each card adds its rows, zeros elsewhere).  This is what the ``vocab`` rule (over "model") implies for
   the logits and the loss, and what ``kv_seq`` over "model" (``decode``)
   or over ("data", "model") (``decode_long``) implies for the attention
   over the cache.
4. Any other operator keeps a marked dimension it leaves whole (the same
   size in its output, not its ``dim`` argument; one index on past the
   dim a stack or a select's backward inserts); a concatenation along it
   keeps it marked and moves each marked input's shard to its place (a
   collective-permute of that shard: the backward of a view's cut), or
   all-gathers them when the ways do not divide the result; one that
   needs it whole (a sort or top-k along it, any other change of rank)
   gathers that input first: an all-gather.
5. The resharding points the models mark (``models.shardctx``):
   ``constrain_batch`` all-gathers an activation that reaches it still
   marked; ``constrain_experts`` is an all-to-all of the ``(B, E, cap, d)``
   buffer over the expert axis (its bytes on one card), forward and
   backward.
6. ``sync_grads``, once a step: each gradient reduce-scatters over the
   batch axes its leaf's spec names and all-reduces over those it does not
   name; both results are the gradient's shard.

Not counted: the scalar reductions over the batch (the loss's and the MoE
aux loss's means, the global gradient norm: a few bytes a step), and any
collective over axes of size one (a (1, 1) mesh counts zero everywhere).
XLA may choose otherwise where an activation is smaller than a weight
(it then gathers the activation): ``tests/test_torch_dryrun_xla.py``
holds these counts against XLA's and ``PERF.md`` names the differences.

**Activations.**  Each storage the step allocates is live from the
operator that makes it until the last tensor on it dies (a weak
finalizer on the storage, so autograd's saved tensors and
``torch.utils.checkpoint``'s count while they are held).  Views share
their base's bytes and in-place operators allocate nothing (AdamW; the
``add_`` of the microbatch accumulation); a B5-B7 stand-in allocates its
output.  ``activations_peak`` is the most live at once beyond the tensors
that exist before the step (params, optimizer state, cache, inputs); the
step's gradients are among what it allocates.  Per card, the counterpart
of JAX's ``temp_size`` is the peak of the same live set with each
storage taken at its share on one card (over the batch axes' ways on its
leading dim when they divide it, and over its marked dims' ways), plus
the largest single all-gather result (the widest gathered weight, a
buffer the meta run never makes): an estimate, since a tensor whose
leading dim is not the batch (a weight's gradient) is divided the same
way.

**Bytes accessed.**  Every operator reads each tensor argument once and
writes its output once; views move nothing, ``empty`` allocates without
writing and the ``*_like`` factories read no data.  B5-B7 count
``accounting.work``'s bytes.  This is eager PyTorch's traffic, what the
card runs: the counterpart of JAX's ``hbm_bytes_accessed``, which counts
XLA's fused program instead.
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import accounting
from ..models.layers import mesh_sizes, tree_paths

__all__ = ["COUNTED", "KINDS", "MeshPlan", "StepCounter"]

#: the collective kinds of the JAX dry run, in its order
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: what the counts cover
COUNTED = "whole_step"

aten = torch.ops.aten
_MATMULS = {aten.mm: (0, 1), aten.bmm: (0, 1), aten.addmm: (1, 2),
            aten.baddbmm: (1, 2)}
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.logsumexp,
               aten.prod, aten.var, aten.std, aten.argmax, aten.argmin,
               aten.linalg_vector_norm, aten.max, aten.min, aten.any,
               aten.all, aten.var_mean, aten.nansum}
_SOFTMAX = {aten._softmax, aten._log_softmax}
_SOFTMAX_BACKWARD = {aten._softmax_backward_data,
                     aten._log_softmax_backward_data}
#: factories that read only their argument's shape
_META_ONLY = {aten.empty_like, aten.zeros_like, aten.ones_like,
              aten.full_like, aten.new_empty, aten.new_zeros, aten.new_ones,
              aten.new_full, aten.new_empty_strided, aten.rand_like,
              aten.randn_like}
_NO_WRITE = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided}

Marks = Dict[int, Tuple[str, ...]]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _dims(dim, ndim: int) -> Tuple[int, ...]:
    """A reduction's ``dim`` argument as non-negative ints (all dims when
    it is ``None`` or empty)."""
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return tuple(range(ndim))
    dims = dim if isinstance(dim, (list, tuple)) else (dim,)
    return tuple(d % max(ndim, 1) for d in dims)


def _axis(item: str, sizes: Dict[str, int]) -> Tuple[str, int, int]:
    """An axis item as ``(axis, ways, outer)``: a mesh axis, or a part of
    one, ``"model/8@1"``, its outer 8 ways (``outer``: the ways of the
    axis outside the part), which a split deals to one dim and the rest,
    ``"model/2@8"``, to the next."""
    if "/" not in item:
        return item, sizes.get(item, 1), 1
    name, rest = item.split("/")
    ways, outer = rest.split("@")
    return name, int(ways), int(outer)


def _ways(item, sizes: Dict[str, int]) -> int:
    """The ways an item of a mark shards its dim: 1 for a whole factor."""
    return 1 if isinstance(item, int) else _axis(item, sizes)[1]


def _layout(size: int, ax: Tuple, sizes: Dict[str, int]) -> List[Tuple]:
    """A dim's layout, outermost first: ``(item, factor)`` pairs, an axis
    (or a part of one) for a sharded factor, an int for one held whole;
    what is left inside them is held whole too."""
    out = [(a, a if isinstance(a, int) else _ways(a, sizes)) for a in ax]
    rest = size // max(math.prod(f for _, f in out), 1)
    return out + [(rest, rest)] if rest > 1 else out


def _mark(items, sizes: Dict[str, int]) -> Tuple:
    """A layout as a mark: its items less the whole factors inside the
    last axis (a block shard of what stays), the parts of an axis that
    follow one another joined; ``()`` with no axis."""
    out: List = []
    for a, _ in items:
        if out and isinstance(a, str) and isinstance(out[-1], str):
            n0, w0, o0 = _axis(out[-1], sizes)
            n1, w1, o1 = _axis(a, sizes)
            if n0 == n1 and o1 == o0 * w0:
                w, o = w0 * w1, o0
                out[-1] = n0 if (w, o) == (sizes.get(n0), 1) else \
                    f"{n0}/{w}@{o}"
                continue
        out.append(a)
    while out and isinstance(out[-1], int):
        out.pop()
    return tuple(out)


def _follow(src: torch.Tensor, d: int, o: torch.Tensor, marks: Marks,
            sizes: Dict[str, int], batch: Tuple[str, ...] = ()
            ) -> Optional[Marks]:
    """Where ``o`` (a view of ``src``'s storage) holds ``src``'s marked
    dim ``d``, or ``None`` when it does not as it is: the dim of its size
    and stride; split by a reshape (a run of ``o``'s dims, contiguous, the
    innermost of ``d``'s stride, whose sizes multiply to its size), its
    layout dealt to the run's parts from the outermost, a whole factor
    across parts, an axis within one; merged by a reshape with dims beside
    it, the merged dim, its layout theirs in order (``batch``: the axes of
    ``src``'s leading dim when it is sharded over the batch).  A mark with
    an int before an axis (a marked dim merged inside another) is not a
    block shard; it says which factor is sharded, so a split restores it
    and ``per_card`` divides by its axes' ways alone."""
    n, s = src.shape[d], src.stride(d)
    if n < 2:
        return {}
    big = [j for j in range(o.dim()) if o.shape[j] > 1]
    for j in big:
        if o.shape[j] == n and o.stride(j) == s:
            return {j: marks[d]}
    for i, k in enumerate(big):                 # split
        if o.stride(k) != s or n % o.shape[k]:
            continue
        run = [k]
        prod = o.shape[k]
        while prod < n and i > 0 and \
                o.stride(big[i - 1]) == o.stride(run[0]) * o.shape[run[0]]:
            i -= 1
            run.insert(0, big[i])
            prod *= o.shape[big[i]]
        if prod != n:
            return None
        parts: List[List[Tuple]] = [[] for _ in run]
        part, cap = 0, o.shape[run[0]]
        for item, f in _layout(n, marks[d], sizes):
            while f > 1:
                if part == len(run):
                    return None
                if cap % f == 0:
                    parts[part].append((item, f))
                    cap, f = cap // f, 1
                elif f % cap == 0:          # across parts: its outer ways
                    if isinstance(item, int):
                        parts[part].append((cap, cap))
                        item = f // cap
                    else:
                        name, _, outer = _axis(item, sizes)
                        parts[part].append((f"{name}/{cap}@{outer}", cap))
                        item = f"{name}/{f // cap}@{outer * cap}"
                    f, cap = f // cap, 1
                else:
                    return None
                if cap == 1 and part + 1 < len(run):
                    part, cap = part + 1, o.shape[run[part + 1]]
        marked = {j: _mark(p, sizes) for j, p in zip(run, parts)}
        return {j: mk for j, mk in marked.items() if mk}
    contiguous = [q for q in range(src.dim()) if src.shape[q] > 1]
    at = contiguous.index(d)                    # merge
    for lo in range(at, -1, -1):
        if lo < at and src.stride(contiguous[lo]) != \
                src.stride(contiguous[lo + 1]) * src.shape[contiguous[lo + 1]]:
            break
        for hi in range(at, len(contiguous)):
            if hi > at and src.stride(contiguous[hi - 1]) != \
                    src.stride(contiguous[hi]) * src.shape[contiguous[hi]]:
                break
            group = contiguous[lo:hi + 1]
            if len(group) < 2:
                continue
            size, stride = math.prod(src.shape[q] for q in group), \
                src.stride(group[-1])
            j = next((j for j in big if o.shape[j] == size
                      and o.stride(j) == stride), None)
            if j is None:
                continue
            items: List[Tuple] = []
            for q in group:
                ax = marks.get(q) or (batch if q == 0 else ())
                items += _layout(src.shape[q], ax, sizes)
            return {j: _mark(items, sizes)}
    return None


class MeshPlan:
    """One mesh as the counter reads it: axis sizes, the rules' batch
    axes and each sharded leaf's spec, by storage."""

    def __init__(self, name: str, mesh, rules: Dict[str, Any],
                 params: Tuple[Any, Any], cache: Optional[Tuple[Any, Any]]
                 = None):
        self.name = name
        self.sizes = mesh_sizes(mesh)
        self.batch = tuple(a for a in _axes(rules["batch"])
                           if self.sizes.get(a, 1) > 1)
        self.batch_ways = math.prod(self.sizes[a] for a in self.batch)
        self.experts = tuple(a for a in _axes(rules.get("experts", "model"))
                             if self.sizes.get(a, 1) > 1)
        #: storage key -> (leaf, per-dim kept axes, FSDP axes); a cache's
        #: batch axes shard its batch dim, as an activation's: no FSDP
        self.leaves: Dict[int, Tuple[torch.Tensor, Tuple, Tuple]] = {}
        for pair, gathered in ((params, True), (cache, False)):
            if pair is None:
                continue
            tree, specs = pair[0], tree_paths(pair[1])
            for path, leaf in tree_paths(tree).items():
                spec = specs.get(path, ()) or ()
                kept, fsdp = [], []
                for entry in spec:
                    ax = tuple(a for a in _axes(entry)
                               if self.sizes.get(a, 1) > 1)
                    kept.append(tuple(a for a in ax if a not in self.batch))
                    fsdp.extend(a for a in ax if a in self.batch)
                kept += [()] * (leaf.dim() - len(kept))
                self.leaves[_key(leaf)] = (leaf, tuple(kept),
                                           tuple(fsdp) if gathered else ())
        self.bytes = {k: 0.0 for k in KINDS}
        self.largest_gather = 0.0
        #: the live set on one card: storage key -> bytes, their sum, peak
        self.live_keys: Dict[int, float] = {}
        self.live = 0.0
        self.peak = 0.0
        self.marks = WeakIdKeyDictionary()

    def ways(self, axes: Iterable) -> int:
        return math.prod(_ways(a, self.sizes) for a in axes)

    def add(self, kind: str, nbytes: float) -> None:
        self.bytes[kind] += nbytes
        if kind == "all-gather":
            self.largest_gather = max(self.largest_gather, nbytes)

    def leaf_marks(self, t: torch.Tensor, info) -> Marks:
        """The kept axes of ``t``'s dims: a leaf dim's axes carry to the
        dim of ``t`` that holds it (:func:`_follow`)."""
        leaf, kept, _ = info
        out: Marks = {}
        for i, ax in enumerate(kept):
            if not ax or leaf.shape[i] < 2:
                continue
            for j, a in (_follow(leaf, i, t, {i: ax}, self.sizes)
                         or {}).items():
                out.setdefault(j, a)
        return out

    def marks_of(self, t: torch.Tensor) -> Marks:
        info = self.leaves.get(_key(t))
        if info is not None:
            return self.leaf_marks(t, info)
        return self.marks.get(t, {})

    def per_card(self, t: torch.Tensor, marks: Marks) -> float:
        """``t``'s bytes on one card: over the batch axes on its leading
        dim (when they divide it) and over its marked dims' axes, each
        axis once (decode marks the heads and the cache's ``kv_seq`` both
        over "model", which no mesh holds at once)."""
        n = float(_nbytes(t))
        if t.dim() and self.batch_ways > 1 and \
                t.shape[0] % self.batch_ways == 0 and 0 not in marks:
            n /= self.batch_ways
        return n / self.ways({a for ax in marks.values() for a in ax})

    def totals(self) -> Dict[str, Any]:
        b = {k: (int(v) if float(v).is_integer() else v)
             for k, v in self.bytes.items()}
        return {"collective_bytes": b,
                "collective_total": sum(self.bytes.values()),
                "largest_gather": self.largest_gather,
                "activations": self.peak + self.largest_gather}


class StepCounter(TorchDispatchMode):
    """Counts a step's collectives under each of ``plans``, its live
    activation bytes and its bytes accessed.  ``baseline``: the tensors
    that exist before the step (not activations)."""

    def __init__(self, plans: Sequence[MeshPlan] = (),
                 baseline: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.plans = list(plans)
        self.base = {_key(t) for t in baseline}
        self.live_keys: Dict[int, int] = {}
        self.live = 0
        self.activations_peak = 0
        self.bytes_accessed = 0
        self.phase = "model"

    # ------------------------------------------------------- the hooks --
    def reshard(self, point: str, x: torch.Tensor) -> None:
        for m in self.plans:
            marks = m.marks_of(x)
            if point == "experts":
                if m.experts:
                    m.add("all-to-all",
                          m.per_card(x, {}) / m.ways(m.experts))
                m.marks.pop(x, None)
            elif marks:
                m.add("all-gather", m.per_card(x, {}))
                m.marks.pop(x, None)

    def sync_grads(self, params, grads) -> None:
        for m in self.plans:
            for p, g in zip(params, grads):
                info = m.leaves.get(_key(p))
                if info is None:
                    continue
                _, kept, fsdp = info
                spec = {a for ax in kept for a in ax} | set(fsdp)
                shard = _nbytes(g) / m.ways(spec)
                if any(a in spec for a in m.batch):
                    m.add("reduce-scatter", shard)
                if any(a not in spec for a in m.batch):
                    m.add("all-reduce", shard)
        self.phase = "update"

    # --------------------------------------------------- the live set --
    def _free(self, key: int) -> None:
        self.live -= self.live_keys.pop(key, 0)
        for m in self.plans:
            m.live -= m.live_keys.pop(key, 0.0)

    def _allocated(self, outs: List[torch.Tensor], stand_in: bool) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.base or key in self.live_keys:
                continue
            n = _nbytes(t) if stand_in else st.nbytes()
            self.live_keys[key] = n
            self.live += n
            for m in self.plans:       # the same share of it on one card
                pc = n * m.per_card(t, m.marks_of(t)) / max(_nbytes(t), 1)
                m.live_keys[key] = pc
                m.live += pc
                m.peak = max(m.peak, m.live)
            weakref.finalize(st, self._free, key).atexit = False
        self.activations_peak = max(self.activations_peak, self.live)

    # ------------------------------------------------------ dispatch --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        packet = func.overloadpacket
        in_keys = {_key(t) for t in ins}
        alias = func.is_view or (not func._schema.is_mutable and outs and
                                 all(_key(o) in in_keys for o in outs))
        stand_in = func.namespace == "repro_torch"
        if alias:
            pass
        elif stand_in:
            self.bytes_accessed += accounting.call_work(
                packet.__name__, args, kwargs)[1]
        else:
            read = 0 if packet in _META_ONLY else sum(map(_nbytes, ins))
            written = 0 if packet in _NO_WRITE else sum(map(_nbytes, outs))
            self.bytes_accessed += read + written
        for m in self.plans:
            self._shard(m, func, packet, args, kwargs, ins, outs, alias,
                        stand_in)
        if not alias:
            self._allocated(outs, stand_in)
        return out

    def _shard(self, m: MeshPlan, func, packet, args, kwargs, ins, outs,
               alias: bool, stand_in: bool) -> None:
        if alias:
            src = m.marks_of(ins[0]) if ins else {}
            for o in outs:
                self._carry(m, o, ins[0], src)
            return
        if self.phase == "model" and packet not in _META_ONLY:
            seen = set()
            for t in ins:
                key = _key(t)
                info = m.leaves.get(key)
                if info is None or key in seen or not info[2]:
                    continue
                seen.add(key)
                kept = m.leaf_marks(t, info)
                m.add("all-gather", _nbytes(t) / m.ways(
                    a for ax in kept.values() for a in ax))
        if not outs:
            return
        if stand_in:        # B5-B7: (B, T, heads, features) per head
            for t in ins:
                mk = m.marks_of(t)
                if t.dim() - 1 in mk:       # a feature dim it contracts
                    m.add("all-gather", m.per_card(t, {
                        d: ax for d, ax in mk.items() if d != t.dim() - 1}))
            first, out = m.marks_of(ins[0]), outs[0]
            self._set(m, out, {d: ax for d, ax in first.items()
                               if d < out.dim() - 1
                               and out.shape[d] == ins[0].shape[d]})
            return
        marks = [(t, m.marks_of(t)) for t in ins]
        if not any(mk for _, mk in marks):
            return
        out = outs[0]
        if packet in _MATMULS:
            self._matmul(m, packet, args, out)
        elif packet in _REDUCTIONS and func._overloadname != "other":
            t, mk = marks[0]              # (``max.other``: elementwise)
            names = [a.name for a in func._schema.arguments]
            bound = dict(zip(names, args), **kwargs)
            dims = _dims(bound.get("dim"), t.dim())
            keep = bool(bound.get("keepdim", False))
            rest = {d: ax for d, ax in mk.items() if d not in dims}
            if len(rest) < len(mk):      # logsumexp: the maximum and the sum
                for o in outs:
                    m.add("all-reduce", m.per_card(o, {}) * (
                        2 if packet is aten.logsumexp else 1))
            shifted = {(d if keep else d - sum(1 for r in dims if r < d)): ax
                       for d, ax in rest.items()}
            self._set(m, out, shifted)
        elif packet in _SOFTMAX or packet in _SOFTMAX_BACKWARD:
            t = args[1] if packet in _SOFTMAX_BACKWARD else args[0]
            mk = m.marks_of(t) or m.marks_of(args[0])
            dim = args[2 if packet in _SOFTMAX_BACKWARD else 1] % t.dim()
            if dim in mk:
                stats = (2 if packet in _SOFTMAX else 1) * 4
                rest = {d: ax for d, ax in mk.items() if d != dim}
                m.add("all-reduce", stats * t.numel() / t.shape[dim]
                      * m.per_card(t, rest) / _nbytes(t))
            self._set(m, out, mk)
        elif packet in (aten.gather, aten.index_select):
            t, mk = marks[0]
            dim = args[1] % t.dim()
            if dim in mk:
                m.add("all-reduce", m.per_card(out, {}))
            self._set(m, out, {})
        elif packet is aten.embedding:
            if 0 in m.marks_of(args[0]):
                m.add("all-reduce", m.per_card(out, {}))
        elif packet is aten.index:
            t, mk = marks[0]
            if any(i is not None and d in mk
                   for d, i in enumerate(args[1])):
                m.add("all-reduce", m.per_card(out, {}))
            self._set(m, out, {})
        elif self._elementwise(m, ins, out):
            pass
        else:
            self._along(m, func, args, kwargs, marks, out)

    def _set(self, m: MeshPlan, t: torch.Tensor, marks: Marks) -> None:
        if _key(t) in m.leaves:
            return
        if marks:
            m.marks[t] = marks
        else:
            m.marks.pop(t, None)

    def _carry(self, m: MeshPlan, o: torch.Tensor, src_t: torch.Tensor,
               src: Marks) -> None:
        """A view's marks: each marked dim to where the view holds it
        (:func:`_follow`; the batch axes of the leading dim join a marked
        dim merged into it).  A view that cuts a marked dim (the view's
        dim of its stride is shorter) reshards what it keeps: a
        collective-permute of its shard, still marked, when the ways
        divide the cut, else an all-gather; one that reshapes it any other
        way all-gathers it."""
        batch = m.batch if (src_t.dim() and 0 not in src and m.batch_ways > 1
                            and src_t.shape[0] % m.batch_ways == 0) else ()
        out: Marks = {}
        cut: Marks = {}
        gather = False
        for d, ax in src.items():
            found = _follow(src_t, d, o, src, m.sizes, batch)
            if found is not None:
                for j, a in found.items():
                    out.setdefault(j, a)
                continue
            s = src_t.stride(d)
            j = next((j for j in range(o.dim()) if o.stride(j) == s
                      and 1 < o.shape[j] < src_t.shape[d]), None)
            if (j is not None and o.numel() < src_t.numel()
                    and o.shape[j] % m.ways(ax) == 0):
                cut.setdefault(j, ax)
            else:
                gather = True
        if out.get(0) == m.batch:           # the leading dim's own sharding
            del out[0]
        if gather:
            m.add("all-gather", m.per_card(o, {}))
            out = {}
        elif cut:
            out.update(cut)
            m.add("collective-permute", m.per_card(o, out))
        self._set(m, o, out)

    def _elementwise(self, m: MeshPlan, ins, out) -> bool:
        """An operator whose tensor inputs broadcast to its output: marks
        aligned from the right."""
        merged: Marks = {}
        for t in ins:
            if t.dim() > out.dim():
                return False
            off = out.dim() - t.dim()
            for i, n in enumerate(t.shape):
                if n not in (1, out.shape[off + i]):
                    return False
            for d, ax in m.marks_of(t).items():
                if t.shape[d] == out.shape[off + d]:
                    merged.setdefault(off + d, ax)
        self._set(m, out, merged)
        return True

    def _along(self, m: MeshPlan, func, args, kwargs, marks, out) -> None:
        """Any other operator: a marked dim it keeps whole (same size in
        the output, not its ``dim`` argument; past ``dim`` one index on
        where the output has one more dim there: a stack, a select's
        backward) stays marked; an input it needs along a marked dim is
        all-gathered first."""
        names = [a.name for a in func._schema.arguments]
        dim = dict(zip(names, args), **kwargs).get("dim")
        dims = set(_dims(dim, out.dim())) if isinstance(dim, int) else set()
        if func.overloadpacket is aten.cat:
            self._cat(m, (dim or 0) % out.dim(), marks, out)
            return
        carried: Marks = {}
        for t, mk in marks:
            if not mk:
                continue
            new = t.dim() + 1 == out.dim() and len(dims) == 1
            at = {d: d + (new and d >= min(dims)) for d in mk}
            if (t.dim() == out.dim() or new) and all(
                    at[d] not in dims and t.shape[d] == out.shape[at[d]]
                    for d in mk):
                for d, ax in mk.items():
                    carried.setdefault(at[d], ax)
            else:
                m.add("all-gather", m.per_card(t, {}))
        self._set(m, out, carried)

    def _cat(self, m: MeshPlan, dim: int, marks, out) -> None:
        """A concatenation: the other marked dims carry; along a marked
        dim, each marked input's shard moves to its place in the result's
        (a collective-permute), or is all-gathered when the ways do not
        divide the result's length."""
        carried: Marks = {}
        along = [(t, mk) for t, mk in marks if dim in mk]
        ax = along[0][1][dim] if along else ()
        for t, mk in marks:
            for d, a in mk.items():
                if d != dim and t.dim() == out.dim():
                    carried.setdefault(d, a)
        if along and out.shape[dim] % m.ways(ax) == 0:
            carried[dim] = ax
            for t, mk in along:
                m.add("collective-permute", m.per_card(t, mk))
        else:
            for t, _ in along:
                m.add("all-gather", m.per_card(t, {}))
        self._set(m, out, carried)

    def _matmul(self, m: MeshPlan, packet, args, out) -> None:
        """Rule 2.  An operand whose contracted dim is sharded over an axis
        that also shards the other operand's kept dim, or rows and columns
        sharded over one axis, cannot be multiplied where it lies: it (the
        smaller, for rows and columns) is all-gathered along that dim
        first (the SSD's products of B and C, sharded over their state,
        with a state sharded over its heads)."""
        ia, ib = _MATMULS[packet]
        a, b = args[ia], args[ib]
        ma, mb = dict(m.marks_of(a)), dict(m.marks_of(b))

        def names(mk: Marks, d: int):
            return {_axis(x, m.sizes)[0] for x in mk.get(d, ())
                    if isinstance(x, str)}

        def gather(t: torch.Tensor, mk: Marks, d: int) -> None:
            m.add("all-gather", m.per_card(t, {e: x for e, x in mk.items()
                                               if e != d}))
            del mk[d]

        if names(ma, a.dim() - 1) & names(mb, b.dim() - 1):
            gather(a, ma, a.dim() - 1)
        if names(mb, b.dim() - 2) & names(ma, a.dim() - 2):
            gather(b, mb, b.dim() - 2)
        if names(ma, a.dim() - 2) & names(mb, b.dim() - 1):
            if _nbytes(a) <= _nbytes(b):
                gather(a, ma, a.dim() - 2)
            else:
                gather(b, mb, b.dim() - 1)
        if (a.dim() - 1 in ma) != (b.dim() - 2 in mb):   # one side sharded
            t, mk, d = ((a, ma, a.dim() - 1) if a.dim() - 1 in ma
                        else (b, mb, b.dim() - 2))
            kept = {e: x for e, x in mk.items() if e != d}
            if m.per_card(t, kept) < m.per_card(out, {}):
                gather(t, mk, d)
        marks: Marks = {}
        if packet in (aten.addmm, aten.baddbmm):
            bias = args[0]
            off = out.dim() - bias.dim()
            for d, ax in m.marks_of(bias).items():
                if bias.shape[d] == out.shape[off + d]:
                    marks[off + d] = ax
        batched = a.dim() == 3
        if batched:
            for mk in (ma, mb):
                if 0 in mk:
                    marks[0] = mk[0]
        if a.dim() - 2 in ma:
            marks[out.dim() - 2] = ma[a.dim() - 2]
        if b.dim() - 1 in mb:
            marks[out.dim() - 1] = mb[b.dim() - 1]
        if a.dim() - 1 in ma or b.dim() - 2 in mb:
            m.add("all-reduce", m.per_card(out, {
                d: ax for d, ax in marks.items()
                if d not in (out.dim() - 1, out.dim() - 2)}))
            marks = {d: ax for d, ax in marks.items() if d == 0 and batched}
        self._set(m, out, marks)

    def results(self) -> Dict[str, Any]:
        return {"activations_peak": self.activations_peak,
                "bytes_accessed": self.bytes_accessed, "counted": COUNTED,
                "meshes": {m.name: m.totals() for m in self.plans}}
