"""Wrappers of the three Hopper buffer-pool kernels (``csrc/pbm_timeline.cu``).

Counterparts of the JAX package's ``repro.kernels.pbm_timeline``
(``batched_evict_kernel``, ``fifo_grant_kernel``, ``wake_solve_kernel``),
each over a leading lane axis: one thread block per lane while a lane's
row fits one block (``MAX_SORT_LEN`` pages) and no split is asked for;
else the page-split kernels of the same library, one block per (lane,
page shard) selecting candidates and one block per lane finishing
(``split_shards``, ``splits``), two to four CUDA launches a call.  Given
a ``page_group`` (the ranks of a ``torch.distributed`` page axis, each
holding the replicated rows), B1 and B2 split their rows across the ranks:
each rank selects the candidates of its own ``P / n`` slice, the ranks
all-gather them (:mod:`.collective`) and every rank finishes the same
answer (``split_ranks``).  Every
wrapper
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises when the launch is refused, and adds one to its
``launches`` count where it launches — nowhere else.  The plain PyTorch
versions that define the semantics are in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, collective
from ._build import check_tensor as _check, raise_on as _raise_on
from ._build import call_on as _call_on, stream_of as _stream

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: longest head that the three kernels select and sort alone (``kHeadCap``
#: in ``csrc/pbm_timeline.cu``, checked when it is loaded)
HEAD_CAP = 1024
#: longest row one block sorts (``pbm_max_sort_len``: 16 entries a thread
#: of a full block, checked when the library is loaded)
MAX_SORT_LEN = 16 * 1024
#: dynamic shared memory a Hopper block may opt in to (227 KB), the page
#: split's plan where no card is asked (``splits``, the tests)
HOPPER_SMEM = 227 * 1024
_LIB = None
#: device index -> dynamic shared-memory limits: evict, grant, wake, and
#: the least of the page-split kernels'
_MAX_DYN = {}


# analysis: host -- loads the library and reads the device limits once
def library(device):
    """``(library, shared-memory limits)`` for the CUDA ``device``: built
    and loaded at first use, and the kernels' shared-memory limit raised
    once on every device they are launched on."""
    global _LIB
    if _LIB is None:
        lib = _build.load("pbm_timeline")
        evict_args = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.pbm_batched_evict_f32.argtypes = evict_args
        lib.pbm_batched_evict_i32.argtypes = evict_args
        lib.pbm_fifo_grant.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _P]
        lib.pbm_wake_solve.argtypes = [_P, _P, _I, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _P]
        lib.pbm_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
        split = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
        lib.pbm_split_evict_f32.argtypes = split
        lib.pbm_split_evict_i32.argtypes = split
        lib.pbm_split_grant.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.pbm_split_wake.argtypes = [_P, _P, _I, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _P, _P, _P, _P, _P, _I,
                                       _P]
        cand = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]
        lib.pbm_split_evict_cand_f32.argtypes = cand
        lib.pbm_split_evict_cand_i32.argtypes = cand
        lib.pbm_split_evict_finish.argtypes = [_P, _P, _I, _P, _P, _P, _I,
                                               _I, _I, _I, _I, _LL, _P]
        lib.pbm_split_grant_cand.argtypes = [_P, _P, _I, _P, _P, _P, _I, _I,
                                             _I, _I, _I, _I, _I, _P]
        lib.pbm_split_grant_finish.argtypes = [_P, _P, _P, _I, _P, _P, _P,
                                               _P, _P, _I, _I, _I, _I, _I,
                                               _I, _LL, _P]
        if lib.pbm_head_cap() != HEAD_CAP:
            raise RuntimeError(f"pbm_timeline: the library's head capacity "
                               f"{lib.pbm_head_cap()} is not {HEAD_CAP}")
        if lib.pbm_max_sort_len() != MAX_SORT_LEN:
            raise RuntimeError(f"pbm_timeline: the library's longest sorted "
                               f"row {lib.pbm_max_sort_len()} is not "
                               f"{MAX_SORT_LEN}")
        _LIB = lib
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {device}")
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    if index not in _MAX_DYN:
        limits = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            _raise_on(_LIB.pbm_init(limits), "pbm_init")
        _MAX_DYN[index] = tuple(limits)
    return _LIB, _MAX_DYN[index]


def _sizes_stride(sizes: torch.Tensor, L: int, P: int) -> int:
    """Lane stride of ``sizes``: one shared ``(P,)`` row or ``(L, P)``."""
    if sizes.dim() == 1:
        _check(sizes, "sizes", torch.float32, (P,))
        return 0
    _check(sizes, "sizes", torch.float32, (L, P))
    return P


def _sort_len(P: int, max_dyn: int, entry_bytes: int = 8) -> Optional[int]:
    """Length of the row a block sorts in shared memory: the power of two
    at or above ``P`` (at least one warp), ``entry_bytes`` an entry (the
    head path of a short row takes at most 25 KB, which every block has);
    None above what one block can hold."""
    n = _pow2(P)
    return n if n <= min(MAX_SORT_LEN, max_dyn // entry_bytes) else None


def _pow2(n: int) -> int:
    return max(32, 1 << (max(n, 1) - 1).bit_length())


def _slice_fits(p_loc: int, max_dyn: int) -> bool:
    """One shard of ``p_loc`` pages fits a block on every page-split
    launch: its sorted slice (8 bytes an entry) and its key fields beside
    the longest head."""
    n = _pow2(p_loc)
    return (n <= MAX_SORT_LEN and 8 * n <= max_dyn
            and 4 * p_loc + 16 + 8 * HEAD_CAP <= max_dyn)


def split_shards(P: int, page_shards: int = 1,
                 max_dyn: int = HOPPER_SMEM) -> int:
    """Shards of the page-split path for a row of ``P`` pages: the fewest,
    at least ``page_shards``, that divide ``P`` and whose slices fit a
    block with ``max_dyn`` bytes of dynamic shared memory.
    ``page_shards`` must divide ``P``, as the JAX package's page axis
    must."""
    page_shards = int(page_shards)
    if page_shards < 1:
        raise ValueError(f"page_shards={page_shards}: at least one shard")
    if P % page_shards:
        raise ValueError(
            f"page axis has {page_shards} shards which do not divide the "
            f"padded pool size P={P}")
    for n in range(page_shards, P + 1):
        if P % n == 0 and _slice_fits(P // n, max_dyn):
            return n
    raise ValueError(f"P={P}: no shard of a divisor of P fits a block")


def splits(P: int, page_shards: int = 1) -> bool:
    """Whether a call over ``P`` pages takes the page-split path on a
    Hopper card: a split is asked for, or the row does not fit one block."""
    return int(page_shards) > 1 or _pow2(P) > MAX_SORT_LEN


def _words(L: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """A work buffer of ``(L, n)`` 64-bit sort words."""
    return torch.empty((L, n), dtype=torch.int64, device=like.device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _head_slots(P: int, vmax: int, n_sh: int):
    """``(m_slots, whole)`` of a batched_evict or fifo_grant page-split
    call: the candidate slots each shard fills, and whether every lane
    takes the whole-row kernels instead (a head longer than HEAD_CAP, or
    more candidates than one block sorts)."""
    m_slots = max(1, min(int(vmax), P // n_sh))
    return m_slots, (min(int(vmax), P) > HEAD_CAP
                     or n_sh * m_slots > MAX_SORT_LEN)


def split_ranks(P: int, n_rank: int, max_dyn: int = HOPPER_SMEM) -> int:
    """Shards a rank of an ``n_rank``-rank page group selects in: the
    fewest that divide its ``P / n_rank`` pages and fit a block
    (``split_shards`` of its slice).  ``n_rank`` must divide P."""
    if P % int(n_rank):
        raise ValueError(
            f"page axis has {n_rank} shards which do not divide the "
            f"padded pool size P={P}")
    return split_shards(P // int(n_rank), 1, max_dyn)


def _split_buffers(key: torch.Tensor, vmax: int, n_sh: int):
    """``(m_slots, cand, work, sorted)``: a head path's candidate words,
    or a whole-row path's two ``(L, P)`` word rows."""
    L, P = key.shape
    m_slots, whole = _head_slots(P, vmax, n_sh)
    if whole:
        return m_slots, None, _words(L, P, key), _words(L, P, key)
    return m_slots, _words(L, n_sh * m_slots, key), None, None


def batched_evict_kernel(key, sizes, evictable, need_free, *,
                         vmax: int = 64, page_shards: int = 1,
                         page_group=None) -> torch.Tensor:
    """Evict mask ``(L, P)`` bool; ``key`` is f32 or i32 (two
    instantiations, the integer one never touches a float).  A row beyond
    one block, or ``page_shards > 1``, takes the page-split path; a
    ``page_group`` splits it across the group's ranks."""
    L, P = key.shape
    _check(key, "key", key.dtype, (L, P))
    lib, max_dyn = library(key.device)
    if key.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"key: expected float32 or int32, got {key.dtype}")
    f32 = key.dtype == torch.float32
    stride = _sizes_stride(sizes, L, P)
    _check(evictable, "evictable", torch.bool, (L, P))
    _check(need_free, "need_free", torch.float32, (L,))
    out = torch.empty((L, P), dtype=torch.bool, device=key.device)
    n = (_sort_len(P, max_dyn[0])
         if int(page_shards) == 1 and page_group is None else None)
    if n is not None:
        fn = lib.pbm_batched_evict_f32 if f32 else lib.pbm_batched_evict_i32
        err = _call_on(key, fn, key.data_ptr(), sizes.data_ptr(), stride,
                       evictable.data_ptr(), need_free.data_ptr(),
                       out.data_ptr(), L, P, int(vmax), n, _stream(key))
    else:
        n_sh = _split_count(P, page_shards, page_group, max_dyn[3])
        m_slots, whole = _head_slots(P, vmax, n_sh)
        if page_group is not None and not whole:
            err = _evict_ranks(lib, key, sizes, stride, evictable,
                               need_free, out, int(vmax), n_sh, m_slots,
                               page_group)
        else:               # one process, or a whole row on every rank
            _, cand, work, srt = _split_buffers(key, vmax, n_sh)
            fn = lib.pbm_split_evict_f32 if f32 else lib.pbm_split_evict_i32
            err = _call_on(key, fn, key.data_ptr(), sizes.data_ptr(), stride,
                           evictable.data_ptr(), need_free.data_ptr(),
                           out.data_ptr(), L, P, int(vmax), n_sh, m_slots,
                           _ptr(cand), _ptr(work), _ptr(srt), _stream(key))
    _raise_on(err, "batched_evict launch")
    batched_evict_kernel.launches += 1
    return out


def fifo_grant_kernel(key, sizes, budget, pops, *, vmax: int = 16,
                      page_shards: int = 1, page_group=None,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mask (L, P) bool, granted_bytes (L,) f32, n_granted (L,) i32)``.
    A row beyond one block, or ``page_shards > 1``, takes the page-split
    path; a ``page_group`` splits it across the group's ranks."""
    L, P = key.shape
    _check(key, "key", torch.int32, (L, P))
    lib, max_dyn = library(key.device)
    stride = _sizes_stride(sizes, L, P)
    _check(budget, "budget", torch.float32, (L,))
    _check(pops, "pops", torch.int32, (L,))
    mask = torch.empty((L, P), dtype=torch.bool, device=key.device)
    nbytes = torch.empty((L,), dtype=torch.float32, device=key.device)
    n = torch.empty((L,), dtype=torch.int32, device=key.device)
    n_sort = (_sort_len(P, max_dyn[1])
              if int(page_shards) == 1 and page_group is None else None)
    if n_sort is not None:
        err = _call_on(key, lib.pbm_fifo_grant,
                       key.data_ptr(), sizes.data_ptr(), stride,
                       budget.data_ptr(), pops.data_ptr(), mask.data_ptr(),
                       nbytes.data_ptr(), n.data_ptr(), L, P, int(vmax),
                       n_sort, _stream(key))
    else:
        n_sh = _split_count(P, page_shards, page_group, max_dyn[3])
        m_slots, whole = _head_slots(P, vmax, n_sh)
        if page_group is not None and not whole:
            err = _grant_ranks(lib, key, sizes, stride, budget, pops,
                               (mask, nbytes, n), int(vmax), n_sh, m_slots,
                               page_group)
        else:               # one process, or a whole row on every rank
            _, cand, work, srt = _split_buffers(key, vmax, n_sh)
            stats = None if cand is None else torch.empty(
                (L, n_sh, 2), dtype=torch.int32, device=key.device)
            err = _call_on(key, lib.pbm_split_grant,
                           key.data_ptr(), sizes.data_ptr(), stride,
                           budget.data_ptr(), pops.data_ptr(),
                           mask.data_ptr(), nbytes.data_ptr(), n.data_ptr(),
                           L, P, int(vmax), n_sh, m_slots, _ptr(cand),
                           _ptr(stats), _ptr(work), _ptr(srt), _stream(key))
    _raise_on(err, "fifo_grant launch")
    fifo_grant_kernel.launches += 1
    return mask, nbytes, n


def _split_count(P: int, page_shards: int, group, max_split: int) -> int:
    """Shards of a page-split call, across the page row's ranks when a
    ``group`` is given (``split_ranks`` a rank)."""
    if group is None:
        return split_shards(P, page_shards, max_split)
    n_rank = collective.size_rank(group)[0]
    return n_rank * split_ranks(P, n_rank, max_split)


def _evict_ranks(lib, key, sizes, stride: int, evictable, need_free, out,
                 vmax: int, n_sh: int, m_slots: int, group) -> int:
    """B1's head path across the ranks of ``group`` (``n_sh`` shards in
    all, ``m_slots`` candidates a shard): stage 1 over the rank's own
    shards, the all-gather, stage 2 on every rank.  A whole-row path
    takes no collective: every rank sorts the row it holds."""
    L, P = key.shape
    n_rank, rank = collective.size_rank(group)
    n_loc = n_sh // n_rank
    f32 = key.dtype == torch.float32
    words = L * n_loc * m_slots
    own = torch.empty((words,), dtype=torch.int64, device=key.device)
    fn = lib.pbm_split_evict_cand_f32 if f32 else lib.pbm_split_evict_cand_i32
    err = _call_on(key, fn, key.data_ptr(), evictable.data_ptr(),
                   need_free.data_ptr(), L, P, vmax, n_sh, rank * n_loc,
                   n_loc, m_slots, own.data_ptr(), _stream(key))
    _raise_on(err, "batched_evict stage 1")
    every = collective.all_gather(own, group)
    return _call_on(key, lib.pbm_split_evict_finish, every.data_ptr(),
                    sizes.data_ptr(), stride, evictable.data_ptr(),
                    need_free.data_ptr(), out.data_ptr(), L, P, vmax,
                    n_sh * m_slots, n_rank, words, _stream(key))


def _grant_ranks(lib, key, sizes, stride: int, budget, pops, outs,
                 vmax: int, n_sh: int, m_slots: int, group) -> int:
    """B2's head path across the ranks of ``group``, as
    :func:`_evict_ranks`; a rank's buffer holds its candidate words and,
    after them, its shards' stats (two ints a shard), so one all-gather
    carries both."""
    L, P = key.shape
    mask, nbytes, n = outs
    n_rank, rank = collective.size_rank(group)
    n_loc = n_sh // n_rank
    words = L * n_loc * m_slots
    own = torch.empty((words + L * n_loc,), dtype=torch.int64,
                      device=key.device)
    stats = own[words:]                 # (L, n_loc, 2) i32, 8 bytes a shard
    err = _call_on(key, lib.pbm_split_grant_cand, key.data_ptr(),
                   sizes.data_ptr(), stride, pops.data_ptr(), own.data_ptr(),
                   stats.data_ptr(), L, P, vmax, n_sh, rank * n_loc, n_loc,
                   m_slots, _stream(key))
    _raise_on(err, "fifo_grant stage 1")
    every = collective.all_gather(own, group)
    return _call_on(key, lib.pbm_split_grant_finish, every.data_ptr(),
                    every[0, words:].data_ptr(), sizes.data_ptr(), stride,
                    budget.data_ptr(), pops.data_ptr(), mask.data_ptr(),
                    nbytes.data_ptr(), n.data_ptr(), L, P, vmax, n_sh,
                    n_sh * m_slots, n_rank, own.numel(), _stream(key))


def wake_solve_kernel(key, sizes, credit0, inc, pops, *,
                      h_cap: int = 64) -> torch.Tensor:
    """Grant step per page, ``(L, P)`` i32 in ``1..h_cap``, sentinel
    ``h_cap + 1``.  Unsplit, as in the JAX package; a row beyond one
    block takes the page-split path with the fewest shards that fit."""
    L, P = key.shape
    _check(key, "key", torch.int32, (L, P))
    lib, max_dyn = library(key.device)
    stride = _sizes_stride(sizes, L, P)
    _check(credit0, "credit0", torch.float32, (L,))
    _check(inc, "inc", torch.float32, (L,))
    _check(pops, "pops", torch.int32, (L,))
    if not 1 <= int(h_cap) <= lib.pbm_max_h_cap():
        raise ValueError(f"wake_solve: h_cap={h_cap} outside "
                         f"1..{lib.pbm_max_h_cap()}")
    out = torch.empty((L, P), dtype=torch.int32, device=key.device)
    n = _sort_len(P, max_dyn[2], entry_bytes=12)
    if n is not None:
        err = _call_on(key, lib.pbm_wake_solve,
                       key.data_ptr(), sizes.data_ptr(), stride,
                       credit0.data_ptr(), inc.data_ptr(), pops.data_ptr(),
                       out.data_ptr(), L, P, int(h_cap), n, _stream(key))
    else:
        n_sh = split_shards(P, 1, max_dyn[3])
        m_slots = min(HEAD_CAP, P // n_sh)
        force = int(n_sh * m_slots > MAX_SORT_LEN)
        cand = _words(L, n_sh * m_slots, key)
        stats = torch.empty((L, n_sh, 2), dtype=torch.int32, device=key.device)
        work, srt = _words(L, P, key), _words(L, P, key)
        idx = torch.empty((L, P), dtype=torch.int32, device=key.device)
        err = _call_on(key, lib.pbm_split_wake,
                       key.data_ptr(), sizes.data_ptr(), stride,
                       credit0.data_ptr(), inc.data_ptr(), pops.data_ptr(),
                       out.data_ptr(), L, P, int(h_cap), n_sh, m_slots,
                       cand.data_ptr(), stats.data_ptr(), work.data_ptr(),
                       srt.data_ptr(), idx.data_ptr(), force, _stream(key))
    _raise_on(err, "wake_solve launch")
    wake_solve_kernel.launches += 1
    return out


def _split_whole(name: str, P: int, static) -> bool:
    """Whether every busy lane of a page-split call takes the whole-row
    path, as the wrapper decides on the host."""
    n_sh = split_shards(P, static.get("page_shards", 1))
    if name == "wake_solve":
        return n_sh * min(HEAD_CAP, P // n_sh) > MAX_SORT_LEN
    return _head_slots(P, static["vmax"], n_sh)[1]


# analysis: host -- the paths lanes took, a summary read by chip_smoke.py
def lane_paths(name: str, args, static) -> list:
    """Per lane of one ``batched_evict``, ``fifo_grant`` or ``wake_solve``
    call (``args`` its tensors in call order, ``static`` its keyword
    arguments), the path its kernel takes, by the rule the kernel applies
    on the device: ``"idle"`` (nothing to do: the lane writes the empty
    answer and selects nothing), ``"select"`` (the first m entries of the
    service order selected and sorted alone), ``"full"`` (the whole row
    sorted) and, for batched_evict, ``"all"`` (every page is a candidate,
    so every page is sorted with no selection).  A call that takes the
    page-split path (``splits``) names ``"split_select"`` (candidates of
    every shard, their head sorted alone) and ``"split_full"`` (the
    multi-block sort of the whole row) instead.

    batched_evict: m = min(vmax, P), every page taking part; idle iff
    need_free is not > 0 or m <= 0, else full iff m > HEAD_CAP, else all
    iff vmax >= P.  fifo_grant: m = min(vmax, P, pops, wanted pages), idle
    iff m <= 0, full iff m > HEAD_CAP.  wake_solve: m = min(wanted pages,
    h_cap * max(pops, 0)), idle iff m = 0, full iff m > HEAD_CAP, or
    ``inc`` is negative or NaN, or a wanted page's size is negative or not
    finite.  Split: batched_evict and fifo_grant are whole-row for every
    lane (idle lanes of batched_evict aside) when min(vmax, P) > HEAD_CAP;
    wake_solve's lanes choose as above."""
    key = args[0]
    L, P = key.shape
    split = splits(P, static.get("page_shards", 1))
    whole = split and _split_whole(name, P, static)
    if name == "batched_evict":
        vmax = int(static["vmax"])
        m = min(vmax, P)
        busy = (args[3] > 0) & (m > 0)
        if split:
            path = "split_full" if whole else "split_select"
        else:
            path = "full" if m > HEAD_CAP else "all" if vmax >= P else "select"
        return [path if b else "idle" for b in busy.tolist()]
    wanted = key >= 0
    n_part = wanted.sum(dim=1)
    if name == "fifo_grant":
        pops = args[3].long()
        m = torch.minimum(torch.minimum(pops, n_part),
                          torch.full_like(n_part, min(int(static["vmax"]), P)))
        idle, full = m <= 0, m > HEAD_CAP
        if whole:
            idle, full = torch.zeros_like(idle), torch.ones_like(full)
    elif name == "wake_solve":
        sizes, inc, pops = args[1], args[3], args[4]
        sizes = sizes.expand(L, P)
        m = torch.minimum(n_part, int(static["h_cap"]) * pops.long().clamp(min=0))
        bad = (wanted & ~(torch.isfinite(sizes) & (sizes >= 0))).any(dim=1)
        idle = m == 0
        full = (m > HEAD_CAP) | ~(inc >= 0) | bad | whole
    else:
        raise ValueError(f"lane_paths: {name} has one path")
    sel, ful = ("split_select", "split_full") if split else ("select", "full")
    return ["idle" if i else ful if f else sel
            for i, f in zip(idle.tolist(), full.tolist())]


#: the paths each kernel's lanes can take (``lane_paths``) on one block a
#: lane, and on the page-split path
PATHS = {"batched_evict": ("idle", "select", "all", "full"),
         "fifo_grant": ("idle", "select", "full"),
         "wake_solve": ("idle", "select", "full")}
SPLIT_PATHS = ("idle", "split_select", "split_full")


batched_evict_kernel.launches = 0
fifo_grant_kernel.launches = 0
wake_solve_kernel.launches = 0

KERNELS = {
    "batched_evict": batched_evict_kernel,
    "fifo_grant": fifo_grant_kernel,
    "wake_solve": wake_solve_kernel,
}
