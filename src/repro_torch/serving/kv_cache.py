"""Paged KV cache: page pool, per-request page tables, prefix sharing.

The port's own copy of ``repro.serving.kv_cache`` (pure Python, nothing
of the JAX package imported): the same free-list order, the same negative
host uids, the same refcount and prefix-index rules and the same blake2b
prefix digest, so both packages hand out the same page ids for the same
requests.

The serving-side realisation of the paper's storage model (DESIGN.md §2):

* the HBM page pool is the buffer pool; a decode request's KV pages are the
  pages of its "scan";
* prompt-prefix pages shared by many requests are the paper's **shared
  chunks** (snapshot common prefixes, §2.1): refcounted, evicted last;
* pages of preempted requests can spill to the host tier (swap), the
  decision being the buffer-management policy under test (see scheduler).

The pool hands out *page ids* compatible with ``kernels.paged_attention``'s
page-table layout; actual K/V tensors live in one (n_pages, page_size, Hk,
dh) tensor per layer, owned by whoever runs the model.  Swapping moves
page ids only, not K/V contents (as in the JAX package): a resumed request
reads whatever its new slots hold.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass
class PageMeta:
    page_id: int
    ref_count: int = 0
    prefix_hash: Optional[bytes] = None   # set for shared prompt pages
    on_host: bool = False                 # spilled to host tier


class PagePool:
    """Fixed-size pool of KV pages with refcounts and a host spill tier."""

    def __init__(self, n_pages: int, page_size: int, page_bytes: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.page_bytes = page_bytes
        self.free: List[int] = list(range(n_pages))
        self.meta: Dict[int, PageMeta] = {}
        self.prefix_index: Dict[bytes, int] = {}   # prefix hash -> page id
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self._next_host_uid = -1

    # ------------------------------------------------------------- alloc
    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self.free)

    def alloc(self, prefix_hash: Optional[bytes] = None) -> Optional[int]:
        if prefix_hash is not None and prefix_hash in self.prefix_index:
            pid = self.prefix_index[prefix_hash]
            m = self.meta[pid]
            if not m.on_host:
                m.ref_count += 1
                return pid            # shared-chunk hit: no new page
        if not self.free:
            return None
        pid = self.free.pop()
        self.meta[pid] = PageMeta(page_id=pid, ref_count=1, prefix_hash=prefix_hash)
        if prefix_hash is not None:
            self.prefix_index[prefix_hash] = pid
        return pid

    def release(self, pid: int) -> None:
        m = self.meta.get(pid)
        if m is None:
            return
        m.ref_count -= 1
        if m.ref_count <= 0:
            # two pages can carry the same prefix hash (a spilled prefix
            # page's host copy plus a fresh HBM page allocated for the same
            # prefix while it was away) — only the page the index actually
            # points at may drop the entry
            if m.prefix_hash is not None and \
                    self.prefix_index.get(m.prefix_hash) == pid:
                self.prefix_index.pop(m.prefix_hash, None)
            del self.meta[pid]
            if pid >= 0:  # host uids (< 0) are not HBM slots
                self.free.append(pid)

    # -------------------------------------------------------------- spill
    # Host-tier pages get fresh NEGATIVE uids so a freed HBM slot can be
    # reallocated without aliasing the host copy's identity.  Shared prefix
    # pages (ref_count > 1) are never spilled — they are the paper's shared
    # chunks: other scans still want them, keep them hot.
    def swap_out(self, pids: Sequence[int]) -> Dict[int, int]:
        """Spill exclusively-owned pages to host. Returns {hbm_id: host_uid}."""
        mapping: Dict[int, int] = {}
        for pid in pids:
            m = self.meta.get(pid)
            if m is None or m.on_host or pid < 0:
                continue
            if m.ref_count > 1:
                continue  # shared prefix page stays resident
            uid = self._next_host_uid
            self._next_host_uid -= 1
            del self.meta[pid]
            m.on_host = True
            m.page_id = uid
            self.meta[uid] = m
            if m.prefix_hash is not None:
                self.prefix_index.pop(m.prefix_hash, None)
            self.free.append(pid)
            mapping[pid] = uid
            self.swap_out_bytes += self.page_bytes
        return mapping

    def swap_in(self, uids: Sequence[int]) -> Optional[Dict[int, int]]:
        """Bring host pages back. Returns {host_uid: hbm_id}; None if no room."""
        need = [u for u in uids if u < 0 and u in self.meta]
        if len(self.free) < len(need):
            return None
        mapping: Dict[int, int] = {}
        for uid in need:
            m = self.meta.pop(uid)
            slot = self.free.pop()
            m.on_host = False
            m.page_id = slot
            self.meta[slot] = m
            if m.prefix_hash is not None:
                # a fresh page may have taken this prefix while the copy
                # was on host — keep the established mapping, the returned
                # copy serves only its own request
                self.prefix_index.setdefault(m.prefix_hash, slot)
            mapping[uid] = slot
            self.swap_in_bytes += self.page_bytes
        return mapping


def prefix_hash(tokens: Sequence[int]) -> bytes:
    return hashlib.blake2b(bytes(str(list(tokens)), "utf8"), digest_size=16).digest()


@dataclass
class RequestKV:
    """Per-request page table over the pool."""

    pool: PagePool
    page_size: int
    pages: List[int] = field(default_factory=list)
    shared_prefix_pages: int = 0
    length: int = 0

    def append_tokens(self, n: int) -> bool:
        """Ensure capacity for n more tokens; allocate pages as needed."""
        target = self.length + n
        while len(self.pages) * self.page_size < target:
            pid = self.pool.alloc()
            if pid is None:
                return False
            self.pages.append(pid)
        self.length = target
        return True

    def attach_prefix(self, prompt: Sequence[int]) -> int:
        """Allocate prompt pages, sharing full pages with identical prefixes.

        Returns the number of *shared* (reused) pages — the paper's shared
        chunks metric."""
        shared = 0
        full_pages = len(prompt) // self.page_size
        for p in range(full_pages):
            h = prefix_hash(prompt[: (p + 1) * self.page_size])
            before = self.pool.prefix_index.get(h)
            pid = self.pool.alloc(prefix_hash=h)
            if pid is None:
                return -1
            if before is not None and before == pid:
                shared += 1
            self.pages.append(pid)
        rem = len(prompt) - full_pages * self.page_size
        if rem:
            pid = self.pool.alloc()
            if pid is None:
                return -1
            self.pages.append(pid)
        self.length = len(prompt)
        self.shared_prefix_pages = shared
        return shared

    def release_all(self) -> None:
        for pid in self.pages:
            self.pool.release(pid)
        self.pages.clear()
        self.length = 0
