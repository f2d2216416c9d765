"""Continuous-batching serving engine with registry-driven KV tiering.

The port's own copy of ``repro.serving.engine`` (pure Python): the same
admission watermark, preemption loop, resume fallthrough, prefetch,
``_decode_rate`` update and event records, so that the same traffic gives
the same ``EngineStats``, token gaps, finish order and events.

The scheduler is where the paper's insight lands in serving: under HBM
oversubscription some request's pages must leave the pool, and the
scheduler *knows the future* — its own queue discloses which request will
run furthest in the future.  Eviction (preemption), spill (swap-out),
resume order and prefetch (swap-in ahead of need) are all delegated to a
:class:`~repro_torch.serving.policy_driver.PolicyDriver` around a policy
resolved through ``repro_torch.core.policy_registry`` — the SAME name
table the batched simulator uses (``lru`` / ``pbm`` / ``cscan`` /
``opt``; see DESIGN.md §2: the paper's "unattainable" OPT becomes
attainable when the future is the scheduler's own plan).

Token generation is abstracted behind ``step_fn`` so the engine (page
management = the paper's contribution) is testable without a model;
:class:`~repro_torch.serving.model.PagedTinyLM` wires a real tiny model
through ``kernels.ops.paged_attention``.

Swap-in costs one engine step (``swap_delay``): a resumed request's pages
are in flight for that long before it decodes, unless the driver's
prepare-ahead stage already staged them while the batch was full — the
push-based prefetch half of the policy surface (zicIO blueprint: prepare
pages just before workers touch them).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Union

from .kv_cache import PagePool, RequestKV
from .policy_driver import PolicyDriver, ServingPolicy

_req_ids = itertools.count()


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    rid: int = field(default_factory=lambda: next(_req_ids))
    generated: List[int] = field(default_factory=list)
    kv: Optional[RequestKV] = None
    last_decode_step: int = -1
    arrival_step: int = 0
    admitted_step: int = -1
    first_token_step: int = -1
    done_step: int = -1
    ready_step: int = 0        # swap-in transfer completes at this step
    prefetched: bool = False   # host pages staged back ahead of resume
    swapped: bool = False
    done: bool = False

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)


@dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    prefills: int = 0
    preemptions: int = 0
    resumes: int = 0
    prefetched_resumes: int = 0
    shared_prefix_pages: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0


class ServingEngine:
    def __init__(
        self,
        pool: PagePool,
        step_fn: Callable[[Sequence[Request]], List[int]],
        policy: Union[str, ServingPolicy] = "pbm",
        max_batch: int = 8,
        swap_delay: int = 1,
        record_events: bool = False,
    ) -> None:
        if isinstance(policy, str):
            from ..core import policy_registry
            policy = policy_registry.serving_policy(policy)
        self.driver = PolicyDriver(policy)
        self.policy = policy.name
        self.pool = pool
        self.step_fn = step_fn
        self.max_batch = max_batch
        self.swap_delay = swap_delay
        self.pending: Deque[Request] = deque()
        self.active: List[Request] = []
        self.swapped: Deque[Request] = deque()
        self.finished: List[Request] = []
        self.stats = EngineStats()
        self.token_gaps: List[int] = []   # steps between successive tokens
        self._decode_rate = 1.0  # tokens/step/request (measured)
        # structured scheduler events (admit/preempt/resume/prefetch with
        # the policy verdict attached), in the JAX package's format
        self.record_events = record_events
        self.events: List[dict] = []

    def _emit(self, kind: str, req: Optional[Request] = None, **args) -> None:
        if not self.record_events:
            return
        ev = {"step": self.stats.steps, "kind": kind, "policy": self.policy}
        if req is not None:
            ev["rid"] = req.rid
            ev["remaining"] = req.remaining
        ev.update(args)
        self.events.append(ev)

    # ---------------------------------------------------------------- admit
    def submit(self, req: Request) -> None:
        req.arrival_step = self.stats.steps
        self.pending.append(req)

    def _host_page_count(self, req: Request) -> int:
        return sum(1 for p in req.kv.pages if p < 0)

    def _resume(self, req: Request) -> bool:
        """Swap a preempted request's host pages back in; True on success."""
        mapping = self.pool.swap_in(req.kv.pages)
        if mapping is None:
            return False
        req.kv.pages = [mapping.get(p, p) for p in req.kv.pages]
        # prepared-ahead pages are already resident: no transfer to wait on
        req.ready_step = self.stats.steps + (
            0 if req.prefetched else self.swap_delay
        )
        self.stats.resumes += 1
        self.stats.prefetched_resumes += bool(req.prefetched)
        self._emit("resume", req, prefetched=req.prefetched,
                   ready_step=req.ready_step)
        req.prefetched = False
        req.swapped = False
        req.admitted_step = self.stats.steps
        self.swapped.remove(req)
        self.active.append(req)
        return True

    def _try_admit(self) -> None:
        # Admission control: swap-in/prefill happen only out of FREE pages —
        # preemption is reserved for *growth* of already-running requests
        # (step()), where the victim choice is the policy decision under
        # test.  Without this watermark the engine thrashes exactly like an
        # unthrottled buffer pool.
        watermark = max(2, len(self.active))
        # resume preempted requests first (they hold finished prefills); the
        # ORDER is the policy's resume_key — FIFO for lru, nearest-completion
        # first for pbm/opt, most-shared first for cscan
        while self.swapped and len(self.active) < self.max_batch:
            sched = self.driver.view(self)
            req = self.driver.next_resume(sched)
            need = self._host_page_count(req)
            if need and self.pool.free_count < need + watermark and self.active:
                break
            if not self._resume(req):
                if self.active:
                    break
                # empty machine and the policy's preferred candidate does
                # not fit the free pool (other swapped requests pin their
                # shared prefix pages resident) — forward progress demands
                # resuming SOMETHING: walk the policy's resume order and
                # take the first candidate that fits
                if not any(self._resume(cand)
                           for cand in self.driver.resume_order(sched)
                           if cand is not req):
                    break
                continue
        while self.pending and len(self.active) < self.max_batch:
            req = self.pending[0]
            need = len(req.prompt) // self.pool.page_size + 1
            if self.pool.free_count < need + watermark and self.active:
                break
            kv = RequestKV(self.pool, self.pool.page_size)
            shared = kv.attach_prefix(req.prompt)
            if shared < 0:
                kv.release_all()
                if self.active or not self._make_room():
                    break
                continue
            self.stats.shared_prefix_pages += shared
            req.kv = kv
            req.admitted_step = self.stats.steps
            req.ready_step = self.stats.steps
            self.stats.prefills += 1
            self._emit("admit", req, shared_prefix_pages=shared,
                       prompt_pages=need)
            self.pending.popleft()
            self.active.append(req)

    def _prefetch_ahead(self) -> None:
        """Push-based prepare-ahead (the zicIO half of the policy surface):
        while the batch is full, stage the next resume candidate's host
        pages back into FREE HBM so the swap-in delay is paid before a
        batch slot opens.  Strictly watermark-gated — prefetch never takes
        pages the active batch's growth would want next."""
        if len(self.active) < self.max_batch or not self.swapped:
            return
        req = self.driver.next_resume(self.driver.view(self))
        if req is None or req.prefetched:
            return
        need = self._host_page_count(req)
        if need == 0:
            return
        watermark = max(2, len(self.active))
        if self.pool.free_count < need + 2 * watermark:
            return
        mapping = self.pool.swap_in(req.kv.pages)
        if mapping is None:
            return
        req.kv.pages = [mapping.get(p, p) for p in req.kv.pages]
        req.prefetched = True
        self._emit("prefetch", req, pages=need)

    # ------------------------------------------------------------- preempt
    def _victim(self) -> Optional[Request]:
        # anti-ping-pong: a request admitted THIS step is not preemptible,
        # so each request swaps at most once per engine step.  The choice
        # among candidates is the registry policy's victim_key.
        cands = [r for r in self.active if r.admitted_step != self.stats.steps]
        return self.driver.choose_victim(cands, self.driver.view(self))

    def _make_room(self, for_swap_in: int = 0) -> bool:
        """Preempt until at least one HBM slot is actually freed.

        A victim whose pages are all shared prefix pages frees nothing
        (shared chunks stay resident); keep preempting further victims and
        report False if no candidate frees a slot."""
        progressed = False
        while not progressed:
            victim = self._victim()
            if victim is None:
                return False
            self.active.remove(victim)
            victim.swapped = True
            victim.prefetched = False
            mapping = self.pool.swap_out(victim.kv.pages)
            victim.kv.pages = [mapping.get(p, p) for p in victim.kv.pages]
            self.swapped.append(victim)
            self.stats.preemptions += 1
            self._emit("preempt", victim, freed_pages=len(mapping),
                       for_swap_in=bool(for_swap_in))
            progressed = bool(mapping)
        return True

    # ---------------------------------------------------------------- step
    def step(self) -> int:
        """One engine iteration: admit, decode one token per active request."""
        self._try_admit()
        self._prefetch_ahead()
        if not self.active:
            self.stats.steps += 1
            return 0
        # ensure every active request has a slot for one more token
        runnable: List[Request] = []
        for req in list(self.active):
            if req.ready_step > self.stats.steps:
                continue  # swap-in transfer still in flight
            if req.kv.append_tokens(1):
                runnable.append(req)
            else:
                if not self._make_room():
                    break
                if req.kv.append_tokens(1):
                    runnable.append(req)
        # a runnable request may have been chosen as a growth victim for a
        # later request in the same pass — only decode those still active
        runnable = [r for r in runnable if not r.swapped]
        new_tokens = self.step_fn(runnable)
        for req, tok in zip(runnable, new_tokens):
            req.generated.append(int(tok))
            if req.first_token_step < 0:
                req.first_token_step = self.stats.steps
            else:
                self.token_gaps.append(
                    self.stats.steps - req.last_decode_step
                )
            req.last_decode_step = self.stats.steps
            if req.remaining <= 0:
                req.done = True
                req.done_step = self.stats.steps
                req.kv.release_all()
                self.active.remove(req)
                self.finished.append(req)
        self.stats.steps += 1
        self.stats.tokens_generated += len(runnable)
        self._decode_rate = 0.9 * self._decode_rate + 0.1 * max(len(runnable), 1) / max(
            len(self.active) + len(self.swapped), 1
        )
        self.stats.swap_out_bytes = self.pool.swap_out_bytes
        self.stats.swap_in_bytes = self.pool.swap_in_bytes
        return len(runnable)

    def run_to_completion(self, max_steps: int = 100_000) -> EngineStats:
        while (self.pending or self.active or self.swapped) and self.stats.steps < max_steps:
            self.step()
        return self.stats
