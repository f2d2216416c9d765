"""Paged-KV serving path of the port: page pool, policy driver,
continuous-batching engine (pure Python, copies of ``repro.serving``) and
``PagedTinyLM`` (``serving.model``), which decodes through the
paged-attention kernel."""

from .kv_cache import PagePool, RequestKV, prefix_hash
from .engine import EngineStats, Request, ServingEngine
from .policy_driver import (
    DecodeSchedule, PolicyDriver, ServingCScan, ServingLRU, ServingOPT,
    ServingPBM, ServingPolicy,
)

__all__ = [
    "DecodeSchedule", "EngineStats", "PagePool", "PolicyDriver", "Request",
    "RequestKV", "ServingCScan", "ServingEngine", "ServingLRU", "ServingOPT",
    "ServingPBM", "ServingPolicy", "prefix_hash",
]
