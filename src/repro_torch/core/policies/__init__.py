"""Event-engine buffer policies of the port: own copies of the JAX
package's pure-Python ``repro.core.policies`` (the dict/heapq machine the
array simulator is held to).  ``pbm_lru`` and ``attach_throttle`` are not
ported yet."""

from .base import BufferPool, Policy
from .lru import LRUPolicy, MRUPolicy
from .pbm import PBMPolicy
from .opt import OraclePolicy, simulate_belady
from .cscan import ABM

__all__ = [
    "ABM", "BufferPool", "LRUPolicy", "MRUPolicy", "OraclePolicy",
    "PBMPolicy", "Policy", "simulate_belady",
]
