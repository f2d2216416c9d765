"""Event-engine buffer policies of the port: own copies of the JAX
package's pure-Python ``repro.core.policies`` (the dict/heapq machine the
array simulator is held to), the paper's §5 sketches ``pbm_lru`` and
``attach_throttle`` included."""

from .base import BufferPool, Policy
from .lru import LRUPolicy, MRUPolicy
from .pbm import PBMPolicy
from .opt import OraclePolicy, simulate_belady
from .cscan import ABM
from .pbm_lru import PBMLRUPolicy
from .attach_throttle import AttachThrottlePBM

__all__ = [
    "ABM", "AttachThrottlePBM", "BufferPool", "LRUPolicy", "MRUPolicy",
    "OraclePolicy", "PBMLRUPolicy", "PBMPolicy", "Policy", "simulate_belady",
]
