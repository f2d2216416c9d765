"""Core of the port: the paper's storage model, PDT-lite SID/RID
translation and append snapshots (paper §2.1), scan operators, the
workloads of the evaluation, the policy registry, the event engine (the
dict/heapq machine the simulator is held to) with every buffer policy of
the JAX package (the paper's four and its §5 sketches PBM/LRU and
Attach&Throttle), and the batched array simulator (``array_sim``)."""

from . import policy_registry
from .pages import Column, Database, Page, PageId, Table
from .pdt import PDT, CScanMergeState
from .snapshots import Snapshot, SnapshotManager, classify_chunks
from .scans import ScanSpec, ScanState
from .engine import Engine, EngineConfig, EngineResult, run_workload
from .policies.base import BufferPool, Policy
from .policies.lru import LRUPolicy, MRUPolicy
from .policies.pbm import PBMPolicy
from .policies.opt import OraclePolicy, simulate_belady
from .policies.cscan import ABM
from .policies.pbm_lru import PBMLRUPolicy
from .policies.attach_throttle import AttachThrottlePBM

__all__ = [
    "ABM", "AttachThrottlePBM", "BufferPool", "Column", "CScanMergeState",
    "Database", "Engine", "EngineConfig", "EngineResult", "LRUPolicy",
    "MRUPolicy", "OraclePolicy", "PBMLRUPolicy", "PBMPolicy", "PDT", "Page",
    "PageId", "Policy", "ScanSpec", "ScanState", "Snapshot",
    "SnapshotManager", "Table", "classify_chunks", "policy_registry",
    "run_workload", "simulate_belady",
]
