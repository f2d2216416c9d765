"""Core of the port: the paper's storage model, scan operators, the
workloads of the evaluation, the policy registry, the event engine (the
dict/heapq machine the simulator is held to) and the batched array
simulator (``array_sim``)."""

from . import policy_registry
from .pages import Column, Database, Page, PageId, Table
from .scans import ScanSpec, ScanState
from .engine import Engine, EngineConfig, EngineResult, run_workload
from .policies.base import BufferPool, Policy
from .policies.lru import LRUPolicy, MRUPolicy
from .policies.pbm import PBMPolicy
from .policies.opt import OraclePolicy, simulate_belady
from .policies.cscan import ABM

__all__ = [
    "ABM", "BufferPool", "Column", "Database", "Engine", "EngineConfig",
    "EngineResult", "LRUPolicy", "MRUPolicy", "OraclePolicy", "PBMPolicy",
    "Page", "PageId", "Policy", "ScanSpec", "ScanState", "Table",
    "policy_registry", "run_workload", "simulate_belady",
]
