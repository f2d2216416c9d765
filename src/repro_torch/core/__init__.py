"""Core of the port: the paper's storage model, scan specs, the workloads
of the evaluation, the policy registry (array side) and the batched
array simulator (``array_sim``)."""

from . import policy_registry
from .pages import Column, Database, Page, PageId, Table
from .scans import ScanSpec

__all__ = [
    "Column", "Database", "Page", "PageId", "ScanSpec", "Table",
    "policy_registry",
]
