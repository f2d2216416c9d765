"""The frozen generator and the prefix rule: T = accessed bytes / bandwidth
for both configurations, and the scans each seed draws, fixed."""

from __future__ import annotations

import hashlib
import json

import pytest
from conftest import BENCH

from portbench import workloads

#: (configuration, seed) -> (a hash of every scan, accessed bytes, scans),
#: as the generator drew them when it was copied from
#: src/repro_torch/core/workload.py at commit 7b98c78 (equal there)
FROZEN = {
    ("micro_sf30", 3): ("8f39b37804696ec5", 1_260_000_000, 128),
    ("micro_sf30", 2**31 + 17): ("b694b943fdfb5038", 1_260_000_000, 128),
    ("tpch_sf30", 3): ("ad800eb84c44a0b9", 2_476_861_856, 424),
    ("tpch_sf30", 2**31 + 17): ("ee0a9a07aa8a6325", 2_476_370_848, 424),
}


def _config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,seed", sorted(FROZEN))
def test_the_generator_draws_the_frozen_scans(name, seed):
    work = workloads.generate(_config(name), seed)
    rows = [(s.table, s.columns, s.ranges, s.tuple_rate, s.stream)
            for stream in work.streams for s in stream]
    digest = hashlib.sha256(repr(rows).encode()).hexdigest()[:16]
    assert (digest, work.accessed_bytes, len(rows)) == FROZEN[(name, seed)]


@pytest.mark.parametrize("name,seed", sorted(FROZEN))
def test_the_prefix_is_accessed_bytes_over_bandwidth(name, seed):
    cfg = _config(name)
    traffic = json.loads((BENCH / "traffic" / "mixed.json").read_text())
    work = workloads.generate(cfg, seed)
    assert traffic["prefix_loads"] == 1.0
    T = workloads.prefix_time(cfg, traffic, work)
    assert T == work.accessed_bytes / cfg["bandwidth"]
    if name == "micro_sf30":      # the whole Q1 / Q6 column set: 1.8 s at 700 MB/s
        assert T == pytest.approx(1.8, abs=1e-12)
    else:                         # ~2.48 GB of the tables at 600 MB/s
        assert 4.0 < T < 4.2


def test_the_micro_accessed_set_is_the_q1_q6_columns():
    cfg = _config("micro_sf30")
    work = workloads.generate(cfg, 3)
    table = work.db.tables["lineitem"]
    cols = set(cfg["q1_columns"]) | set(cfg["q6_columns"])
    assert work.accessed_bytes == sum(
        p.size_bytes for c in cols for p in table.columns[c].pages)
