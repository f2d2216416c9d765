"""Shared set-up of the benchmark's CPU tests: a scratch checkout whose
``BENCHMARK.json`` adds test cells to the repository's, with the
benchmark's folder (traffic, metrics, limits) copied beside it, so a test
adds files as a later change would, without touching the repository."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent        # port_bench/
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
sys.path.insert(0, str(BENCH))

#: the CPU test cell: the micro configuration at a quarter of SF30 under
#: the mixed traffic, held to micro_sf30.mixed's limit
QUARTER = "micro_quarter.mixed"


def add_cell(root: Path, here: Path, name: str, config_file: Path,
             traffic: str, limits_of: str = "micro_sf30.mixed") -> None:
    """Add cell ``name`` (its configuration's file copied in) to the
    scratch checkout, as new files and new entries only."""
    cfg = json.loads(config_file.read_text())
    (root / "cfg").mkdir(exist_ok=True)
    shutil.copy(config_file, root / "cfg" / config_file.name)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if cfg["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({
            "name": cfg["name"], "source": cfg["source"][:200],
            "file": f"cfg/{config_file.name}", "reduced": ["n_tuples"],
            "why": "CPU test"})
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": traffic, "chips": 1,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    shutil.copy(here / "limits" / f"{limits_of}.json",
                here / "limits" / f"{name}.json")


@pytest.fixture
def checkout(tmp_path):
    """``(root, here)``: a scratch checkout with the quarter test cell."""
    root, here = tmp_path / "root", tmp_path / "root" / "port_bench"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(REPO / "src")
    for d in ("traffic", "metrics", "limits"):
        shutil.copytree(BENCH / d, here / d)
    add_cell(root, here, QUARTER, DATA / "micro_quarter.json", "mixed")
    return root, here
