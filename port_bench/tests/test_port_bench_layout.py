"""``BENCHMARK.json`` against the contract it is written to, and a cell, a
traffic mix and a metric added as new files and entries alone."""

from __future__ import annotations

import json
import re
import time

from conftest import BENCH, DATA, REPO, add_cell

from portbench import cells, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_follows_the_contract():
    raw = (REPO / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == KEYS
    assert b["paths"] == ["port_bench"] and b["command"][1] == "port_bench/run.py"
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("port_bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        names.add(c["name"])
    used, pairs = set(), set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        for n in ("tuples_err", "io_err"):
            assert limits[n]["limit"] >= 0 and limits[n]["set_from"]
    assert used == names
    cells_ = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells_)) <= cells_
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_cell_added_as_files_alone_is_found(checkout):
    """A new configuration, traffic mix, cell, limits file and metric:
    only files and entries are added, and a run reads the new metric."""
    root, here = checkout
    (here / "traffic" / "pair.json").write_text(json.dumps({
        "policies": ["lru", "pbm"], "fractions": [0.2, 0.4],
        "stepper": "horizon", "prefix_loads": 1.0, "short_sim_s": 0.02}))
    (here / "metrics" / "lanes_per_sweep.py").write_text(
        "def read(run):\n    return float(run.lanes)\n")
    add_cell(root, here, "micro_tiny.pair", DATA / "micro_tiny.json", "pair")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "lanes_per_sweep", "unit": "lanes", "better": "higher",
        "source": "program_counter", "layer": "loop nest",
        "moves": "lane_sim_s_per_s", "workloads": ["micro_tiny.pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load(root, "micro_tiny.pair", here)
    assert cell.traffic["policies"] == ["lru", "pbm"]
    assert cell.config["n_tuples"] == 8_000_000
    assert "lanes_per_sweep" in {m["name"] for m in cell.per_layer}
    out = harness.execute(root, "micro_tiny.pair", 5, 0.1, True, time.time(),
                          device="cpu", here=here)
    assert out["metrics"]["lanes_per_sweep"] == {"value": 4.0, "unit": "lanes"}
    assert out["attempted"] == 4
    # a metric that lists other cells is not read in this one
    assert "lanes_per_sweep" not in {
        m["name"] for m in cells.load(root, "micro_quarter.mixed", here).per_layer}
