"""Nothing the harness loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch`` is the port), and
the reference (plain PyTorch) loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import BENCH, DATA

from portbench import harness


def _child(code: str, cwd=None) -> dict:
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=cwd, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module(checkout):
    root, here = checkout
    out = _child(f"""
        import json, sys, time
        from pathlib import Path
        sys.path.insert(0, {str(BENCH)!r})
        sys.path.insert(0, {str(BENCH / 'tests')!r})
        from conftest import add_cell
        from portbench import harness
        if __name__ == "__main__":
            root, here = Path({str(root)!r}), Path({str(here)!r})
            add_cell(root, here, "micro_tiny.mixed", Path({str(DATA / 'micro_tiny.json')!r}), "mixed")
            harness.execute(root, "micro_tiny.mixed", 11, 0.1, False, time.time(),
                            device="cpu", here=here)
            print(json.dumps({{"bad": harness.forbidden_modules(),
                               "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
        """)
    assert out["bad"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["top"])
    assert "repro_torch" in out["top"]


def test_the_reference_loads_nothing_of_the_program():
    out = _child(f"""
        import json, sys
        sys.path.insert(0, {str(BENCH)!r})
        import portbench.check, portbench.reference, portbench.roofline
        import portbench.workloads, portbench.cells
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """)
    assert "torch" in out
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & set(out)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]
