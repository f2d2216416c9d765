"""The port's contract checker (``repro_torch.analysis``) on the CPU.

* every rule of the step-region lint and of the kernel rules fires on a
  seeded snippet, and stays silent on the idiom it must allow;
* an unknown ``# analysis:`` pragma is a finding;
* ``run_checks()`` and ``python -m repro_torch.analysis --check`` are
  clean on the tree, and the CLI reports a seeded violation;
* the registry cross-check gives the JAX package's rule ids and messages
  on mirrored bad entries;
* the contract cases' device checks (guard zones, poisoned buffers,
  repeats) pass on the plain versions and catch a seeded fault;
* the build gate's rules on seeded ``cuobjdump`` rows.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro.analysis import check_registry as jax_check_registry
from repro.analysis.kernels import CONTRACTS as JAX_CONTRACTS
from repro.core.policy_registry import PolicyEntry as JaxPolicyEntry
from repro_torch.analysis import check_registry, lint_source, run_checks
from repro_torch.analysis import absint, kernels as K
from repro_torch.analysis.lint import RULES
from repro_torch.core.policy_registry import PolicyEntry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = "repro_torch/core/array_sim/policies.py"     # a step-region file
KERNEL = "repro_torch/kernels/fake.py"


def _rules(src, rel=STEP):
    return sorted({f.rule for f in lint_source(src, rel)})


# ------------------------------------------------------------- the lint --

FIRES = {
    "item": ("def f(x):\n    return x.sum().item()\n", "sync-coercion"),
    "tolist": ("def f(x):\n    return x.tolist()\n", "sync-coercion"),
    "cpu": ("def f(x):\n    return x.cpu()\n", "sync-coercion"),
    "numpy": ("def f(x):\n    return x.numpy()\n", "sync-coercion"),
    "float": ("def f(x):\n    return float(x[0])\n", "sync-coercion"),
    "int": ("def f(x):\n    return int(x.sum())\n", "sync-coercion"),
    "bool": ("def f(x):\n    return bool(x.any())\n", "sync-coercion"),
    "if": ("def f(x):\n    if x.any():\n        return 1\n    return 0\n",
           "sync-control-flow"),
    "while": ("def f(x):\n    while x.sum() > 0:\n        x = x - 1\n"
              "    return x\n", "sync-control-flow"),
    "and": ("def f(x, y):\n    return x and y\n", "sync-control-flow"),
    "not": ("def f(x):\n    return not x\n", "sync-control-flow"),
    "ifexp": ("def f(x):\n    return 1 if x.max() > 0 else 2\n",
              "sync-control-flow"),
    "assert": ("def f(x):\n    assert (x >= 0).all()\n    return x\n",
               "sync-control-flow"),
    "for": ("def f(x):\n    for v in x:\n        pass\n",
            "sync-control-flow"),
    "range": ("def f(n):\n    return [i for i in range(n.sum())]\n",
              "sync-control-flow"),
    "nonzero": ("def f(x):\n    return x.nonzero()\n", "sync-dynamic-shape"),
    "masked_select": ("def f(x, m):\n    return x.masked_select(m)\n",
                      "sync-dynamic-shape"),
    "unique": ("import torch\ndef f(x):\n    return torch.unique(x)\n",
               "sync-dynamic-shape"),
    "bincount": ("def f(x):\n    return x.bincount()\n",
                 "sync-dynamic-shape"),
    "bool_index": ("def f(x):\n    return x[x > 0]\n", "sync-dynamic-shape"),
    "host_call": ("import numpy as np\ndef f(x):\n    return np.asarray(x)\n",
                  "host-call"),
    "print": ("def f(x):\n    print('step')\n    return x\n", "step-print"),
    "collective": ("import torch.distributed as dist\n"
                   "def f(x, group):\n    dist.barrier(group=group)\n"
                   "    return x\n", "step-collective"),
    "host_tensor": ("import torch\ndef f(x):\n"
                    "    return x + torch.tensor([1, 2], device=x.device)\n",
                    "capture-host-copy"),
    "host_to_device": ("import torch\ndef f(x, dev):\n"
                       "    return x + torch.arange(4).to(dev)\n",
                       "capture-host-copy"),
    "first_use": ("import functools, torch\n"
                  "@functools.lru_cache(maxsize=None)\n"
                  "def g(n, device):\n"
                  "    return torch.tensor([1] * n, device=device)\n"
                  "def f(x):\n    return x + g(x.sum(), x.device)\n",
                  "capture-first-use"),
    "const_tolist": ("import torch\nC = torch.ones(3)\n"
                     "def f(x):\n    return C.tolist()\n",
                     "capture-host-read"),
    "pragma": ("def f(x):  # analysis: hosted\n    return x\n",
               "unknown-analysis-pragma"),
    "static_policy": ("def f(r):\n    return r(static_policy='lru')\n",
                      "deprecated-static-policy"),
    "int_policy": ("def f(r):\n    return r(policy=3)\n",
                   "deprecated-int-policy-id"),
    "time_passed": ("def f(s):\n    return s.time_passed\n",
                    "deprecated-time-passed"),
}


@pytest.mark.parametrize("case", sorted(FIRES))
def test_each_lint_rule_fires_on_a_seeded_snippet(case):
    src, rule = FIRES[case]
    assert rule in RULES
    assert _rules(src) == [rule], case


def test_every_lint_rule_is_seeded():
    assert {rule for _, rule in FIRES.values()} == set(RULES)


SILENT = {
    "metadata": "def f(x):\n    if x.dim() == 2 and x.shape[0] > 1:\n"
                "        return x.reshape(-1)\n    return x\n",
    "device": "def f(x):\n    if x.device.type == 'cpu':\n"
              "        return x\n    return x + 1\n",
    "static_param": "def f(x, n: int = 4):\n    for i in range(n):\n"
                    "        x = x + i\n    return int(n)\n",
    "is_tensor": "import torch\ndef f(x, k):\n    per = torch.is_tensor(k)\n"
                 "    return range(3 if per else int(k))\n",
    "list_of_tensors": "def f(x, y):\n    for t in [x, y]:\n        t.add_(1)\n",
    "is_none": "def f(x, m=None):\n    return x if m is None else x * m\n",
    "host_pragma": "def f(x):  # analysis: host -- a summary\n"
                   "    return x.tolist()\n",
    "obs_pragma": "def f(x):  # analysis: obs -- a debugging escape\n"
                  "    print(x.shape)\n    return x\n",
    "wants_grad": "def f(q):\n    if wants_grad(q):\n        return q\n"
                  "    return q * 2\n",
    "cached_factory": "import functools, torch\n"
                      "@functools.lru_cache(maxsize=None)\n"
                      "def g(n, device):\n"
                      "    return torch.tensor([1] * n, device=device)\n"
                      "def f(x):\n    return x + g(x.shape[0], x.device)\n",
    "step_data_as_tensor": "import torch\ndef f(x):\n"
                           "    return torch.as_tensor(x, device=x.device)\n",
    "dtype_cast": "import torch\ndef f(x):\n    return x.to(torch.int32)\n",
}


@pytest.mark.parametrize("case", sorted(SILENT))
def test_the_lint_allows_what_touches_no_device(case):
    assert _rules(SILENT[case]) == [], case


def test_host_files_are_not_step_regions():
    src = "def f(x):\n    return x.item()\n"
    assert _rules(src, "repro_torch/launch/train.py") == []
    assert _rules(src, "repro_torch/kernels/_build.py") == []
    assert _rules(src, KERNEL) == ["sync-coercion"]
    # sim.py: the nested functions of the step builder are the step
    sim = ("def make_step(spec):\n    n = float(spec.x)\n"
           "    def core(s):\n        return s.item()\n    return core\n")
    assert _rules(sim, "repro_torch/core/array_sim/sim.py") == [
        "sync-coercion"]


def test_a_planted_step_region_fails_the_capture_lint():
    """The step builder's nested functions are the region a runner
    captures: a host copy, a cached factory keyed on step data and a read
    back there are each flagged; the builder's own body is host code."""
    sim = ("import functools, torch\n"
           "@functools.lru_cache(maxsize=None)\n"
           "def _table(n, device):\n"
           "    return torch.arange(n, device=device)\n"
           "def make_step(spec, dev):\n"
           "    made = torch.tensor([1, 2], device=dev)\n"
           "    def core(state):\n"
           "        w = torch.tensor([3.0], device=dev)\n"
           "        t = _table(state.steps.max(), dev)\n"
           "        return state.t * w + made.tolist()[0] + t\n"
           "    return core\n")
    got = lint_source(sim, "repro_torch/core/array_sim/sim.py")
    assert sorted((f.rule, f.line) for f in got) == [
        ("capture-first-use", 9), ("capture-host-copy", 8),
        ("capture-host-read", 10)]


def test_the_tree_is_clean():
    assert run_checks() == []


def test_cli_check_is_clean_and_reports_a_seeded_violation(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ok = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                         "--check"], env=env, capture_output=True, text=True)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = tmp_path / "kernels"
    bad.mkdir()
    (bad / "bad_kernel.py").write_text("def k(x):\n    return float(x)\n")
    out = tmp_path / "findings.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check",
         "--no-registry", "--root", str(tmp_path), "--json", str(out)],
        env=env, capture_output=True, text=True)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "bad_kernel.py:2" in proc.stdout
    payload = json.loads(out.read_text())
    assert payload["count"] == 1
    assert payload["findings"][0]["rule"] == "sync-coercion"


# ----------------------------------------------------- the kernel rules --

REF = {"fifo_grant_ref", "gla_ref"}
KERNEL_FIRES = {
    "missing_oracle": ("def foo_kernel(x):\n    return x\n",
                       "kernel-missing-oracle"),
    "bad_pragma_oracle": ("def foo_kernel(x):  # analysis: oracle=nope\n"
                          "    return x\n", "kernel-missing-oracle"),
    "float_cast": ("def fifo_grant_kernel(key, sizes):\n"
                   "    return key.float() + sizes\n",
                   "kernel-float-mantissa-cast"),
    "to_f32": ("import torch\ndef fifo_grant_kernel(key):\n"
               "    return key.to(torch.float32)\n",
               "kernel-float-mantissa-cast"),
    "to_bf16_kw": ("import torch\ndef fifo_grant_kernel(keys):\n"
                   "    return keys.to(dtype=torch.bfloat16)\n",
                   "kernel-float-mantissa-cast"),
    "prefix": ("import torch\ndef fifo_grant_kernel(key, sizes):\n"
               "    return torch.cumsum(sizes, dim=1)\n",
               "kernel-prefix-dtype"),
    "prefix_method": ("def fifo_grant_kernel(key, nbytes):\n"
                      "    return nbytes.cumsum(1, dtype=key.dtype)\n",
                      "kernel-prefix-dtype"),
}


@pytest.mark.parametrize("case", sorted(KERNEL_FIRES))
def test_each_kernel_rule_fires_on_a_seeded_snippet(case):
    src, rule = KERNEL_FIRES[case]
    got = {f.rule for f in K.kernel_lint_source(src, KERNEL, REF)}
    assert rule in got, (case, got)


KERNEL_SILENT = {
    "named_oracle": "def fifo_grant_kernel(key):\n    return key\n",
    "pragma_oracle": "def mlstm_kernel(q):  # analysis: oracle=gla_ref\n"
                     "    return q\n",
    "dispatched_cast": "def fifo_grant_kernel(key):\n"
                       "    if key.dtype.is_floating_point:\n"
                       "        return key.float()\n    return key\n",
    "f64_prefix": "import torch\ndef fifo_grant_kernel(key, sizes):\n"
                  "    return torch.cumsum(sizes, 1, dtype=torch.float64)\n",
    "other_cast": "def fifo_grant_kernel(key, x):\n    return x.float()\n",
    "f64_cast": "def fifo_grant_kernel(key):\n    return key.double()\n",
}


@pytest.mark.parametrize("case", sorted(KERNEL_SILENT))
def test_the_kernel_rules_allow_the_sanctioned_idioms(case):
    assert K.kernel_lint_source(KERNEL_SILENT[case], KERNEL, REF) == []


def _kernel_tree(tmp_path, cu: str, py: str):
    k = tmp_path / "pkg" / "kernels"
    (k / "csrc").mkdir(parents=True)
    (k / "csrc" / "x.cu").write_text(cu)
    (k / "wrap.py").write_text(py)
    (k / "ref.py").write_text("def evict_page_sharded():\n    pass\n"
                              "def grant_page_sharded():\n    pass\n"
                              "def wake_solve_ref():\n    pass\n"
                              "def evict_rank_sharded():\n    pass\n"
                              "def grant_rank_sharded():\n    pass\n")
    return tmp_path / "pkg"


CU = ('extern "C" {\n'
      'int x_init(int* max_dyn) { return 0; }\n'
      'int x_run(const void* a, int n) { return 0; }\n'
      'int x_cap() { return 4; }\n'
      '}  // extern "C"\n')


def test_unbound_entries_are_findings(tmp_path):
    root = _kernel_tree(tmp_path, CU, "def f(lib):\n    return lib.x_gone()\n")
    got = K.lint_kernel_tree(root)
    msgs = sorted(f.message for f in got if f.rule == "kernel-unbound-entry")
    assert len(msgs) == 3, msgs            # x_init, x_run unbound; x_gone
    assert any("x_run takes a pointer" in m for m in msgs)
    assert any("`lib.x_gone`" in m for m in msgs)
    bound = ("import ctypes\ndef f(lib):\n"
             "    lib.x_init.argtypes = [ctypes.c_void_p]\n"
             "    lib.x_run.argtypes = [ctypes.c_void_p, ctypes.c_int]\n"
             "    return lib.x_run(0, 1) + lib.x_cap()\n")
    root = _kernel_tree(tmp_path / "b", CU, bound)
    assert K.lint_kernel_tree(root) == []
    via_bind = ("def library(device):\n"
                "    return _build.bind('x', ['x_run'], [], device)\n")
    root = _kernel_tree(tmp_path / "c", CU, via_bind)
    assert K.lint_kernel_tree(root) == []


def test_the_port_has_an_entry_for_every_extern_c_function():
    src = open(os.path.join(ROOT, "src/repro_torch/kernels/csrc/"
                            "pbm_timeline.cu")).read()
    entries = K.csrc_entries(src)
    assert entries["pbm_fifo_grant"] is True
    assert entries["pbm_head_cap"] is False


# ----------------------------------------------------------- registry ----

def _mirrored_entries():
    """The same bad entries for either package: (JAX table, port table)."""
    from repro.core.array_sim.policies import ArrayPolicy as JArray
    from repro.serving.policy_driver import ServingPolicy as JServing
    from repro_torch.core.array_sim.policies import ArrayPolicy as TArray
    from repro_torch.serving.policy_driver import ServingPolicy as TServing

    def tables(Entry, Array, Serving):
        class Hollow(Serving):
            name = "bogus"

        class Mislabeled(Array):
            name = "other"

            def score_victims(self, state, ctx):
                return state

        class NoOverride(Array):
            name = "bogus"

        return {
            "hollow_serving": {"bogus": Entry(
                name="bogus", summary="claims serving, does not",
                serving_factory=Hollow)},
            "mislabeled_array": {"bogus": Entry(
                name="bogus", summary="name mismatch",
                array_factory=Mislabeled, array_id=99)},
            "array_without_score": {"bogus": Entry(
                name="bogus", summary="no score_victims",
                array_factory=NoOverride, array_id=98)},
            "array_without_id": {"bogus": Entry(
                name="bogus", summary="no id", array_factory=Mislabeled)},
            "cooperative_without_event": {"bogus": Entry(
                name="bogus", summary="coop", cooperative=True,
                array_factory=Mislabeled, array_id=97)},
        }

    return (tables(JaxPolicyEntry, JArray, JServing),
            tables(PolicyEntry, TArray, TServing))


def test_the_registry_is_coherent():
    assert check_registry() == []


@pytest.mark.parametrize("case", ["hollow_serving", "mislabeled_array",
                                  "array_without_score", "array_without_id",
                                  "cooperative_without_event"])
def test_registry_cross_check_matches_the_jax_package(case):
    jax_tables, torch_tables = _mirrored_entries()
    want = jax_check_registry(jax_tables[case])
    got = check_registry(torch_tables[case])
    assert want, case
    assert [f.rule for f in got] == [f.rule for f in want]
    assert [f.message for f in got] == [f.message for f in want]


# --------------------------------------------------- the contract cases --

def test_contracts_keep_the_jax_points_and_add_the_ports_paths():
    names = [c.name for c in K.CONTRACTS]
    assert [c.name.replace("_chunked", "") for c in JAX_CONTRACTS] == [
        n.replace("_chunked", "") for n in names[:len(JAX_CONTRACTS)]]
    assert {"batched_evict[split]", "fifo_grant[split]", "wake_solve[split]",
            "flash_attention[bf16]", "paged_attention[bf16]",
            "mamba2_scan[bf16]", "mlstm_chunked[bf16]"} <= set(names)
    assert {c.kernel for c in K.CONTRACTS} == {
        "batched_evict", "fifo_grant", "wake_solve", "paged_attention",
        "flash_attention", "mamba2_scan", "mlstm_chunked"}


def test_device_checks_pass_on_the_plain_versions():
    rows, findings = absint.device_checks(device="cpu")
    assert findings == []
    assert len(rows) == len(K.CONTRACTS)
    assert all(r["guarded_buffers"] >= 2 for r in rows)


def test_device_checks_catch_a_seeded_fault(monkeypatch):
    from repro_torch.kernels import ops
    plain = ops.fifo_grant

    def unwritten(key, sizes, budget, pops, **kw):
        mask, nbytes, n = plain(key, sizes, budget, pops, **kw)
        out = torch.empty_like(nbytes)          # poisoned by the check
        out[1:] = nbytes[1:]                    # lane 0 never written
        return mask, out, n

    monkeypatch.setattr(ops, "fifo_grant", unwritten)
    rows, findings = absint.device_checks(names=["fifo_grant"], device="cpu")
    assert rows[0]["pattern_differs"] > 0 and rows[0]["mismatches"] > 0
    assert {f.rule for f in findings} >= {"kernel-coverage",
                                          "kernel-contract-mismatch"}

    def overrun(key, sizes, budget, pops, **kw):
        mask, nbytes, n = plain(key, sizes, budget, pops, **kw)
        out = torch.empty_like(nbytes)
        out.copy_(nbytes)
        if out.untyped_storage().nbytes() > out.nbytes:   # a guarded buffer
            torch.as_strided(out, (out.numel() + 1,), (1,))[-1] = 7.0
        return mask, out, n

    monkeypatch.setattr(ops, "fifo_grant", overrun)
    rows, findings = absint.device_checks(names=["fifo_grant"], device="cpu")
    assert rows[0]["guard_writes"] > 0
    assert "kernel-bounds" in {f.rule for f in findings}


def test_the_card_checks_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        absint.contracts_on_card()


# ----------------------------------------------------------- build gate --

def _usage(stack=0):
    rows = {lib: [{"kernel": f"{lib}_k", "stack_bytes": stack,
                   "local_bytes": 0}] for lib in K.SASS_REQUIRED}
    rows["pbm_timeline"] = [{"kernel": k, "stack_bytes": 0, "local_bytes": 0}
                            for k, n in K.NO_LOCAL_KERNELS["pbm_timeline"]
                            .items() for _ in range(n)]
    rows["mlstm"] += [{"kernel": k, "stack_bytes": 0, "local_bytes": 0}
                      for k, n in K.NO_LOCAL_KERNELS["mlstm"].items()
                      for _ in range(n)]
    return rows


def _sass():
    return {"flash_attention": {"HGMMA": 1, "UTMALDG": 1, "HMMA.TF32": 1},
            "paged_attention": {"LDGSTS": 1}, "mamba2_scan": {"HMMA": 1},
            "mlstm": {"HMMA": 1}, "pbm_timeline": {}}


def test_the_build_gate():
    assert K.build_evidence_ok(_usage(), _sass()) == (True, "")
    sass = _sass()
    sass["pbm_timeline"]["HMMA"] = 3
    assert K.build_evidence_ok(_usage(), sass) == (
        False, "pbm_timeline: HMMA in its SASS")
    ok, why = K.build_evidence_ok(_usage(stack=16), _sass())
    assert not ok and "uses local memory" in why
    sass = _sass()
    del sass["flash_attention"]["UTMALDG"]
    assert K.build_evidence_ok(_usage(), sass)[0] is False
    sass = _sass()
    del sass["flash_attention"]["HMMA.TF32"]
    assert K.build_evidence_ok(_usage(), sass) == (
        False, "flash_attention: no HMMA.TF32 in its SASS")


def test_sass_counts_tell_tf32_warp_mma_apart(monkeypatch):
    """``HMMA.TF32`` counts the warp MMAs on TF32 operands (the f32 arm of
    flash attention), ``HMMA`` every warp MMA, predicated ones too."""
    sass = """
        /*0a20*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0a30*/  HMMA.16816.F32.BF16 R20, R24, R28, R20 ;
        /*0a40*/  @P0 HMMA.1688.F32.TF32 R4, R8, R14, R4 ;
        /*0a50*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0a60*/  UTMALDG.4D [UR8], [UR4] ;
    """
    monkeypatch.setattr(K, "_cuobjdump", lambda flag, name: sass)
    counts = K.sass_counts("flash_attention")
    assert counts["HMMA"] == 3 and counts["HMMA.TF32"] == 2
    assert counts["HGMMA"] == 1 and counts["UTMALDG"] == 1
