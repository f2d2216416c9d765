"""The port's workload compiler against the JAX package's: the same
``(db, streams)`` must lower to a ``SimSpec`` whose every field is equal.
The two packages keep separate copies of the storage model, the workload
generators and the compiler; this is what keeps them one lowering."""

import numpy as np
import pytest

from repro.core import workload as jw
from repro.core.array_sim import compiler as jcomp
from repro.core.scans import ScanSpec as JScan
from repro_torch.core import workload as tw
from repro_torch.core.array_sim import build_spec, compile_workload
from repro_torch.core.scans import ScanSpec as TScan


def _assert_specs_equal(got, want):
    assert got._fields == want._fields
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("scale,streams,queries,seed", [
    (0.02, 3, 3, 3), (0.05, 4, 4, 42), (0.25, 8, 16, 3)])
def test_micro_spec_equals_jax_package(scale, streams, queries, seed):
    n = int(180_000_000 * scale)
    jdb, tdb = jw.make_lineitem_db(scale_tuples=n), tw.make_lineitem_db(scale_tuples=n)
    js = jw.micro_streams(jdb, streams, queries, seed=seed)
    ts = tw.micro_streams(tdb, streams, queries, seed=seed)
    assert jw.micro_accessed_bytes(jdb) == tw.micro_accessed_bytes(tdb)
    want = jcomp.compile_workload(jdb, js)
    _assert_specs_equal(compile_workload(tdb, ts), want)
    _assert_specs_equal(build_spec(tdb, ts), want)
    assert (compile_workload(tdb, ts).trigger_window(0.004, tight=True)
            == want.trigger_window(0.004, tight=True))


def test_two_table_spec_equals_jax_package():
    def make(mod, scan):
        db = mod.make_tpch_db(scale=0.01)
        streams = [
            [scan("lineitem", ("l_c0", "l_c1"), ((100, 900_000),), 60e6, 0),
             scan("orders", ("o_c0", "o_c3"), ((0, 400_000),), 70e6, 0)],
            [scan("orders", ("o_c1",), ((50_000, 300_000),), 50e6, 1)],
        ]
        return db, streams
    jdb, js = make(jw, JScan)
    tdb, ts = make(tw, TScan)
    want = jcomp.compile_workload(jdb, js)
    got = compile_workload(tdb, ts)
    assert got.n_tables == 2 and got.table_names == ("lineitem", "orders")
    _assert_specs_equal(got, want)


def test_tpch_generators_equal_jax_package():
    jdb, tdb = jw.make_tpch_db(scale=0.02), tw.make_tpch_db(scale=0.02)
    js, ts = jw.tpch_streams(jdb, 3, seed=7), tw.tpch_streams(tdb, 3, seed=7)
    assert jw.tpch_accessed_bytes(jdb, js) == tw.tpch_accessed_bytes(tdb, ts)
    _assert_specs_equal(compile_workload(tdb, ts),
                        jcomp.compile_workload(jdb, js))


def test_single_table_entry_point_refuses_two_tables():
    db = tw.make_tpch_db(scale=0.01)
    streams = [[TScan("lineitem", ("l_c0",), ((0, 1000),)),
                TScan("orders", ("o_c0",), ((0, 1000),))]]
    with pytest.raises(ValueError, match="single table"):
        build_spec(db, streams)
    with pytest.raises(ValueError, match="unknown tables"):
        compile_workload(db, [[TScan("nope", ("x",), ((0, 1),))]])
