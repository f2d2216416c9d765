"""The port's cross-validation harness (``array_sim.validate``): its bars
are the JAX package's, value for value; a calibrated point of the port's
array runner on the CPU sits inside its bar of the port's own event
engine; a truncated array run is refused, not compared."""

import pytest

jax = pytest.importorskip("jax")

from repro.core.array_sim import validate as JV  # noqa: E402
from repro_torch.core.array_sim import validate as TV  # noqa: E402


def test_error_bars_are_the_jax_packages_values():
    assert TV.ERROR_BARS == JV.ERROR_BARS
    assert TV.TPCH_ERROR_BARS == JV.TPCH_ERROR_BARS
    assert TV.DEFAULT_FRACS == JV.DEFAULT_FRACS
    assert TV.TPCH_DEFAULTS == JV.TPCH_DEFAULTS
    assert TV.DEFAULT_POLICIES == JV.DEFAULT_POLICIES


def test_cscan_micro_point_within_bars():
    """The port's counterpart of the JAX package's enforced micro point
    for the cooperative substrate (frac 0.2, scale 0.25, the fixed
    stepper), on the CPU: the array run is held to the port's event
    engine within ``ERROR_BARS[(0.2, "cscan")]``."""
    rows = TV.cross_validate_sweep(fracs=(0.2,), scale=0.25,
                                   policies=("cscan",), device="cpu")
    (r,) = rows
    assert r["stepper"] == "fixed" and not r["truncated"]
    bar = TV.ERROR_BARS[(0.2, "cscan")]
    assert abs(r["stream_time_rel_err"]) <= bar, r
    assert abs(r["io_rel_err"]) <= bar, r
    assert TV.bar_of(r) == bar and TV.worst_error(r) <= bar


def test_truncated_runs_raise_in_cross_validate(monkeypatch):
    real = TV.run_workload_array

    def forced_truncation(*args, **kw):
        kw["max_time"] = 1e-3
        return real(*args, **kw)

    monkeypatch.setattr(TV, "run_workload_array", forced_truncation)
    with pytest.raises(RuntimeError, match="truncated by the livelock"):
        TV.cross_validate(scale=0.02, n_streams=2, queries_per_stream=2,
                          buffer_frac=0.4, policies=("lru",), device="cpu")


def test_rows_render_and_fail_outside_their_bar(capsys):
    rows = TV.cross_validate(scale=0.02, n_streams=2, queries_per_stream=2,
                             buffer_frac=0.4, policies=("lru", "cscan"),
                             stepper="horizon", device="cpu")
    assert [r["policy"] for r in rows] == ["lru", "cscan"]
    assert all(r["stepper"] == "horizon" for r in rows)
    off = dict(rows[0], stream_time_rel_err=0.5)
    assert TV._print_rows([off]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert TV._print_rows([off], enforce=False) == 0
    assert "ERROR_BARS = {" in TV.fit_bars_literal([off])
