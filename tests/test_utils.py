"""Utility-layer tests: roofline accounting, CSV sinks, timing helpers."""

import csv
import numpy as np

from spgemm_tpu.utils import csv_sink, roofline, timing


def test_roofline_numbers():
    rep = roofline.numeric_step_roofline(
        num_pairs=100, tm=16, tk=128, tn=128, nnz_cub=10_000,
        nt_c=80, chip=roofline.chip_spec("NVIDIA H100 80GB HBM3"),
        attained_ms=1.0,
    )
    assert rep.executed_flops > rep.useful_flops > 0
    assert rep.bytes_moved > 0
    assert rep.sol_time_ms > 0
    assert rep.efficiency is not None
    assert 0 < rep.efficiency <= 1.0
    assert "SoL" in rep.summary()


def test_roofline_unknown_device_raises():
    import pytest

    with pytest.raises(ValueError, match="no peak table entry"):
        roofline.chip_spec("cpu")


def test_csv_sink_appends(tmp_path):
    p = tmp_path / "out.csv"
    csv_sink.append_row(p, ["a", "b"], [1, 2])
    csv_sink.append_row(p, ["a", "b"], [3, 4])
    with open(p) as f:
        rows = list(csv.DictReader(f))
    assert rows == [{"a": "1", "b": "2"}, {"a": "3", "b": "4"}]


def test_step_timer():
    t = timing.StepTimer()
    with t.step("x"):
        pass
    with t.step("x"):
        pass
    assert t.ms["x"] >= 0
    assert t.total() == sum(t.ms.values())


def test_best_of():
    calls = []
    best, result = timing.best_of(lambda: calls.append(1) or 42, repeats=3)
    assert result == 42 and len(calls) == 3 and best >= 0


def test_device_trace_disabled(monkeypatch):
    monkeypatch.delenv("SPGEMM_TPU_TRACE", raising=False)
    with timing.device_trace():
        x = 1
    assert x == 1


def test_device_trace_enabled(monkeypatch, tmp_path):
    monkeypatch.setenv("SPGEMM_TPU_TRACE", str(tmp_path))
    with timing.device_trace("unit"):
        import jax.numpy as jnp
        jnp.zeros(4).block_until_ready()
    # a profile directory should have been produced
    assert any(tmp_path.iterdir())
