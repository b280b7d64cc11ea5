"""The per-layer readers over profiler tables: one recorded on the card
(a traced window of DeepLab v3+ serving NAIP regions one at a time,
trimmed to its first requests) and small tables written out by hand."""

import gzip
import json

import pytest

from conftest import REPO
from perfbench import manifest, tracing

RECORDED = REPO / "perfbench" / "tests" / "data" / "naip_trace.json.gz"
READERS = {p.stem: manifest.load_module(p, f"reader_{p.stem}")
           for p in sorted((REPO / "perfbench" / "layer_metrics").glob("*.py"))}


@pytest.fixture(scope="module")
def recorded():
    with gzip.open(RECORDED, "rt") as f:
        return json.load(f)


def test_recorded_table_reads(recorded):
    data = recorded["layer"]
    mfu = READERS["mfu.serve"].read(recorded, data)
    roof = READERS["hann_stitch_roofline"].read(recorded, data)
    idle = READERS["idle_share.serve"].read(recorded, data)
    assert 0 < mfu < 100 and 0 < roof <= 105 and 0 < idle < 100
    count, seconds = tracing.kernel_time(recorded, "hann_stitch_kernel")
    assert count == data["kernels"]["hann_stitch"]["calls"] > 0
    # the training readers find nothing to read in a serving window
    for name in ("mfu.train", "fused_preprocess_roofline", "idle_share.train",
                 "input_wait_ms.train"):
        assert READERS[name].read(recorded, data) is None
    out = tracing.breakdown(recorded)
    assert len(out["device_ops"]) == 10 and 0 < len(out["idle_gaps"]) <= 10
    every = tracing.breakdown(recorded, top=10**6)["idle_gaps"]
    assert sum(s for _, s in every) == pytest.approx(
        tracing.window_s(recorded) - tracing.busy_s(recorded))


def test_a_dropped_event_is_no_reading(recorded):
    data = json.loads(json.dumps(recorded["layer"]))
    data["kernels"]["hann_stitch"]["calls"] += 1
    assert READERS["hann_stitch_roofline"].read(recorded, data) is None
    data["device_name"] = "a card not in the table"
    assert READERS["mfu.serve"].read(recorded, data) is None


def _table():
    ev = [["host", tracing.WINDOW, 0.0, 1000.0, 1],
          ["host", "perfbench.step", 0.0, 900.0, 1],
          ["host", "aten::conv", 10.0, 20.0, 1],
          ["kernel", "fused_preprocess_kernel<2>", 100.0, 50.0, 0],
          ["kernel", "conv_kernel", 120.0, 300.0, 0],
          ["memcpy", "Memcpy HtoD", 600.0, 100.0, 0],
          ["kernel", "fused_preprocess_kernel<2>", 800.0, 50.0, 0]]
    return {"window_us": 1000.0, "events": ev}


def test_hand_table_reads():
    table = _table()
    data = {"device_name": "NVIDIA H100 80GB HBM3", "step_flops": 2 * 989e12 * 1e-3 / 10,
            "kernels": {"fused_preprocess": {"calls": 2, "least_s": 50e-6}},
            "input_wait_s": [0.001, 0.003]}
    assert tracing.busy_s(table) == pytest.approx(470e-6)  # kernels 100..420, 800..850; copy
    assert READERS["idle_share.train"].read(table, data) == pytest.approx(100 * (1 - 0.37))
    assert READERS["mfu.train"].read(table, data) == pytest.approx(20.0)
    assert READERS["fused_preprocess_roofline"].read(table, data) == pytest.approx(50.0)
    assert READERS["input_wait_ms.train"].read(table, data) == pytest.approx(2.0)
    assert READERS["mfu.serve"].read(table, data) is None
    gaps = dict(tracing.breakdown(table)["idle_gaps"])
    assert gaps == pytest.approx({"perfbench.step": 380e-6, "host: outside any op": 150e-6})
