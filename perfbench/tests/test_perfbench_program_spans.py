"""The readers of the program's own spans (``perfbench.program_spans``):
hand-written tables and span logs, the recorded table (no program spans in
it), and a program older than the span log."""

import gzip
import json

import pytest

from conftest import REPO
from perfbench import manifest, program_spans, tracing
from satellite_computervision_tpu_torch.utils import profiling
from satellite_computervision_tpu_torch.utils.profiling import SpanRecord

RECORDED = REPO / "perfbench" / "tests" / "data" / "naip_trace.json.gz"
NEW = ("stage_ms.serve", "readback_ms.serve", "idle_stage_wait_share.serve",
       "idle_dispatch_share.serve", "input_stage_ms.train", "batch_wait_ms.train",
       "idle_input_share.train", "idle_dispatch_share.train")
READERS = {name: manifest.load_module(REPO / "perfbench" / "layer_metrics" / f"{name}.py",
                                      f"span_reader_{name}") for name in NEW}
IDLE_SHARE = manifest.load_module(REPO / "perfbench" / "layer_metrics" / "idle_share.serve.py",
                                  "span_reader_idle_share")
T0 = 1_800_000_000_000_000_000  # the log's clock: Unix-epoch nanoseconds
LAG_US = 20.0  # a logged stamp lands after the profiler's event starts
MAIN, WORKER = 101, 102


def _log(rows):
    """(name, thread, start_us, end_us, attrs) on the table's clock -> the
    program's log, stamped on its own clock and late by ``LAG_US``."""
    return [SpanRecord(i, name, tid, T0 + int((s + LAG_US) * 1e3), T0 + int(e * 1e3), None,
                       attrs) for i, (name, tid, s, e, attrs) in enumerate(rows)]


def _table(host, kernels, window=1000.0):
    ev = [["host", tracing.WINDOW, 0.0, window, 1]]
    ev += [["host", n, s, e - s, 1] for n, tid, s, e, _ in host if tid == MAIN]
    ev += [["kernel", "k", s, e - s, 0] for s, e in kernels]
    return {"window_us": window, "events": ev}


@pytest.fixture
def logged(monkeypatch):
    """Install ``rows`` as the program's span log."""
    def install(rows):
        log = _log(rows)
        monkeypatch.setattr(profiling, "span_log", lambda: list(log))
        return log
    return install


def test_training_shares_split_the_idle_time(logged):
    rows = [("train.batch", WORKER, 10.0, 60.0, {"batch": 0}),
            ("train.stage", WORKER, 60.0, 90.0, {"batch": 0, "bytes": 64}),
            ("train.batch_wait", MAIN, 100.0, 300.0, {"batch": 0}),
            ("train.preprocess", MAIN, 300.0, 400.0, {}),
            ("train.step", MAIN, 400.0, 900.0, {"step": 0}),
            ("train.forward", MAIN, 410.0, 600.0, {}),
            ("train.batch", WORKER, 320.0, 360.0, {"batch": 1}),
            ("train.stage", WORKER, 360.0, 400.0, {"batch": 1, "bytes": 64}),
            ("train.batch_wait", MAIN, 900.0, 950.0, {"batch": 1})]
    logged(rows)
    # idle: 0..350, 500..600, 800..1000
    table = _table(rows, [(350.0, 500.0), (600.0, 800.0)])
    idle = READERS["idle_input_share.train"].read(table, {})
    dispatch = READERS["idle_dispatch_share.train"].read(table, {})
    # aligned on their starts, the logged spans end LAG_US early: in
    # batch_wait 100..280 and 900..930 of the idle time; in preprocess or
    # step 300..350, 500..600 and 800..880
    assert idle == pytest.approx(21.0, abs=1e-6)
    assert dispatch == pytest.approx(23.0, abs=1e-6)
    assert idle + dispatch <= 100 * (1 - tracing.busy_s(table, ("kernel",)) / 1e-3)
    # host times per batch and per step: the logged spans' own lengths
    assert READERS["input_stage_ms.train"].read(table, {}) == pytest.approx(
        ((30 + 10) + (20 + 20)) / 2 / 1e3, abs=1e-9)
    assert READERS["batch_wait_ms.train"].read(table, {}) == pytest.approx(
        (180 + 30) / 2 / 1e3, abs=1e-9)
    for name in NEW:
        if name.endswith(".serve"):
            assert READERS[name].read(table, {}) is None


def test_serving_shares_and_host_times(logged):
    rows = [("serve.host_scene", 201, 0.0, 100.0, {"scene": 0}),
            ("serve.stage", 201, 100.0, 250.0, {"scene": 0, "bytes": 8}),
            ("serve.stage_wait", WORKER, 0.0, 260.0, {"scene": 0}),
            ("serve.scene", WORKER, 260.0, 700.0, {"scene": 0}),
            ("serve.readback", WORKER, 700.0, 760.0, {"scene": 0, "bytes": 4}),
            ("serve.stage_wait", WORKER, 760.0, 800.0, {"scene": 1}),
            ("serve.host_scene", 201, 300.0, 350.0, {"scene": 1}),  # staged after the window
            ("serve.result_wait", MAIN, 0.0, 780.0, {"scene": 0}),
            ("serve.result_wait", MAIN, 800.0, 1000.0, {"scene": 1})]
    logged(rows)
    table = _table(rows, [(300.0, 650.0), (720.0, 740.0)])
    # idle: 0..300, 650..720, 740..1000; stage_wait 0..240 (the fill, before
    # the first scene ends at 680) and 760..780 of it; scene and readback
    # 260..300, 650..680 and 700..720
    assert READERS["idle_stage_wait_share.serve"].read(table, {}) == pytest.approx(2.0, abs=1e-6)
    assert program_spans.idle_share(table, ("serve.stage_wait",)) == pytest.approx(26.0, abs=1e-6)
    assert READERS["idle_dispatch_share.serve"].read(table, {}) == pytest.approx(9.0, abs=1e-6)
    # scene 1 has no serve.stage: only scene 0 is whole
    assert READERS["stage_ms.serve"].read(table, {}) == pytest.approx((80 + 130) / 1e3, abs=1e-9)
    assert READERS["readback_ms.serve"].read(table, {}) == pytest.approx(40 / 1e3, abs=1e-9)
    for name in NEW:
        if name.endswith(".train"):
            assert READERS[name].read(table, {}) is None


def test_the_stage_wait_share_needs_a_scene_ended_in_the_window(logged):
    rows = [("serve.stage_wait", WORKER, 0.0, 260.0, {"scene": 0}),
            ("serve.scene", WORKER, 260.0, 1200.0, {"scene": 0}),
            ("serve.result_wait", MAIN, 0.0, 1200.0, {"scene": 0})]
    logged(rows)
    table = _table(rows, [(300.0, 650.0)])
    # only the fill's wait, before any scene ended: nothing to read
    assert READERS["idle_stage_wait_share.serve"].read(table, {}) is None
    assert program_spans.idle_share(table, ("serve.stage_wait",)) == pytest.approx(24.0, abs=1e-6)


def test_the_alignment_takes_the_clocks_own_offset(logged):
    rows = [("train.step", MAIN, 100.0 * i, 100.0 * i + 80.0, {"step": i}) for i in range(10)]
    logged(rows)
    found = program_spans.spans(_table(rows, []))
    assert [round(s, 6) for _, s, _, _ in found] == [100.0 * i for i in range(10)]


def test_recorded_table_has_no_program_spans(logged):
    with gzip.open(RECORDED, "rt") as f:
        recorded = json.load(f)
    data = recorded["layer"]
    logged([])  # an empty log
    assert all(READERS[name].read(recorded, data) is None for name in NEW)
    # a log of another session: its spans are no host events of this table
    logged([("serve.result_wait", MAIN, 0.0, 500.0, {"scene": 0}),
            ("serve.scene", WORKER, 0.0, 400.0, {"scene": 0}),
            ("serve.stage_wait", WORKER, 400.0, 600.0, {"scene": 1})])
    assert all(READERS[name].read(recorded, data) is None for name in NEW)
    # the recorded table reads as it did
    assert 0 < IDLE_SHARE.read(recorded, data) < 100


def test_a_program_without_the_span_log_reads_nothing(monkeypatch):
    rows = [("train.step", MAIN, 0.0, 500.0, {"step": 0})]
    table = _table(rows, [(100.0, 200.0)])
    monkeypatch.delattr(profiling, "span_log")
    assert all(READERS[name].read(table, {}) is None for name in NEW)


@pytest.mark.parametrize("a,b,expected", [
    ([(0, 10)], [(5, 20)], 5.0),
    ([(0, 10), (20, 30)], [(5, 25)], 10.0),
    ([(0, 100)], [(10, 20), (30, 40), (90, 120)], 30.0),
    ([(0, 10)], [(10, 20)], 0.0),
])
def test_overlap_of_interval_sets(a, b, expected):
    import numpy as np

    assert program_spans.overlap_us(np.array(a, float), np.array(b, float)) == expected


def test_union_merges_overlaps():
    import numpy as np

    got = program_spans.union(np.array([(5, 8), (0, 3), (2, 4), (7, 9), (20, 21)], float))
    assert got.tolist() == [[0, 4], [5, 9], [20, 21]]
