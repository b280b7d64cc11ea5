"""The program's own spans (``utils.profiling.span``): free without a
profiler; under one, logged on every thread of the serving engine and the
training input with their parents and scene or batch ids, on the
profiler's clock, and written into ``trace``'s Chrome trace.

The file imports no JAX; its card test runs on a GPU host with

    python -m pytest --noconftest tests/test_torch_spans.py -q -m cuda
"""

import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from satellite_computervision_tpu_torch.data.pipeline import TrainIterator, make_preprocess_fn
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step
from satellite_computervision_tpu_torch.utils import profiling
from satellite_computervision_tpu_torch.utils.profiling import span, span_log, span_offset_ns

SERVE_STAGING = {"serve.host_scene", "serve.stage"}
SERVE_DISPATCH = {"serve.stage_wait", "serve.scene", "serve.input", "serve.forward",
                  "serve.stitch", "serve.readback"}


def _session(fn=lambda: None, activities=(ProfilerActivity.CPU,)):
    """Run ``fn`` under a profiler; (its result, the profiler)."""
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof


def _host_events(prof):
    """(name, start_ns) of the profiler's host events, on its own clock."""
    return [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CPU")]


def _engine():
    return TiledInferenceEngine(lambda x: torch.sigmoid(x[..., :1]), kernel=16, buffer=8,
                                batch_size=4, blend="hann", device="cpu")


def _scenes(n=3):
    rng = np.random.default_rng(0)
    return [rng.random((40, 50, 3), dtype=np.float32) for _ in range(n)]


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 1, 1)

    def forward(self, x):
        logits = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return {"logits": logits, "classes": (logits[..., 0] > 0).long()}


class _Chips:
    feature_names = ["r", "g", "b", "y"]

    def __iter__(self):
        rng = np.random.default_rng(1)
        for _ in range(6):
            chip = {b: rng.random((8, 8), dtype=np.float32) for b in "rgb"}
            yield dict(chip, y=(rng.random((8, 8)) > 0.5).astype(np.float32))


def _train_two_steps():
    preprocess = make_preprocess_fn(["r", "g", "b"], "y", axes=(0, 1), device="cpu")
    state = create_train_state(_Tiny(), 1e-3)
    step = make_train_step(
        lambda y, p: torch.nn.functional.binary_cross_entropy_with_logits(p, y))
    gen = torch.Generator().manual_seed(0)
    stream = iter(TrainIterator(_Chips(), batch_size=2, shuffle_buffer=1, repeat=False,
                                prefetch=1, device="cpu"))
    for _ in range(2):
        x, y = preprocess(next(stream), gen, train=True)
        step(state, (x, y))
    return list(stream)  # the last batch, then the worker's end


def test_without_a_profiler_a_span_is_one_shared_no_op():
    _session()  # a session with no span leaves an empty log
    assert span_log() == []
    first = span("serve.scene", scene=0)
    for i in range(10**4):
        with span("train.step", step=i) as s:
            assert s is first
    assert span_log() == []
    assert not profiling._autograd_profiler._is_profiler_enabled


def test_serving_spans_on_every_thread():
    outs, _ = _session(lambda: list(_engine().predict_scenes(iter(_scenes()), prefetch=2,
                                                             readback=True)))
    assert len(outs) == 3
    log, main = span_log(), threading.get_native_id()
    by_name = {}
    for s in log:
        by_name.setdefault(s.name, []).append(s)
    assert SERVE_STAGING | SERVE_DISPATCH | {"serve.result_wait"} <= set(by_name)
    threads = {name: {s.thread for s in spans} for name, spans in by_name.items()}
    staging = set.union(*(threads[n] for n in SERVE_STAGING))
    dispatch = set.union(*(threads[n] for n in SERVE_DISPATCH))
    assert len(staging) == 1 and len(dispatch) == 1 and staging != dispatch
    assert main not in staging | dispatch and threads["serve.result_wait"] == {main}
    ids = {s.id: s for s in log}
    for s in log:
        if s.name in ("serve.input", "serve.forward", "serve.stitch"):
            assert ids[s.parent].name == "serve.scene"
            assert ids[s.parent].attrs["scene"] == s.attrs["scene"]
            assert ids[s.parent].thread == s.thread
        elif s.name in ("serve.scene", "serve.stage", "serve.result_wait"):
            assert s.parent is None
        assert s.start_ns <= s.end_ns
    for n in range(3):  # every stage of scene n carries its sequence number
        names = {s.name for s in log if s.attrs.get("scene") == n}
        assert SERVE_STAGING | SERVE_DISPATCH | {"serve.result_wait"} <= names
    forwards = [s.attrs for s in by_name["serve.forward"] if s.attrs["scene"] == 0]
    assert sum(a["chips"] for a in forwards) == 3 * 4  # the 3 x 4 grid of a 40 x 50 scene
    assert all(a["chips"] + a["padded"] == 4 for a in forwards)
    assert {s.attrs["bytes"] for s in by_name["serve.stage"]} == {40 * 50 * 3 * 4}


def test_training_spans_carry_batch_ids_and_parents():
    _, prof = _session(_train_two_steps)
    log, main = span_log(), threading.get_native_id()
    ids = {s.id: s for s in log}
    of = lambda name: [s for s in log if s.name == name]  # noqa: E731
    worker = {s.thread for s in of("train.batch") + of("train.stage")}
    assert len(worker) == 1 and main not in worker
    assert [s.attrs["batch"] for s in of("train.batch_wait")][:2] == [0, 1]
    assert all(s.thread == main for n in ("train.batch_wait", "train.preprocess", "train.step")
               for s in of(n))
    assert len(of("train.step")) == len(of("train.preprocess")) == 2
    for n in range(2):  # the worker's batch n is the consumer's batch n
        names = {s.name for s in log if s.attrs.get("batch") == n}
        assert {"train.batch", "train.stage", "train.batch_wait"} <= names
    assert all(s.attrs["bytes"] == 2 * 4 * 8 * 8 * 4 for s in of("train.stage"))
    assert [s.attrs["step"] for s in of("train.step")] == [0, 1]
    for name in ("train.forward", "train.backward", "train.optimizer", "train.metrics"):
        assert of(name) and all(ids[s.parent].name == "train.step" for s in of(name))
    assert len(of("train.optimizer")) == 4  # zero_grad, then the update, each step
    # the same spans of the main thread are the profiler's host events
    offset = span_offset_ns(_host_events(prof))
    assert offset is not None and abs(offset) < 100_000


def test_logged_stamps_agree_with_the_profilers_host_events():
    _session(lambda: span("warm").__enter__().__exit__(None, None, None))

    def spans():
        for i in range(50):
            with span("probe.outer", i=i):
                with span("probe.inner"):
                    torch.ones(64).sum()

    _, prof = _session(spans)
    events = {}
    for name, start in _host_events(prof):
        events.setdefault(name, []).append(start)
    log = span_log()
    assert len(log) == 100
    for s in log:
        nearest = min(events[s.name], key=lambda t: abs(t - s.start_ns))
        assert abs(s.start_ns - nearest) < 100_000, s
    assert abs(span_offset_ns(_host_events(prof))) < 100_000
    # a log of another session aligns to nothing
    _, other = _session(lambda: span("elsewhere").__enter__().__exit__(None, None, None))
    assert span_offset_ns(_host_events(other), log) is None


def test_a_new_session_clears_the_log():
    def open_across(box):
        box.append(span("serve.scene", scene=7))
        box[0].__enter__()
        with span("serve.stitch"):
            pass

    box = []
    _session(lambda: open_across(box))
    assert [s.name for s in span_log()] == ["serve.stitch"]
    first = span_log()
    _session(lambda: box[0].__exit__(None, None, None))  # opened by the session before
    assert span_log() == [] and len(first) == 1


def test_trace_writes_every_threads_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        list(_engine().predict_scenes(iter(_scenes(2)), prefetch=1, readback=True))
    doc = json.loads((tmp_path / "trace.json").read_text())
    log = span_log()
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    main = threading.get_native_id()
    assert {e["tid"] for e in ours} == {s.thread for s in log} - {main}
    assert len(ours) == sum(s.thread != main for s in log)
    # the main thread's spans are the profiler's own events, once each
    waits = [e for e in doc["traceEvents"] if e.get("name") == "serve.result_wait"]
    assert len(waits) == 3 and all(e["tid"] == main for e in waits)
    base = doc.get("baseTimeNanoseconds", 0)
    scene0 = next(e for e in ours if e["name"] == "serve.scene" and e["args"]["scene"] == 0)
    logged = next(s for s in log if s.name == "serve.scene" and s.attrs["scene"] == 0)
    assert scene0["ts"] == pytest.approx((logged.start_ns - base) / 1e3)


def test_an_unnamed_span_is_no_span_under_a_profiler():
    (none, named), _ = _session(lambda: (span(None, scene=0), span("serve.scene", scene=0)))
    assert none is profiling._NO_SPAN and named is not profiling._NO_SPAN


def test_the_port_imports_and_traces_without_torchs_start_hook(tmp_path):
    """On a torch without the profiler's start hook the port's serving and
    training modules import and leave torch as it is; ``trace`` alone then
    starts each session's log."""
    code = textwrap.dedent("""
        import json, sys
        from torch.autograd import profiler as autograd_profiler
        start = autograd_profiler._run_on_profiler_start
        del autograd_profiler._run_on_profiler_start
        from satellite_computervision_tpu_torch.data import pipeline
        from satellite_computervision_tpu_torch import staging
        from satellite_computervision_tpu_torch.inference import tiles
        from satellite_computervision_tpu_torch.train import trainer
        from satellite_computervision_tpu_torch.utils import profiling
        assert not hasattr(autograd_profiler, "_run_on_profiler_start")
        assert profiling.span("serve.scene") is profiling._NO_SPAN
        autograd_profiler._run_on_profiler_start = start  # torch's own, unwrapped
        steps = []
        for i in range(2):
            with profiling.trace(sys.argv[1]):
                with profiling.span("train.step", step=i):
                    pass
            steps.append([s.attrs["step"] for s in profiling.span_log()])
        assert not getattr(autograd_profiler._run_on_profiler_start, "clears_span_log", False)
        print(json.dumps(steps))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1], timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[0], [1]]


def test_an_abandoned_stream_stops_producing_at_once():
    """Guards ``run_ahead``'s fast path, which puts an item straight in when
    the queue has room (its ``ahead`` span covers only a blocked put): it
    looks at the stop flag first, as the blocking put does, so a closed
    consumer stops the thread after the item in hand, with a span or
    without."""
    import time

    from satellite_computervision_tpu_torch.staging import run_ahead

    for ahead in (None, "serve.result_ahead"):
        produced = []

        def slow():
            for i in range(100):
                time.sleep(0.05)
                produced.append(i)
                yield i

        it = run_ahead(slow(), 2, torch.device("cpu"), wait="serve.result_wait", ahead=ahead)
        assert next(it) == 0
        it.close()
        assert produced == [0, 1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a span around a kernel on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_brackets_its_kernel_on_the_card(cuda):
    """A span around a launch that ends in a synchronise holds the kernel's
    device interval, once the log is aligned to the profiler's clock, on
    the main thread and on another."""
    a = torch.randn(4096, 4096, device=cuda)
    (a @ a).sum().item()

    def launch(tag):
        with span(tag):
            torch.mm(a, a)
            torch.cuda.synchronize()

    def run():
        for i in range(5):
            launch("probe.main")
            t = threading.Thread(target=launch, args=("probe.thread",))
            t.start()
            t.join()

    _, prof = _session(run, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    events = prof.profiler.kineto_results.events()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
               if not str(e.device_type()).endswith("CPU") and "gemm" in e.name().lower()]
    offset = span_offset_ns(_host_events(prof))
    assert offset is not None
    print(f"span log to profiler clock: {offset / 1e3:+.3f} us")
    spans = [(s.start_ns + offset, s.end_ns + offset, s.name) for s in span_log()]
    assert len(spans) == 10 and len(kernels) >= 10
    slack = 50_000  # ns
    for k0, k1 in kernels:
        assert any(s0 - slack <= k0 and k1 <= s1 + slack for s0, s1, _ in spans), (k0, k1, spans)
    for s0, s1, name in spans:
        assert any(s0 - slack <= k0 and k1 <= s1 + slack for k0, k1 in kernels), (name, s0, s1)


def test_threads_log_every_span_with_their_own_parents():
    """More threads than cores, switching every microsecond: no span is
    lost, and each one's parent is its own thread's enclosing span."""
    n_threads, per_thread = 16, 200

    def work(k):
        for i in range(per_thread):
            with span("stress.outer", batch=k * per_thread + i):
                with span("stress.inner"):
                    pass

    def run():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return [t.is_alive() for t in threads]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        alive, _ = _session(run)
    finally:
        sys.setswitchinterval(interval)
    assert not any(alive)
    log = span_log()
    ids = {s.id: s for s in log}
    assert len(ids) == len(log) == 2 * n_threads * per_thread
    outers = {s.attrs["batch"] for s in log if s.name == "stress.outer"}
    assert outers == set(range(n_threads * per_thread))
    for s in log:
        if s.name == "stress.inner":
            parent = ids[s.parent]
            assert parent.thread == s.thread and parent.attrs["batch"] == s.attrs["batch"]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
