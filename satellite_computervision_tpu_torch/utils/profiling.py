"""Profiling: wall-clock stage timing, ``torch.profiler`` trace capture and
the program's own spans.

Port of ``satellite_computervision_tpu/utils/profiling.py``. CUDA work is
asynchronous, so a timer that should measure device work passes
``sync=True``: ``torch.cuda.synchronize`` runs before the clock stops (the
JAX timer's ``block_until_ready``). ``trace`` writes a Chrome trace of the
block (host and CUDA activity) for TensorBoard or ``chrome://tracing``.

:func:`span` marks a layer boundary inside the program (the serving
engine's stages, the training input and step). It does nothing unless a
``torch.profiler`` session runs; then it enters ``record_function`` (seen
by the profiler on the threads it follows) and logs the span on every
thread, with ``time.time_ns()`` stamps: the profiler's host events carry
the same Unix-epoch clock. The log holds the latest session's spans
(:func:`span_log`); :func:`span_offset_ns` puts them on a profiler
table's clock, and ``trace`` writes them into its Chrome trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulating named wall-clock timers.

    >>> t = Timer()
    >>> with t("stitch", sync=True): ...
    >>> t.summary()  # {'stitch': {'total_s': ..., 'count': ..., 'mean_s': ...}}
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def stage_timer(name: str, log_fn=print):
    """One-shot stage timing context."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        log_fn(f"[timing] {name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where a card is present) into ``logdir/trace.json``,
    with the program's spans of every thread (:func:`span`) on the same
    timeline."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _new_session()  # also where torch has no start hook to do it (below)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _merge_spans(path, span_log())


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of a CUDA device (the current one by
    default); None for the CPU, which keeps no such statistics."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return dict(torch.cuda.memory_stats(device))


# ------------------------------------------------------------------ spans
class SpanRecord(NamedTuple):
    """One logged span: ``thread`` is the native thread id (the Chrome
    trace's ``tid``), stamps are ``time.time_ns()``, ``parent`` is the
    ``id`` of the enclosing span on the same thread."""

    id: int
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[int]
    attrs: Dict


# ids a child takes from its parent: every span of one scene or batch
# carries the scene's or batch's sequence number in its stream
_INHERITED = ("scene", "batch")

_log: List[SpanRecord] = []
_open = threading.local()
_ids = itertools.count()
_session = 0


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "session", "function", "stack", "start")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        if parent is not None:
            for key in _INHERITED:
                if key in parent.attrs and key not in self.attrs:
                    self.attrs[key] = parent.attrs[key]
        self.parent = None if parent is None else parent.id
        self.id, self.session = next(_ids), _session
        self.stack = stack
        stack.append(self)
        self.function = _autograd_profiler.record_function(self.name)
        self.function.__enter__()
        self.start = time.time_ns()
        return self

    def set(self, **attrs):
        """Add ``attrs`` known only inside the block (counts it made)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.remove(self)
        self.function.__exit__(*exc)
        if self.session == _session:  # not a span left open by an earlier session
            _log.append(SpanRecord(self.id, self.name, threading.get_native_id(), self.start,
                                   end, self.parent, self.attrs))
        return None


def span(name: str, **attrs):
    """A span of the program's own around a layer boundary, on any thread.

    With no ``torch.profiler`` session running this is one flag read and
    returns a shared do-nothing context. While one runs, the block is a
    ``record_function(name)`` and is logged with its thread, stamps,
    parent and ``attrs`` (counts such as bytes or chips, and the
    ``scene``/``batch`` id, which children inherit; ``set`` adds more
    inside the block). A ``name`` of None is no span."""
    if not _autograd_profiler._is_profiler_enabled or name is None:
        return _NO_SPAN
    return _Span(name, attrs)


def span_log() -> List[SpanRecord]:
    """The spans of the latest profiler session (a new session clears
    them; reading does not), in the order they ended."""
    return list(_log)


def _new_session() -> None:
    global _session
    _session += 1
    _log.clear()


def _on_profiler_start(start):
    def run_on_profiler_start():
        _new_session()
        start()

    run_on_profiler_start.clears_span_log = True
    return run_on_profiler_start


# Every torch.profiler session starts through this private hook of torch's,
# which torch looks up by name at each start; wrapped, it clears the log for
# each new session. A torch without it is left as it is: then only ``trace``
# starts a new log, and a reader tells another session's spans by their
# stamps (``span_offset_ns``).
_start_hook = getattr(_autograd_profiler, "_run_on_profiler_start", None)
if callable(_start_hook) and not getattr(_start_hook, "clears_span_log", False):
    _autograd_profiler._run_on_profiler_start = _on_profiler_start(_start_hook)

# how far a logged span's start may lie from its profiler event's once
# aligned: the event opens before the stamp by record_function's entry cost
# (about 20 us)
_ALIGN_TOLERANCE_NS = 50_000


def span_offset_ns(events: Iterable[Tuple[str, float]],
                   spans: Optional[List[SpanRecord]] = None) -> Optional[int]:
    """Nanoseconds to add to a logged stamp to put it on the clock of a
    profiler's host ``events``, ``(name, start_ns)`` pairs, whatever that
    clock's origin (a table's times from its window's start, in ns).

    Spans on a thread the profiler follows appear in both. Each event is
    set beside the nearest logged span of its name under a trial offset
    (an event's start less a logged start of its name, for the first,
    middle and last event of the name logged least often); the trial that
    pairs the most events within ``_ALIGN_TOLERANCE_NS``, then the one whose
    pairs' gaps spread least, gives the median gap of its pairs. None when
    no span appears in ``events``, or when fewer than half of those that
    do find a logged span within that tolerance: a log of another
    session. Whole nanoseconds throughout: Unix-epoch stamps do not fit a
    float's 53 bits."""
    spans = span_log() if spans is None else spans
    logged = {name: np.sort(np.asarray(starts, dtype=np.int64)) for name, starts in
              _group((s.name, s.start_ns) for s in spans).items()}
    seen = {name: np.sort(np.rint(starts).astype(np.int64)) for name, starts in
            _group((n, s) for n, s in events if n in logged).items()}
    if not seen:
        return None
    n_seen = sum(len(v) for v in seen.values())
    pivot_name = min(seen, key=lambda n: len(logged[n]))
    pivot = seen[pivot_name]
    best = (0, 0.0, None)  # pairs, -spread, offset
    for at in {0, len(pivot) // 2, len(pivot) - 1}:
        for trial in pivot[at] - logged[pivot_name]:
            gaps = np.concatenate([_nearest_gaps(starts - trial, logged[name])
                                   for name, starts in seen.items()])
            hits = np.sort(gaps[np.abs(gaps) <= _ALIGN_TOLERANCE_NS])
            if len(hits) == 0:
                continue
            mid = int(hits[len(hits) // 2])
            score = (len(hits), -float(np.mean(np.abs(hits - mid))))
            if score > best[:2]:
                best = score + (int(trial) + mid,)
    return best[2] if 2 * best[0] >= n_seen else None


def _group(pairs) -> Dict[str, List]:
    out: Dict[str, List] = defaultdict(list)
    for name, value in pairs:
        out[name].append(value)
    return out


def _nearest_gaps(points: np.ndarray, sorted_starts: np.ndarray) -> np.ndarray:
    """Each point minus the nearest of ``sorted_starts``."""
    if len(sorted_starts) == 1:
        return points - sorted_starts[0]
    i = np.clip(np.searchsorted(sorted_starts, points), 1, len(sorted_starts) - 1)
    left, right = points - sorted_starts[i - 1], points - sorted_starts[i]
    return np.where(np.abs(left) <= np.abs(right), left, right)


def _merge_spans(path: str, spans: List[SpanRecord]) -> None:
    """Add the logged spans of the threads the profiler did not follow to
    the Chrome trace at ``path`` (its ``ts`` count microseconds from
    ``baseTimeNanoseconds``, on the log's clock)."""
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    names = {s.name for s in spans}
    followed = {e.get("tid") for e in events if e.get("ph") == "X" and e.get("name") in names}
    base = doc.get("baseTimeNanoseconds", 0)
    pid = next((e["pid"] for e in events if "pid" in e), os.getpid())
    for s in spans:
        if s.thread in followed:
            continue  # the profiler's own event of this span is there
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, span_id=s.id, parent=s.parent)})
    doc["traceEvents"] = events
    with open(path, "w") as f:
        json.dump(doc, f)
