"""The traced window: ``torch.profiler`` events as a plain table, and what
the per-layer readers and the result's ``breakdown`` take from it.

The table is ``{"window_us": w, "events": [[kind, name, start_us, dur_us,
thread], ...]}`` with times from the start of the benchmark's own span
``perfbench.window``; ``kind`` is ``kernel``, ``memcpy`` or ``memset`` for
device events and ``host`` for host ones. Only events that overlap the
window are kept. Tests feed the readers recorded tables.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

WINDOW = "perfbench.window"
DEVICE_KINDS = ("kernel", "memcpy", "memset")


def span(name: str):
    """A host span of the benchmark's own (``perfbench.<name>``), recorded
    when a profiler runs and nearly free otherwise."""
    from torch.profiler import record_function

    return record_function(f"perfbench.{name}")


@contextlib.contextmanager
def profiled(device):
    """Profile host and device activity inside the block; yields a dict
    whose ``table`` is filled when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=activities) as prof:
        yield out
    out["table"] = table_from_events(prof.profiler.kineto_results.events())


def _kind(device_type, name: str) -> str:
    if str(device_type).endswith("CPU"):
        return "host"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def table_from_events(events) -> Dict:
    rows = []
    window = None
    for e in events:
        name = e.name()
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        kind = _kind(e.device_type(), name)
        if kind != "host" and (name.startswith("perfbench.") or _annotation(e)):
            continue  # the device-side copy of a host span, not an operation
        if kind == "host" and name == WINDOW:
            window = (start, start + dur)
        rows.append([kind, name, start, dur, int(e.start_thread_id())])
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW} span")
    w0, w1 = window
    kept = [[k, n, s - w0, d, t] for k, n, s, d, t in rows if s < w1 and s + d > w0]
    return {"window_us": w1 - w0, "events": kept}


def _clip(table: Dict, kinds: Iterable[str]) -> List[Tuple[float, float]]:
    w = table["window_us"]
    return [(max(s, 0.0), min(s + d, w)) for k, _, s, d, _ in table["events"] if k in kinds]


def union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def busy_s(table: Dict, kinds=DEVICE_KINDS) -> float:
    """Seconds of the window in which a device event of ``kinds`` ran."""
    return union_us(_clip(table, kinds)) / 1e6


def window_s(table: Dict) -> float:
    return table["window_us"] / 1e6


def kernel_time(table: Dict, needle: str) -> Tuple[int, float]:
    """(count, seconds) of the kernels whose name holds ``needle``."""
    hits = [d for k, n, _, d, _ in table["events"] if k == "kernel" and needle in n]
    return len(hits), sum(hits) / 1e6


def idle_gaps(table: Dict, kinds=("kernel",)) -> List[Tuple[float, float]]:
    """Stretches of the window in which no device event of ``kinds`` ran."""
    gaps, cursor = [], 0.0
    for a, b in sorted(_clip(table, kinds)):
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < table["window_us"]:
        gaps.append((cursor, table["window_us"]))
    return gaps


class _HostIndex:
    """The benchmark thread's host events, for asking what it was doing
    at a time."""

    def __init__(self, table: Dict, main: Optional[int]):
        import numpy as np

        rows = [(s, s + d, n) for k, n, s, d, tid in table["events"]
                if k == "host" and tid == main and n != WINDOW]
        self.names = [n for _, _, n in rows]
        self.start = np.array([a for a, _, _ in rows], dtype=np.float64)
        self.end = np.array([b for _, b, _ in rows], dtype=np.float64)
        self.ours = np.array([n.startswith("perfbench.") for n in self.names], dtype=bool)

    def label(self, t: float) -> str:
        """Its outermost ``perfbench.*`` span at ``t`` and its innermost op."""
        import numpy as np

        hit = np.flatnonzero((self.start <= t) & (self.end >= t))
        if hit.size == 0:
            return "host: outside any op"
        dur = self.end[hit] - self.start[hit]
        inner = self.names[hit[np.argmin(dur)]]
        ours = hit[self.ours[hit]]
        if ours.size == 0:
            return inner
        outer = self.names[ours[np.argmax(self.end[ours] - self.start[ours])]]
        return outer if outer == inner else f"{outer} / {inner}"


def breakdown(table: Dict, top: int = 10, labelled: int = 500) -> Dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, each as [[name, seconds], ...]. The
    ``labelled`` longest gaps are labelled one by one; the others count
    together as short gaps."""
    ops: Dict[str, float] = {}
    for k, n, _, d, _ in table["events"]:
        if k in DEVICE_KINDS:
            ops[n] = ops.get(n, 0.0) + d / 1e6
    mains = [tid for k, n, *_, tid in table["events"] if k == "host" and n == WINDOW]
    main = mains[0] if mains else None
    gaps = sorted(idle_gaps(table, DEVICE_KINDS), key=lambda g: g[0] - g[1])
    index = _HostIndex(table, main)
    idle: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        if i < labelled:
            label = index.label((a + b) / 2)
        else:
            label = f"gaps shorter than {gaps[labelled - 1][1] - gaps[labelled - 1][0]:.1f} us"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    first = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return {"device_ops": first(ops), "idle_gaps": first(idle)}
