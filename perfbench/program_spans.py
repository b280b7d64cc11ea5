"""The program's own spans on a traced table's clock, and what the
per-layer readers take from them.

The program (``satellite_computervision_tpu_torch.utils.profiling``) logs
a span at each layer boundary of its serving engine and training loop, on
every thread, while a profiler runs. The spans of the threads the profiler
follows are host events of the table as well, and align the log to the
table's clock (``span_offset_ns``). A program without the log, an empty
log, or one that matches no host event of the table (a log of another
session) reads as no spans, and every reader returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from perfbench import tracing

Span = Tuple[str, float, float, Dict]  # name, start and end on the table's clock (us), attrs


def spans(table: Dict) -> Optional[List[Span]]:
    """The logged spans, times in microseconds from the window's start, or
    None."""
    try:
        from satellite_computervision_tpu_torch.utils import profiling
    except ImportError:
        return None
    log_of = getattr(profiling, "span_log", None)
    offset_of = getattr(profiling, "span_offset_ns", None)
    if log_of is None or offset_of is None:
        return None
    log = log_of()
    if not log:
        return None
    offset = offset_of([(n, s * 1e3) for k, n, s, _, _ in table["events"] if k == "host"], log)
    if offset is None:
        return None
    return [(r.name, (r.start_ns + offset) / 1e3, (r.end_ns + offset) / 1e3, r.attrs) for r in log]


def union(intervals: np.ndarray) -> np.ndarray:
    """(n, 2) intervals -> the sorted, disjoint intervals of their union."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.r_[True, iv[1:, 0] > reach[:-1]]
    last = np.r_[np.flatnonzero(first)[1:] - 1, len(iv) - 1]
    return np.stack([iv[first, 0], reach[last]], axis=1)


def overlap_us(a: np.ndarray, b: np.ndarray) -> float:
    """Length of the intersection of two sets of sorted, disjoint
    intervals."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    before = np.r_[0.0, np.cumsum(b[:, 1] - b[:, 0])]

    def covered(t):  # length of b before each t
        j = np.searchsorted(b[:, 0], t, side="right") - 1
        inside = np.clip(t - b[np.maximum(j, 0), 0], 0.0, None)
        part = np.minimum(inside, b[np.maximum(j, 0), 1] - b[np.maximum(j, 0), 0])
        return np.where(j >= 0, before[np.maximum(j, 0)] + part, 0.0)

    return float(np.sum(covered(a[:, 1]) - covered(a[:, 0])))


def idle_share(table: Dict, names: Sequence[str], after: Optional[str] = None) -> Optional[float]:
    """Percent of the window in which no kernel ran while a span of
    ``names`` was open; None without such a span in the window. With
    ``after``, only the time after the first span of that name ends counts
    (a stream's fill left out); None where none ends in the window."""
    found = spans(table)
    if found is None:
        return None
    w = table["window_us"]
    start = 0.0
    if after is not None:
        ends = [e for n, _, e, _ in found if n == after and 0.0 < e < w]
        if not ends:
            return None
        start = min(ends)
    inside = np.array([(max(s, start), min(e, w)) for n, s, e, _ in found
                       if n in names and e > start and s < w]).reshape(-1, 2)
    if len(inside) == 0:
        return None
    gaps = np.array(tracing.idle_gaps(table, ("kernel",))).reshape(-1, 2)
    return 100.0 * overlap_us(gaps, union(inside)) / w


def mean_ms(table: Dict, names: Sequence[str], key: str) -> Optional[float]:
    """Mean over the ``key`` ids (scenes, batches) whose spans of every
    one of ``names`` start in the window, of those spans' summed time, in
    milliseconds; None without one."""
    found = spans(table)
    if found is None:
        return None
    w = table["window_us"]
    total: Dict[int, float] = defaultdict(float)
    seen: Dict[int, set] = defaultdict(set)
    for n, s, e, attrs in found:
        if n in names and key in attrs and 0.0 <= s < w:
            total[attrs[key]] += e - s
            seen[attrs[key]].add(n)
    whole = [total[i] for i in total if len(seen[i]) == len(set(names))]
    return sum(whole) / len(whole) / 1e3 if whole else None
