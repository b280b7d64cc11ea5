"""Profiling: wall-clock stage timing and ``torch.profiler`` trace capture.

Port of ``satellite_computervision_tpu/utils/profiling.py``. CUDA work is
asynchronous, so a timer that should measure device work passes
``sync=True``: ``torch.cuda.synchronize`` runs before the clock stops (the
JAX timer's ``block_until_ready``). ``trace`` writes a Chrome trace of the
block (host and CUDA activity) for TensorBoard or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


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
    CUDA activity where a card is present) into ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
