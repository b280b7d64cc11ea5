"""One run of one cell: set-up, the measured (or traced) window, the
metrics, then the comparison that decides ``correct``.

:func:`run_cell` takes the device to run on, so the tests drive it on the
CPU at a small size; ``run.py`` refuses to run without the chips a cell
asks for.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from perfbench import tracing

GIB = 2**30


def compare(readings: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Each compared number beside its limit (a reading passes at or
    below it). A limit with no reading fails."""
    out = {}
    for name, spec in limits["numbers"].items():
        value = readings.get(name, float("inf"))
        out[name] = {"value": value, "limit": spec["limit"], "ok": value <= spec["limit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: torch.device,
             started: Optional[float] = None) -> Dict:
    """The result line of one run (without ``checks``' formatting)."""
    started = time.perf_counter() if started is None else started
    cuda = device.type == "cuda"
    driver = cell.module("drivers", cell.traffic["driver"]).Driver(cell, seed, device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    table = None
    if trace:
        with tracing.profiled(device) as prof:
            with tracing.span("window"):
                win = driver.window(min(seconds, cell.traffic["trace_seconds"]))
        table = prof["table"]
    else:
        win = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.module("layer_metrics", m["name"]).read(table, win["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win["e2e"], setup_s=setup_s, peak_mem_gib=peak / GIB)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    driver.finish()
    checks = compare(driver.readings("float32"), cell.limits)
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell.chips if cuda else 0,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": all(c["ok"] for c in checks.values()) and win["failed"] == 0,
        "attempted": win["attempted"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": device_info,
    }
    if trace:
        device_info["busy_s"] = tracing.busy_s(table)
        device_info["window_s"] = tracing.window_s(table)
        result["breakdown"] = tracing.breakdown(table)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result
