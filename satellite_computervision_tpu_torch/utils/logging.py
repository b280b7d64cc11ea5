"""Structured JSONL metrics logging (the TensorBoard-callback equivalent).

Reference observability is Keras progress bars + a TensorBoard callback
(solar notebook cells 61, 71); here metrics stream to JSONL, which both
humans and dashboards can tail, with no TF dependency. The port's own copy
of ``satellite_computervision_tpu/utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, step: int, **metrics: Any):
        record: Dict[str, Any] = {"ts": time.time(), "step": step}
        for key, value in metrics.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = value
        line = json.dumps(record)
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line)

    def close(self):
        if self._f:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
