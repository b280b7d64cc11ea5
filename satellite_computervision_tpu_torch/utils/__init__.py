"""Utilities: profiling, structured logging, visualization.

Port of ``satellite_computervision_tpu/utils``: per-stage wall timing
(synchronizing CUDA when asked), ``torch.profiler`` trace capture, device
memory statistics, JSONL structured logs, and the figure/image helpers
used for qualitative checks.
"""

from satellite_computervision_tpu_torch.utils.logging import MetricsLogger
from satellite_computervision_tpu_torch.utils.profiling import (
    Timer,
    device_memory_stats,
    stage_timer,
    trace,
)
from satellite_computervision_tpu_torch.utils.viz import plot_to_image, save_rgb_image

__all__ = [
    "Timer",
    "stage_timer",
    "trace",
    "device_memory_stats",
    "MetricsLogger",
    "plot_to_image",
    "save_rgb_image",
]
