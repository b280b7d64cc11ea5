"""mfu.train: the training step's share of the card's dense bf16 peak.

FLOPs of one step (forward and backward of every convolution), counted
at set-up from shapes, times the steps of the traced window, over the
window and the peak. Nothing where the card has no published peak or the
cell trains nothing.
"""

from perfbench import counting, tracing


def read(table, data):
    peak = counting.peak(data.get("device_name", ""), "bf16_flop_s")
    if peak is None or "step_flops" not in data:
        return None
    return 100.0 * data["step_flops"] / tracing.window_s(table) / peak
