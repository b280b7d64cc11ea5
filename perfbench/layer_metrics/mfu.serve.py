"""mfu.serve: the served forward's share of the card's dense bf16 peak.

FLOPs of one forward chip batch, counted at set-up from shapes, times the
batches of the scenes completed in the traced window, over the window
and the peak (``perfbench.counting.PEAKS``). Nothing where the card has
no published peak or the cell serves nothing.
"""

from perfbench import counting, tracing


def read(table, data):
    peak = counting.peak(data.get("device_name", ""), "bf16_flop_s")
    if peak is None or "forward_flops" not in data:
        return None
    return 100.0 * data["forward_flops"] / tracing.window_s(table) / peak
