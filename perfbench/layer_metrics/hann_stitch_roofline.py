"""hann_stitch_roofline: the stitch kernel's least time (its bytes over
the card's memory bandwidth, ``perfbench.counting.hann_stitch_bytes``)
over its device time in the trace. Nothing where the trace holds no
launch, or not as many as the program counted: a trace that dropped
events is no reading."""

from perfbench import tracing


def read(table, data):
    k = data.get("kernels", {}).get("hann_stitch")
    if not k:
        return None
    count, seconds = tracing.kernel_time(table, "hann_stitch_kernel")
    if count == 0 or count != k["calls"] or seconds <= 0:
        return None
    return 100.0 * k["least_s"] / seconds
