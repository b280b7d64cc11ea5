"""fused_preprocess_roofline: the preprocess kernel's least time (its
bytes over the card's memory bandwidth,
``perfbench.counting.fused_preprocess_bytes``) over its device time in
the trace. Nothing where the trace holds no launch, or not as many as
the program counted."""

from perfbench import tracing


def read(table, data):
    k = data.get("kernels", {}).get("fused_preprocess")
    if not k:
        return None
    count, seconds = tracing.kernel_time(table, "fused_preprocess_kernel")
    if count == 0 or count != k["calls"] or seconds <= 0:
        return None
    return 100.0 * k["least_s"] / seconds
