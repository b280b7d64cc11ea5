"""sdpa_roofline: the attention kernels' least time (its FLOPs over the
bf16 peak or its bytes over the memory bandwidth, whichever is larger,
``perfbench.attention_counts``) over their device time in the trace. The
shapes come from the program's ``vit.encoder`` spans that start in the
window, one attention call per layer. Nothing where the program logs no
such span, or where the trace's attention kernels are not as many as the
spans' layers: a trace that dropped events, or a backend that splits a
call, is no reading."""

from perfbench import attention_counts, counting, program_spans

# the fused attention kernels of SDPA's CUDA backends (flash, memory
# efficient, cuDNN), by the names their device events carry
NEEDLES = ("flash_fwd", "fmha_cutlass", "sdpa", "attention")


def attention_kernels(table):
    hits = [d for k, n, _, d, _ in table["events"]
            if k == "kernel" and any(s in n.lower() for s in NEEDLES)]
    return len(hits), sum(hits) / 1e6


def read(table, data):
    name = data.get("device_name", "")
    flop_s, byte_s = counting.peak(name, "bf16_flop_s"), counting.peak(name, "hbm_byte_s")
    found = program_spans.spans(table)
    if flop_s is None or found is None:
        return None
    w = table["window_us"]
    calls = [attrs for n, s, _, attrs in found if n == "vit.encoder" and 0.0 <= s < w]
    if not calls:
        return None
    count, seconds = attention_kernels(table)
    if count != sum(a["layers"] for a in calls) or seconds <= 0:
        return None
    least = sum(a["layers"] * attention_counts.sdpa_least_s(a, flop_s, byte_s) for a in calls)
    return 100.0 * least / seconds
