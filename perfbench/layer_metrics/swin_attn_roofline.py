"""swin_attn_roofline: the windowed attention's least time (its FLOPs over
the bf16 peak or its bytes over the memory bandwidth, whichever is larger,
``perfbench.window_attention_counts``) over its kernels' device time in
the trace. The shapes come from the program's ``swin.stage`` spans that
start in the window, one attention call per layer. Nothing where the
program logs no such span, or where the trace's attention kernels are not
as many as the spans' layers: a trace that dropped events, or a backend
that splits a call or runs it as plain matmuls, is no reading. The
attention kernels are found as ``sdpa_roofline`` finds them."""

from pathlib import Path

from perfbench import counting, manifest, program_spans, window_attention_counts

_SDPA = manifest.load_module(Path(__file__).with_name("sdpa_roofline.py"), "sdpa_roofline_rule")
NEEDLES, attention_kernels = _SDPA.NEEDLES, _SDPA.attention_kernels


def read(table, data):
    name = data.get("device_name", "")
    flop_s, byte_s = counting.peak(name, "bf16_flop_s"), counting.peak(name, "hbm_byte_s")
    found = program_spans.spans(table)
    if flop_s is None or found is None:
        return None
    w = table["window_us"]
    calls = [attrs for n, s, _, attrs in found if n == "swin.stage" and 0.0 <= s < w]
    if not calls:
        return None
    count, seconds = attention_kernels(table)
    if count != sum(a["layers"] for a in calls) or seconds <= 0:
        return None
    least = sum(window_attention_counts.stage_least_s(a, flop_s, byte_s) for a in calls)
    return 100.0 * least / seconds
