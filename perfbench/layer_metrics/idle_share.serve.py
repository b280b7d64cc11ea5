"""idle_share.serve: the share of the traced serving window in which no
kernel ran on the device."""

from perfbench import tracing


def read(table, data):
    if "forward_flops" not in data:
        return None
    return 100.0 * (1.0 - tracing.busy_s(table, ("kernel",)) / tracing.window_s(table))
