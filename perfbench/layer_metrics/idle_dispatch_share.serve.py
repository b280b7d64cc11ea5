"""idle_dispatch_share.serve: the share of the traced window in which no
kernel ran while the engine's dispatch thread was in ``serve.scene`` (input,
chip batches, stitch) or ``serve.readback`` (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.idle_share(table, ("serve.scene", "serve.readback"))
