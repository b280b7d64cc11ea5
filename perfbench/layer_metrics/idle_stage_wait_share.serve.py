"""idle_stage_wait_share.serve: the share of the traced window in which no
kernel ran while the engine's dispatch thread waited in
``serve.stage_wait`` for the next staged scene, once the first
``serve.scene`` has ended: the wait for the stream's first scene (the
pipeline's fill, which a traced window starts) is left out
(``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.idle_share(table, ("serve.stage_wait",), after="serve.scene")
