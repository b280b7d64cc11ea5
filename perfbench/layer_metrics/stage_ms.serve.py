"""stage_ms.serve: the mean host time per scene of the staging thread's
``serve.host_scene`` (the host array, and chip validity when culling) and
``serve.stage`` (the copy into the pinned ring and the upload), from the
program's own spans (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.mean_ms(table, ("serve.host_scene", "serve.stage"), "scene")
