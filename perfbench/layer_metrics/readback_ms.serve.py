"""readback_ms.serve: the mean host time per scene of the dispatch
thread's ``serve.readback`` (the pinned host allocation, the non-blocking
device-to-host copy and its event), from the program's own spans
(``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.mean_ms(table, ("serve.readback",), "scene")
