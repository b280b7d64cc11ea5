"""input_stage_ms.train: the mean host time per batch of the input
thread's ``train.batch`` (shuffle and stack) and ``train.stage`` (pinned
copies and the upload), from the program's own spans
(``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.mean_ms(table, ("train.batch", "train.stage"), "batch")
