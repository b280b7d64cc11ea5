"""idle_dispatch_share.train: the share of the traced window in which no
kernel ran while the training thread was in ``train.preprocess`` or
``train.step`` (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.idle_share(table, ("train.preprocess", "train.step"))
