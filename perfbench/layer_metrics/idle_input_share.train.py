"""idle_input_share.train: the share of the traced window in which no kernel
ran while the training thread waited in ``train.batch_wait`` for a staged
batch (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.idle_share(table, ("train.batch_wait",))
