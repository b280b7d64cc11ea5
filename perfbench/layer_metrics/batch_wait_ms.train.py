"""batch_wait_ms.train: the mean host time per step of the training
thread's ``train.batch_wait`` (taking a staged batch off the queue, and the
stream's wait on its copy): the program's own twin of
``input_wait_ms.train`` (``perfbench.program_spans``)."""

from perfbench import program_spans


def read(table, data):
    return program_spans.mean_ms(table, ("train.batch_wait",), "batch")
