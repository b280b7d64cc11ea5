"""input_wait_ms.train: the mean host time per step that the benchmark's
loop spends in ``next()`` on the training iterator, the wait for the
input layer (``TrainIterator``, ``prefetch_to_device``)."""


def read(table, data):
    waits = data.get("input_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
