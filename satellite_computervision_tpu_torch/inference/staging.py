"""Scene and band staging for the tiled engine: threads that keep the host
side ahead of the device.

- :func:`run_ahead` iterates a generator on a daemon thread, at most
  ``size`` items ahead of the consumer. Items arrive in order, an error in
  the thread re-raises in the consumer, and closing the consumer (or an
  error in it) stops the thread and joins it: an abandoned stream leaves
  no thread behind, blocked or not. Its two waits are spans
  (``utils.profiling.span``) under names the caller gives: the consumer
  waiting for the next item, and the thread blocked on a full queue.
- :func:`stage_to_device` is the host-to-device stage built on it. On
  CUDA each host array is copied into one of ``size + 1`` pinned host
  buffers used in turn (a buffer is written again only after the copy
  that last read it has finished, so a reused buffer never corrupts a
  scene still in flight), then sent with a ``non_blocking`` copy on a side
  stream. The consumer's stream waits on the copy's event, and the device
  tensor is marked as used on the consumer's stream (``record_stream``)
  so the caching allocator does not hand its memory back to the side
  stream early. On the CPU the arrays become tensors and nothing is
  copied, through the same threads.

The training iterator (``data/pipeline.py::prefetch_to_device``) stages
dicts of batches and is separate.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch.utils.profiling import span

_END, _ERR = object(), object()


def run_ahead(items: Iterable, size: int, device: torch.device, wait: Optional[str] = None,
              ahead: Optional[str] = None, key: str = "scene") -> Iterator:
    """Yield the items of ``items``, produced on a daemon thread at most
    ``size`` ahead (with ``device`` current there when it is CUDA).

    ``wait`` names the span of the consumer's wait for item n, ``ahead``
    that of the thread blocked with item n on a full queue; both carry
    ``key=n``. A name left None is no span."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = threading.Event()

    def put(item, n) -> bool:
        if stop.is_set():  # an abandoned stream: nothing more is produced
            return False
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            pass
        with span(ahead, **{key: n}):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
        return False

    def work():
        it = iter(items)
        n = 0
        try:
            for n, item in enumerate(it):
                if not put((item, None), n):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            put((_ERR, e), n)
        else:
            put((_END, None), n)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def worker():
        if device.type == "cuda":
            with torch.cuda.device(device):
                work()
        else:
            work()

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        for n in itertools.count():
            with span(wait, **{key: n}):
                item, err = q.get()
            if item is _END:
                return
            if item is _ERR:
                raise err
            yield item
    finally:
        stop.set()
        thread.join()


class _PinnedRing:
    """``n`` pinned host buffers, used in turn and grown when an array
    needs more room."""

    def __init__(self, n: int):
        self.buffers = [None] * n
        self.events = [None] * n
        self.next = 0

    def copy_to(self, arr: np.ndarray, device: torch.device,
                stream: "torch.cuda.Stream") -> Tuple[torch.Tensor, "torch.cuda.Event"]:
        i = self.next
        self.next = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            with span("serve.ring_wait"):
                self.events[i].synchronize()  # the copy that last read buffer i
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        n_bytes = max(arr.nbytes, 1)
        if self.buffers[i] is None or self.buffers[i].numel() < n_bytes:
            self.buffers[i] = torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)
        host = self.buffers[i][: arr.nbytes].view(dtype).view(arr.shape)
        np.copyto(host.numpy(), arr)
        with torch.cuda.stream(stream):
            out = torch.empty(arr.shape, dtype=dtype, device=device)
            out.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self.events[i] = event
        return out, event


def stage_to_device(items: Iterable, size: int, device: torch.device,
                    key: str = "scene") -> Iterator:
    """``(array, tag)`` pairs -> ``(tensor on device, tag)`` pairs, in
    order, staged on a thread at most ``size`` items ahead. ``array`` is a
    numpy array (any strides, e.g. a memory-mapped slice) or a tensor
    (moved as it is). The tags ride along untouched (e.g. a chip-validity
    mask computed on the staging thread).

    Spans, each carrying ``key=n`` for item n: ``serve.stage`` (the copy,
    with its ``bytes``; inside it ``serve.ring_wait``) and
    ``serve.stage_ahead`` on the staging thread, ``serve.stage_wait`` on
    the consumer's."""
    cuda = device.type == "cuda"
    ring = _PinnedRing(size + 1) if cuda else None
    side = torch.cuda.Stream(device) if cuda else None

    def stage(arr):
        if isinstance(arr, torch.Tensor):
            return arr.to(device), None
        if cuda:
            return ring.copy_to(np.asarray(arr), device, side)
        return torch.from_numpy(np.ascontiguousarray(arr)), None

    def staged():
        for n, (arr, tag) in enumerate(items):
            with span("serve.stage", bytes=arr.nbytes, **{key: n}):
                out = stage(arr)
            yield out, tag

    it = run_ahead(staged(), size, device, wait="serve.stage_wait", ahead="serve.stage_ahead",
                   key=key)
    try:
        for (tensor, event), tag in it:
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                tensor.record_stream(current)
            yield tensor, tag
    finally:
        it.close()
