"""Host-to-device staging for the tiled engine and the training iterator:
threads that keep the host side ahead of the device.

- :func:`run_ahead` iterates a generator on a daemon thread, at most
  ``size`` items ahead of the consumer. Items arrive in order, an error in
  the thread re-raises in the consumer, and closing the consumer (or an
  error in it) stops the thread and joins it: an abandoned stream leaves
  no thread behind, blocked or not. Its two waits are spans
  (``utils.profiling.span``) under names the caller gives: the consumer
  waiting for the next item, and the thread blocked on a full queue.
- :func:`stage_to_device` is the host-to-device stage built on it: scenes
  and bands for ``inference/tiles.py``, dicts of batches for
  ``data/pipeline.py::prefetch_to_device``. On CUDA each item is copied
  into one of ``size + 1`` pinned host buffers used in turn, every array
  of a dict at its own aligned offset (a buffer is written again only
  after the copies that last read it have finished, so a reused buffer
  never corrupts an item still in flight), then sent with ``non_blocking``
  copies on a side stream, one device tensor per array. The consumer's
  stream waits on the copies' event, and each device tensor is marked as
  used on the consumer's stream (``record_stream``) so the caching
  allocator does not hand its memory back to the side stream early. On
  the CPU the arrays become tensors and nothing is copied, through the
  same threads.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch.utils.profiling import span

_END, _ERR = object(), object()
_ALIGN = 4096  # each array of an item starts on a page, as in an allocation of its own


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


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor over an array's memory, or over a copy where torch
    cannot view it (read-only or byte-swapped memory, negative strides)."""
    arr = np.asarray(arr)
    if not (arr.flags.writeable and arr.dtype.isnative and min(arr.strides, default=0) >= 0):
        arr = np.array(arr, dtype=arr.dtype.newbyteorder("="))
    return torch.from_numpy(arr)


class _PinnedRing:
    """``n`` pinned host buffers, one item each, used in turn and grown
    when an item needs more room; ``wait`` names the span of the wait on
    a buffer's previous copies."""

    def __init__(self, n: int, wait: str):
        self.buffers = [None] * n
        self.events = [None] * n
        self.next = 0
        self.wait = wait

    def copy_to(self, arrays: Dict, device: torch.device,
                stream: "torch.cuda.Stream") -> Tuple[Dict, "torch.cuda.Event"]:
        i = self.next
        self.next = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            with span(self.wait):
                self.events[i].synchronize()  # the copies that last read buffer i
        sources = {k: _host_tensor(a) for k, a in arrays.items()}
        offsets = list(itertools.accumulate((-(-t.nbytes // _ALIGN) * _ALIGN
                                             for t in sources.values()), initial=0))
        if self.buffers[i] is None or self.buffers[i].numel() < offsets[-1]:
            self.buffers[i] = torch.empty(max(offsets[-1], 1), dtype=torch.uint8, pin_memory=True)
        out = {}
        with torch.cuda.stream(stream):
            for (k, src), at in zip(sources.items(), offsets):
                host = self.buffers[i][at : at + src.nbytes].view(src.dtype).view(src.shape)
                host.copy_(src)  # ATen's copy: several threads for a large array
                out[k] = torch.empty(src.shape, dtype=src.dtype, device=device)
                out[k].copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self.events[i] = event
        return out, event


def stage_to_device(items: Iterable, size: int, device: torch.device, key: str = "scene",
                    stage: str = "serve.stage", ring_wait: str = "serve.ring_wait",
                    ahead: str = "serve.stage_ahead", wait: str = "serve.stage_wait") -> Iterator:
    """``(item, tag)`` pairs -> ``(item on device, tag)`` pairs, in order,
    staged on a thread at most ``size`` items ahead. An item is a numpy
    array (any strides, e.g. a memory-mapped slice), a dict of them (one
    item; a dict of tensors comes out) or a tensor (moved as it is). The
    tags ride along untouched (e.g. a chip-validity mask computed on the
    staging thread).

    Spans, each carrying ``key=n`` for item n, under the names given (by
    default the engine's): ``stage`` (the copies, with the item's
    ``bytes``; inside it ``ring_wait``) and ``ahead`` on the staging
    thread, ``wait`` on the consumer's."""
    cuda = device.type == "cuda"
    ring = _PinnedRing(size + 1, ring_wait) if cuda else None
    side = torch.cuda.Stream(device) if cuda else None

    def upload(item):
        if isinstance(item, torch.Tensor):
            return item.to(device), None
        arrays = item if isinstance(item, dict) else {None: item}
        if cuda:
            out, event = ring.copy_to(arrays, device, side)
        else:
            out, event = {k: _host_tensor(a).contiguous() for k, a in arrays.items()}, None
        return (out if isinstance(item, dict) else out[None]), event

    def staged():
        for n, (item, tag) in enumerate(items):
            values = item.values() if isinstance(item, dict) else (item,)
            with span(stage, bytes=sum(v.nbytes for v in values), **{key: n}):
                out = upload(item)
            yield out, tag

    it = run_ahead(staged(), size, device, wait=wait, ahead=ahead, key=key)
    try:
        for (out, event), tag in it:
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for tensor in out.values() if isinstance(out, dict) else (out,):
                    tensor.record_stream(current)
            yield out, tag
    finally:
        it.close()
