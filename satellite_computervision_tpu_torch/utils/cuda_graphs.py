"""What a CUDA graph capture needs below the layers that capture: the
training step (``train/trainer.py``) and the served Swin stages
(``models/satlas.py``)."""

from __future__ import annotations

import contextlib
import warnings

import torch


def no_mode_active() -> bool:
    """No ``torch`` dispatch or function mode (``FlopCounterMode``, a
    device context) is active and no capture is running: what a capture or
    a replay needs besides its own conditions."""
    return (torch._C._len_torch_dispatch_stack() == 0
            and torch._C._len_torch_function_stack() == 0
            and not torch.cuda.is_current_stream_capturing())


def after_failed_capture(device: torch.device, stream, pool) -> None:
    """Put back what a capture that ended in an error leaves behind: its
    side stream current, the allocator still sending allocations to its
    memory pool (memory used across streams then is never freed), and the
    CUDA generator in capture mode (every later random op then raises)."""
    torch.cuda.set_stream(stream)
    with contextlib.suppress(RuntimeError):  # already ended where the error came later
        torch._C._cuda_endAllocateToPool(device.index, pool)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the graph below is empty, by design
        with torch.cuda.device(device), \
                torch.cuda.graph(torch.cuda.CUDAGraph(), capture_error_mode="thread_local"):
            pass  # a capture that ends cleanly takes the generator out of capture mode
