"""The served U-Net's conv epilogues, one pass each: bias + ReLU in place
(:func:`bias_relu_`), the same followed by the encoder's 2x2 max-pool
(:func:`bias_relu_pool_`), and the decoder's concatenation +
folded-BatchNorm affine + ReLU (:func:`cat_affine_relu`).

Replaces no TPU kernel: XLA fused these ops into the convs'
outputs (``satellite_computervision_tpu/models/blocks.py``). In eager
PyTorch each is its own pass over the activation, and those passes took
more of the served U-Net's device time than its convs. The kernel is bound
by bytes; ``csrc/conv_epilogue.cu`` says how its design meets that.

- On a CUDA tensor each wrapper launches the hand-written kernel in
  ``csrc/conv_epilogue.cu`` (built by ``kernels/_build.py``) or raises.
- On a CPU tensor it runs the plain PyTorch version, the op sequence the
  kernel replaces, which the tests and ``chip_smoke.py`` hold the kernel
  against.

All take NCHW-shaped activations in channels-last memory, bfloat16 or
float32, with channel counts that are multiples of 8 (a 16-byte vector
then lies in one pixel and one source).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
# channel vectors of one pixel a block holds (kMaxSlots in the source)
_MAX_SLOTS = 1024


def _channels_ok(c: int, dtype: torch.dtype) -> bool:
    return c > 0 and c % 8 == 0 and c * dtype.itemsize <= 16 * _MAX_SLOTS


def _layout_fault(x: torch.Tensor) -> str | None:
    """Why the kernels cannot take ``x`` as an activation whatever its
    channel count, or None: it must be a 4-D bfloat16 or float32 tensor in
    channels-last memory."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        return f"must be a 4-D bfloat16 or float32 tensor, got {tuple(x.shape)} {x.dtype}"
    if not x.is_contiguous(memory_format=torch.channels_last):
        return "must be channels-last contiguous"
    return None


def takes(x: torch.Tensor, *channels: int) -> bool:
    """Whether the kernels take activations like ``x`` at sites of
    ``channels`` channels: ``x`` a CUDA tensor of the layout they read
    (``_layout_fault``), and each count a multiple of 8 that a block
    holds."""
    return (x.is_cuda and _layout_fault(x) is None
            and all(_channels_ok(c, x.dtype) for c in channels))


def _check_activation(name: str, x: torch.Tensor) -> None:
    fault = _layout_fault(x)
    if fault is not None:
        raise ValueError(f"{name} {fault}")
    if not _channels_ok(x.shape[1], x.dtype):
        raise ValueError(f"{name} has {x.shape[1]} channels; the kernel takes multiples of 8 "
                         f"up to {16 * _MAX_SLOTS // x.dtype.itemsize}")
    if x.is_cuda and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_vector(name: str, v: torch.Tensor, n: int, like: torch.Tensor) -> None:
    if v.shape != (n,) or v.dtype != like.dtype or v.device != like.device:
        raise ValueError(f"{name} must be ({n},) {like.dtype} on {like.device}, "
                         f"got {tuple(v.shape)} {v.dtype} on {v.device}")


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


# each kernel's C arguments before the stream: pointers, then sizes
_ARGTYPES = {
    "bias_relu": [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int],
    "bias_relu_pool": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int],
    "cat_affine_relu": [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int],
}


@functools.lru_cache(maxsize=None)
def _entry(name: str, dtype: torch.dtype):
    """The C entry point of kernel ``name`` for ``dtype``, built and loaded
    at the first call."""
    from satellite_computervision_tpu_torch.kernels import _build

    fn = getattr(_build.load("conv_epilogue"), f"{name}_{_DTYPES[dtype]}")
    fn.argtypes = _ARGTYPES[name] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, x: torch.Tensor, *args) -> None:
    fn = _entry(name, x.dtype)
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def _pixels(x: torch.Tensor) -> int:
    b, _, h, w = x.shape
    return b * h * w


def bias_relu_reference(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in place: ``relu(y + bias[c])``, the add
    rounded to ``y``'s type as a conv's bias add rounds it."""
    return y.add_(bias.view(1, -1, 1, 1)).relu_()


def bias_relu_(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``y = relu(y + bias[c])`` in place on a conv's output ``y`` (B, C,
    H, W), channels-last; returns ``y``.

    CUDA tensors go through the hand-written kernel (each launch adds one
    to ``bias_relu_.launches``); CPU tensors through
    :func:`bias_relu_reference`."""
    _check_device("bias_relu_", y)
    _check_activation("y", y)
    _check_vector("bias", bias, y.shape[1], y)
    if y.device.type == "cpu":
        return bias_relu_reference(y, bias)
    bias = bias.contiguous()
    _launch("bias_relu", y, y.data_ptr(), bias.data_ptr(), _pixels(y), y.shape[1])
    bias_relu_.launches += 1
    return y


bias_relu_.launches = 0


def bias_relu_pool_reference(y: torch.Tensor, bias: torch.Tensor):
    """Plain PyTorch version: :func:`bias_relu_reference` in place, then
    ``max_pool2d(y, 2, 2)``; returns ``(pooled, y)``."""
    y = bias_relu_reference(y, bias)
    return F.max_pool2d(y, 2, 2), y


def bias_relu_pool_(y: torch.Tensor, bias: torch.Tensor):
    """``y = relu(y + bias[c])`` in place on a conv's output ``y`` (B, C,
    H, W), channels-last with H and W even, and its 2x2 stride-2 max-pool
    as a new (B, C, H/2, W/2) channels-last tensor; returns ``(pooled,
    y)``, bit-equal to :func:`bias_relu_` then ``F.max_pool2d(y, 2, 2)``
    (NaN and signed zeros as ATen's pool takes them) and with no indices.

    CUDA tensors go through the hand-written kernel (each launch adds one
    to ``bias_relu_pool_.launches``); CPU tensors through
    :func:`bias_relu_pool_reference`."""
    _check_device("bias_relu_pool_", y)
    _check_activation("y", y)
    _check_vector("bias", bias, y.shape[1], y)
    b, c, h, w = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"y is {h}x{w}; the 2x2 pool takes even sides")
    if y.device.type == "cpu":
        return bias_relu_pool_reference(y, bias)
    pooled = torch.empty((b, c, h // 2, w // 2), dtype=y.dtype, device=y.device,
                         memory_format=torch.channels_last)
    bias = bias.contiguous()
    _launch("bias_relu_pool", y, y.data_ptr(), bias.data_ptr(), pooled.data_ptr(),
            b * h // 2, w, c)
    bias_relu_pool_.launches += 1
    return pooled, y


bias_relu_pool_.launches = 0


def cat_affine_relu_reference(skip: torch.Tensor, up: torch.Tensor, up_bias: torch.Tensor,
                              scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the up-bias add, ``cat``, ``* scale``,
    ``+ shift`` and ``relu``, each rounded to the inputs' type."""
    x = torch.cat([skip, up + up_bias.view(1, -1, 1, 1)], dim=1)
    return F.relu(x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1))


def cat_affine_relu(skip: torch.Tensor, up: torch.Tensor, up_bias: torch.Tensor,
                    scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The decoder's ``relu(cat([skip, up + up_bias]) * scale + shift)``
    as a new (B, Cs + Cu, H, W) channels-last tensor: ``skip`` (B, Cs, H, W)
    and ``up`` (B, Cu, H, W), the transposed conv's output without its bias
    ``up_bias`` (Cu,); ``scale`` and ``shift`` (Cs + Cu,).

    CUDA tensors go through the hand-written kernel (each launch adds one
    to ``cat_affine_relu.launches``); CPU tensors through
    :func:`cat_affine_relu_reference`."""
    _check_device("cat_affine_relu", skip)
    _check_activation("skip", skip)
    _check_activation("up", up)
    if (up.dtype != skip.dtype or up.device != skip.device
            or up.shape[0] != skip.shape[0] or up.shape[2:] != skip.shape[2:]):
        raise ValueError(f"up {tuple(up.shape)} {up.dtype} on {up.device} does not match "
                         f"skip {tuple(skip.shape)} {skip.dtype} on {skip.device}")
    c_skip, c_up = skip.shape[1], up.shape[1]
    if not _channels_ok(c_skip + c_up, skip.dtype):
        raise ValueError(f"{c_skip} + {c_up} channels: more than a block holds")
    _check_vector("up_bias", up_bias, c_up, skip)
    _check_vector("scale", scale, c_skip + c_up, skip)
    _check_vector("shift", shift, c_skip + c_up, skip)
    if skip.device.type == "cpu":
        return cat_affine_relu_reference(skip, up, up_bias, scale, shift)
    b, _, h, w = skip.shape
    out = torch.empty((b, c_skip + c_up, h, w), dtype=skip.dtype, device=skip.device,
                      memory_format=torch.channels_last)
    up_bias, scale, shift = up_bias.contiguous(), scale.contiguous(), shift.contiguous()
    _launch("cat_affine_relu", skip, skip.data_ptr(), up.data_ptr(), up_bias.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(), _pixels(skip), c_skip, c_up)
    cat_affine_relu.launches += 1
    return out


cat_affine_relu.launches = 0


def launches() -> int:
    """Launches of the three kernels so far in this process."""
    return bias_relu_.launches + bias_relu_pool_.launches + cat_affine_relu.launches
