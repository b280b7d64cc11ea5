"""Plain PyTorch layers shared by the references: convolutions, BatchNorm
and the precision they compute in.

A reference model is a function of a dict of tensors named as the
program's ``state_dict`` names them. Nothing here imports the program.

``Ops(precision)``:

- ``"float32"``: every convolution in float32 with TF32 off (see
  :func:`exact_float32`);
- ``"float8"``: the control, one step below the bfloat16 that the
  configurations serve and train in, as float8 training recipes compute:
  each convolution's input, weight and output are held in float8 e4m3,
  and in a backward pass the gradients reaching its output and leaving
  its input in e5m2, each with one scale per tensor (its largest
  magnitude over the format's largest finite value); the products are
  taken in float32 from those values. The program holds the same
  tensors in bfloat16. Everything else stays float32.

BatchNorm takes ``mode``:

- ``"eval"``: the running statistics;
- ``"train"``: the batch's mean and biased variance, which is what a
  training step normalizes by;
- ``"calibrate"``: as ``"train"``, and the batch's statistics are written
  into the running ones (used once when weights are made, so that a
  served model with drawn weights normalizes every layer to unit scale).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_float8(t: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = E4M3_MAX):
    """``t`` rounded to a float8 format under one per-tensor scale, back
    in ``t``'s dtype."""
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Float8Conv(torch.autograd.Function):
    """A convolution of e4m3-rounded input and weight, its output held in
    e4m3; backward takes the e5m2-rounded output gradient and hands back
    the input's gradient in e5m2."""

    @staticmethod
    def forward(ctx, x, w, b, conv):
        xq, wq = round_float8(x.detach()), round_float8(w.detach())
        ctx.save_for_backward(xq, wq, b)
        ctx.conv = conv
        return round_float8(conv(xq, wq, b))

    @staticmethod
    def backward(ctx, grad):
        xq, wq, b = ctx.saved_tensors
        grad = round_float8(grad, torch.float8_e5m2, E5M2_MAX)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if t is not None else None for t in (xq, wq, b)]
            out = ctx.conv(*leaves)
            wanted = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        gx, gw = next(grads), next(grads)
        gx = round_float8(gx, torch.float8_e5m2, E5M2_MAX)
        return gx, gw, (next(grads) if b is not None else None), None


class Ops:
    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def _run(self, conv, x, w, b):
        if self.precision == "float8":
            return _Float8Conv.apply(x, w, b, conv)
        return conv(x, w, b)

    def conv(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return self._run(lambda x, w, b: F.conv2d(x, w, b, stride=stride, padding=padding,
                                                  dilation=dilation), x, w, b)

    def conv_transpose(self, x, w, b, stride):
        return self._run(lambda x, w, b: F.conv_transpose2d(x, w, b, stride=stride), x, w, b)


def batch_norm(x, p, prefix: str, eps: float, mode: str):
    """BatchNorm of an NCHW tensor with the tensors ``<prefix>.weight``,
    ``.bias``, ``.running_mean`` and ``.running_var`` of ``p``."""
    gamma, beta = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    if mode == "eval":
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    elif mode in ("train", "calibrate"):
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        if mode == "calibrate":
            with torch.no_grad():
                p[f"{prefix}.running_mean"].copy_(mean)
                p[f"{prefix}.running_var"].copy_(var)
    else:
        raise ValueError(f"unknown BatchNorm mode {mode!r}")
    scale = gamma / torch.sqrt(var + eps)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] + beta[None, :, None, None]


def conv_spec(name: str, out_ch: int, in_ch: int, k: int, bias: bool = True):
    """Parameter specs of a conv: ``(name, shape, kind, fan_in)``."""
    specs = [(f"{name}.weight", (out_ch, in_ch, k, k), "weight", in_ch * k * k)]
    if bias:
        specs.append((f"{name}.bias", (out_ch,), "bias", 0))
    return specs


def conv_transpose_spec(name: str, in_ch: int, out_ch: int, k: int):
    """A stride-``k`` transposed conv: each output sees ``in_ch`` inputs."""
    return [(f"{name}.weight", (in_ch, out_ch, k, k), "weight", in_ch),
            (f"{name}.bias", (out_ch,), "bias", 0)]


def bn_spec(name: str, ch: int, residual: bool = False):
    """A BatchNorm's tensors; ``residual``: the last one of a residual
    branch, whose scale is drawn small (see ``perfbench.inputs``)."""
    return [(f"{name}.weight", (ch,), "bn_weight_residual" if residual else "bn_weight", 0),
            (f"{name}.bias", (ch,), "bn_bias", 0),
            (f"{name}.running_mean", (ch,), "bn_mean", 0),
            (f"{name}.running_var", (ch,), "bn_var", 0)]
