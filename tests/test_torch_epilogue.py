"""The conv-epilogue kernels' plain versions (``kernels/epilogue.py``) and
the folded U-Net's route through them, on the CPU.

The plain versions are what the CUDA kernels are held to on the card
(``tests/test_torch_cuda.py``), so each is checked here bit for bit
against the op sequence it replaces, NaN, signed zeros and negatives
included. The model takes the kernels only on the card; here the gate is
opened by hand to check the route's control flow and its site count.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch import kernels
from satellite_computervision_tpu_torch.kernels import epilogue, preprocess, stitch
from satellite_computervision_tpu_torch.models import UNet, fold_unet
from satellite_computervision_tpu_torch.models.blocks import (ConvBNAct, EncoderBlock,
                                                              epilogue_route)
from satellite_computervision_tpu_torch.utils.profiling import span_log

DTYPES = [torch.bfloat16, torch.float32]


def _bits(x):
    """The tensor's bit patterns, so NaN payloads and signed zeros compare."""
    return x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _hard(shape, dtype, seed):
    """Normals with NaN, +-0, +-inf and large negatives planted, channels-last."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(scale=3.0, size=shape).astype(np.float32))
    flat = x.view(-1)
    n = flat.numel()
    idx = torch.from_numpy(rng.permutation(n)[: max(n // 8, 6)])
    specials = torch.tensor([float("nan"), 0.0, -0.0, float("inf"), -float("inf"), -1e30])
    flat[idx] = specials[torch.arange(idx.numel()) % specials.numel()]
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _vector(n, dtype, seed, zeros=True):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    if zeros and n >= 4:
        v[:4] = torch.tensor([0.0, -0.0, -5.0, float("nan")])
    return v.to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 8, 3, 5), (1, 32, 4, 4), (3, 24, 1, 1)])
def test_bias_relu_plain_is_the_op_sequence_bit_for_bit(dtype, shape):
    y = _hard(shape, dtype, seed=shape[1])
    y[0, 1, 0, 0] = -0.0  # on the bias's -0: a sum of -0
    bias = _vector(shape[1], dtype, seed=1)
    want = F.relu(y + bias[:, None, None])
    before = epilogue.launches()
    got = epilogue.bias_relu_(y.clone(memory_format=torch.channels_last), bias)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(got).any()
    assert epilogue.launches() == before  # the CPU launches nothing


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(2, 8, 4, 6), (1, 32, 2, 4), (3, 24, 6, 4)])
def test_bias_relu_pool_plain_is_the_op_sequence_bit_for_bit(dtype, shape):
    y = _hard(shape, dtype, seed=shape[1] + 1)
    # one window holding -0 and +0 after the bias's -0 (channel 1), NaN in
    # the next window of the same channel, and -0 before +0 in a third
    y[0, 1, 0:2, 0:2] = torch.tensor([[-0.0, 0.0], [-3.0, -0.0]], dtype=dtype)
    y[0, 1, 0:2, 2:4] = torch.tensor([[1.0, float("nan")], [2.0, -0.0]], dtype=dtype)
    y[-1, 1, -2:, -2:] = torch.tensor([[0.0, -0.0], [float("nan"), 5.0]], dtype=dtype)
    bias = _vector(shape[1], dtype, seed=2)
    relu = F.relu(y + bias[:, None, None])
    want = F.max_pool2d(relu, 2, 2)
    before = epilogue.launches()
    pooled, got_y = epilogue.bias_relu_pool_(y.clone(memory_format=torch.channels_last), bias)
    assert pooled.shape == (shape[0], shape[1], shape[2] // 2, shape[3] // 2)
    assert torch.equal(_bits(pooled), _bits(want))
    assert torch.equal(_bits(got_y), _bits(relu))
    assert torch.isnan(pooled[0, 1, 0, 1]) and torch.isnan(pooled[-1, 1, -1, -1])
    assert epilogue.launches() == before  # the CPU launches nothing


def test_bias_relu_pool_is_in_place_on_its_input():
    y = _hard((2, 16, 4, 4), torch.float32, seed=3)
    pooled, skip = epilogue.bias_relu_pool_(y, _vector(16, torch.float32, seed=4))
    assert skip is y and pooled.shape == (2, 16, 2, 2)


def test_bias_relu_is_in_place():
    y = _hard((2, 16, 3, 3), torch.float32, seed=2)
    assert epilogue.bias_relu_(y, _vector(16, torch.float32, seed=3)) is y


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("c_skip,c_up,hw", [(8, 8, (3, 5)), (16, 8, (2, 2)), (32, 32, (1, 1))])
def test_cat_affine_relu_plain_is_the_op_sequence_bit_for_bit(dtype, c_skip, c_up, hw):
    skip = _hard((2, c_skip, *hw), dtype, seed=c_skip)
    up = _hard((2, c_up, *hw), dtype, seed=c_up + 1)
    up_bias = _vector(c_up, dtype, seed=4)
    scale = _vector(c_skip + c_up, dtype, seed=5)
    shift = _vector(c_skip + c_up, dtype, seed=6)
    # the parent's decoder: the transposed conv's bias add, cat, mul, add, relu
    x = torch.cat([skip, up + up_bias[:, None, None]], dim=1)
    want = F.relu(x * scale[:, None, None] + shift[:, None, None])
    got = epilogue.cat_affine_relu(skip, up, up_bias, scale, shift)
    assert got.shape == (2, c_skip + c_up, *hw) and got.dtype == dtype
    assert torch.equal(_bits(got), _bits(want))


def _cl(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("case", ["channels", "layout", "bias_shape", "bias_dtype", "float64",
                                  "three_dims"])
def test_bias_relu_rejects_what_the_kernel_cannot_take(case):
    y, bias = _cl((2, 16, 4, 4)), torch.zeros(16)
    if case == "channels":
        y, bias = _cl((2, 12, 4, 4)), torch.zeros(12)
    elif case == "layout":
        y = torch.zeros((2, 16, 4, 4))
    elif case == "bias_shape":
        bias = torch.zeros(8)
    elif case == "bias_dtype":
        bias = torch.zeros(16, dtype=torch.bfloat16)
    elif case == "float64":
        y, bias = _cl((2, 16, 4, 4), torch.float64), torch.zeros(16, dtype=torch.float64)
    else:
        y = torch.zeros((16, 4, 4))
    with pytest.raises(ValueError):
        epilogue.bias_relu_(y, bias)


@pytest.mark.parametrize("case", ["odd_height", "odd_width", "layout", "channels",
                                  "past_a_block", "bias_shape", "float64"])
def test_bias_relu_pool_rejects_what_the_kernel_cannot_take(case):
    y, bias = _cl((2, 16, 4, 4)), torch.zeros(16)
    if case == "odd_height":
        y = _cl((2, 16, 5, 4))
    elif case == "odd_width":
        y = _cl((2, 16, 4, 3))
    elif case == "layout":
        y = torch.zeros((2, 16, 4, 4))
    elif case == "channels":
        y, bias = _cl((2, 12, 4, 4)), torch.zeros(12)
    elif case == "past_a_block":  # 2048 float32 vectors a pixel
        y, bias = _cl((1, 8192, 2, 2)), torch.zeros(8192)
    elif case == "bias_shape":
        bias = torch.zeros(8)
    else:
        y, bias = _cl((2, 16, 4, 4), torch.float64), torch.zeros(16, dtype=torch.float64)
    with pytest.raises(ValueError):
        epilogue.bias_relu_pool_(y, bias)


@pytest.mark.parametrize("case", ["skip_channels", "up_channels", "skip_layout", "up_layout",
                                  "batch", "height", "dtype", "up_bias", "scale", "shift",
                                  "past_a_block"])
def test_cat_affine_relu_rejects_what_the_kernel_cannot_take(case):
    args = dict(skip=_cl((2, 16, 4, 4)), up=_cl((2, 8, 4, 4)), up_bias=torch.zeros(8),
                scale=torch.ones(24), shift=torch.zeros(24))
    if case == "skip_channels":
        args.update(skip=_cl((2, 12, 4, 4)), scale=torch.ones(20), shift=torch.zeros(20))
    elif case == "up_channels":
        args.update(up=_cl((2, 4, 4, 4)), up_bias=torch.zeros(4), scale=torch.ones(20),
                    shift=torch.zeros(20))
    elif case == "skip_layout":
        args["skip"] = torch.zeros((2, 16, 4, 4))
    elif case == "up_layout":
        args["up"] = torch.zeros((2, 8, 4, 4))
    elif case == "batch":
        args["up"] = _cl((1, 8, 4, 4))
    elif case == "height":
        args["up"] = _cl((2, 8, 5, 4))
    elif case == "dtype":
        args["up"] = _cl((2, 8, 4, 4), torch.bfloat16)
    elif case == "up_bias":
        args["up_bias"] = torch.zeros(16)
    elif case == "past_a_block":  # 4096 float32 channels each: 2048 vectors a pixel
        args.update(skip=_cl((1, 4096, 1, 1)), up=_cl((1, 4096, 1, 1)),
                    up_bias=torch.zeros(4096), scale=torch.ones(8192), shift=torch.zeros(8192))
    else:
        args[case] = torch.ones(16)
    with pytest.raises(ValueError):
        epilogue.cat_affine_relu(**args)


def test_takes_no_cpu_or_meta_activation():
    assert not epilogue.takes(_cl((2, 16, 4, 4)), 16)  # a CPU tensor: the unfused ops
    assert not epilogue.takes(torch.zeros((2, 16, 4, 4), device="meta"), 16)


def folded_unet(space_to_depth=False, filters=(32, 64, 128, 256, 512)):
    torch.manual_seed(0)
    net = UNet(6, n_classes=1, filters=filters, factors=(2,) * len(filters), head="sigmoid",
               space_to_depth=space_to_depth)
    with torch.no_grad():  # BatchNorm statistics and biases away from 0 and 1
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
    return fold_unet(net.eval())


def unfused_forward(net, x):
    """The folded U-Net's forward written out with the unfused ops: each
    conv with its bias, then ReLU; the decoder's cat, scale, shift, ReLU."""
    def conv_relu(conv, h):
        return F.relu(conv(h))

    h = x.to(net.head.weight.dtype)
    if net.space_to_depth:
        b, hh, ww, c = h.shape
        h = h.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        h = h.reshape(b, hh // 2, ww // 2, 4 * c)
    h = h.permute(0, 3, 1, 2)
    skips = []
    for i in range(net.levels):
        enc = getattr(net, f"EncoderBlock_{i}")
        for j in range(enc.ConvBlock_0.n_convs):
            h = conv_relu(getattr(enc.ConvBlock_0, f"ConvBNAct_{j}").Conv_0, h)
        skips.append(h)
        h = F.max_pool2d(h, enc.pool, enc.pool)
    for j in range(net.ConvBlock_0.n_convs):
        h = conv_relu(getattr(net.ConvBlock_0, f"ConvBNAct_{j}").Conv_0, h)
    for i, skip in enumerate(reversed(skips)):
        dec = getattr(net, f"DecoderBlock_{i}")
        h = torch.cat([skip, dec.ConvTranspose_0(h)], dim=1)
        h = F.relu(h * dec.affine_0_scale[:, None, None] + dec.affine_0_bias[:, None, None])
        h = conv_relu(dec.Conv_1, conv_relu(dec.Conv_0, h))
    if net.space_to_depth:
        h = conv_relu(net.stem_upsample, h)
    logits = net.head(h).float().permute(0, 2, 3, 1)
    return torch.sigmoid(logits)


def _input(side, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((2, side, side, 6), dtype=np.float32))


def test_folded_unet_on_the_cpu_takes_the_unfused_ops():
    net = folded_unet(filters=(8, 16))
    x = _input(16)
    before = (epilogue.bias_relu_.launches, epilogue.cat_affine_relu.launches)
    with torch.inference_mode():
        got = net(x)["probs"]
        want = unfused_forward(net, x)
    assert torch.equal(got, want)
    assert (epilogue.bias_relu_.launches, epilogue.cat_affine_relu.launches) == before


class _Spy:
    """Counts calls of a kernel wrapper, which the launch counters read as
    its launches, and runs its plain version."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    @property
    def launches(self):
        return self.calls

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def _spies(monkeypatch):
    """The three wrappers replaced by spies, the gate opened for CPU
    tensors; returns (bias_relu_, bias_relu_pool_, cat_affine_relu)."""
    spies = tuple(_Spy(getattr(epilogue, n))
                  for n in ("bias_relu_", "bias_relu_pool_", "cat_affine_relu"))
    monkeypatch.setattr(epilogue, "takes", lambda t, *c: t.device.type == "cpu")
    for n, spy in zip(("bias_relu_", "bias_relu_pool_", "cat_affine_relu"), spies):
        monkeypatch.setattr(epilogue, n, spy)
    return spies


@pytest.mark.parametrize("space_to_depth,side,sites", [(False, 32, 22), (True, 64, 23)],
                         ids=["plain-stem", "s2d-stem"])
def test_fused_route_has_every_site_and_the_unfused_result(monkeypatch, space_to_depth, side,
                                                           sites):
    """With the gate opened on the CPU, the solar U-Net's forward runs its
    conv sites (22; 23 with the space-to-depth stem's upsample) through
    ``bias_relu_`` or, at each encoder's pool, ``bias_relu_pool_``, and its
    5 decoders through ``cat_affine_relu``, and computes what the unfused
    ops compute (up to the CPU conv's own placement of the bias in its
    sum)."""
    net = folded_unet(space_to_depth)
    x = _input(side)
    with torch.inference_mode():
        want = net(x)["probs"]
    bias_relu, pool, cat = _spies(monkeypatch)
    with torch.inference_mode():
        got = net(x.contiguous())["probs"]
    assert (bias_relu.calls + pool.calls, cat.calls) == (sites, 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # no autograd recording is enough: the route is taken
        net(x)
    assert (bias_relu.calls + pool.calls, cat.calls) == (2 * sites, 10)


@pytest.mark.parametrize("space_to_depth,side,calls", [(False, 32, (17, 5, 5)),
                                                      (True, 64, (18, 5, 5))],
                         ids=["plain-stem", "s2d-stem"])
def test_fused_route_pools_in_every_encoder(monkeypatch, space_to_depth, side, calls):
    """With the gate opened on the CPU, each of the 5 encoders' last conv
    ends in ``bias_relu_pool_`` (17 ``bias_relu_``, 5 ``bias_relu_pool_``,
    5 ``cat_affine_relu``; 18 with the space-to-depth stem), and the
    forward computes the unfused forward's result."""
    net = folded_unet(space_to_depth)
    x = _input(side)
    with torch.inference_mode():
        want = unfused_forward(net, x)
    spies = _spies(monkeypatch)
    with torch.inference_mode():
        got = net(x)["probs"]
    assert tuple(s.calls for s in spies) == calls
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pool,side,fused", [(3, 12, False), (2, 7, False), (2, 8, True)],
                         ids=["factor-3", "odd-side", "even-factor-2"])
def test_only_an_even_2x2_pool_takes_the_pooling_kernel(monkeypatch, pool, side, fused):
    """A factor-3 pool (the hybrid's first) and an odd side keep
    ``bias_relu_`` then ``F.max_pool2d``; a 2x2 pool over even sides takes
    ``bias_relu_pool_``. Either way the block returns the unfused result."""
    torch.manual_seed(1)
    block = EncoderBlock(8, 16, pool=pool, fold_bn=True).eval()
    x = _hard((2, 8, side, side), torch.float32, seed=side).nan_to_num(0.0, 1e3, -1e3)
    with torch.inference_mode():
        h = x
        for i in range(2):
            h = F.relu(getattr(block.ConvBlock_0, f"ConvBNAct_{i}").Conv_0(h))
        want = (F.max_pool2d(h, pool, pool), h)
    bias_relu, pooled, _ = _spies(monkeypatch)
    max_pool = _Spy(F.max_pool2d)
    monkeypatch.setattr(F, "max_pool2d", max_pool)
    with torch.inference_mode():
        got = block(x)
    assert (bias_relu.calls, pooled.calls) == ((1, 1) if fused else (2, 0))
    assert max_pool.calls == 1  # the block's, or the plain version's inside the wrapper
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


def test_autocast_keeps_the_unfused_ops(monkeypatch):
    """A folded float32 U-Net served under bf16 autocast (as ``bench.py``'s
    predictor serves it): its convs return bf16 beside float32 biases and
    affines, so the gate stays shut, and the forward is the unfused ops'
    under the same autocast."""
    net = folded_unet(filters=(8, 16))
    x = _input(16)
    bias_relu, pool, cat = _spies(monkeypatch)
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = net(x)["probs"]
        want = unfused_forward(net, x)
    assert (bias_relu.calls, pool.calls, cat.calls) == (0, 0, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["parameter", "activation"])
def test_the_route_wants_one_dtype_for_parameters_and_activations(monkeypatch, case):
    monkeypatch.setattr(epilogue, "takes", lambda t, *c: True)
    block = ConvBNAct(8, 16, fold_bn=True)
    x = _cl((2, 8, 4, 4), torch.bfloat16)
    acts = (x, x)
    if case == "parameter":
        block = block.to(torch.bfloat16)
        block.Conv_0.bias.data = block.Conv_0.bias.data.float()
    else:
        block = block.to(torch.bfloat16)
        acts = (x, x.float())
    with torch.inference_mode():
        assert epilogue_route(block, True, (x, x), 16) == (case == "activation")
        assert not epilogue_route(block, True, acts, 16)


def test_launches_counts_every_hand_written_kernel(monkeypatch):
    monkeypatch.setattr(epilogue.bias_relu_, "launches", 3)
    monkeypatch.setattr(epilogue.bias_relu_pool_, "launches", 13)
    monkeypatch.setattr(epilogue.cat_affine_relu, "launches", 5)
    monkeypatch.setattr(preprocess.fused_preprocess, "launches", 7)
    monkeypatch.setattr(stitch.hann_stitch, "launches", 11)
    assert epilogue.launches() == 21
    assert kernels.launches() == 39


def test_training_and_live_batchnorm_never_take_the_route(monkeypatch):
    monkeypatch.setattr(epilogue, "takes", lambda t, *c: True)
    calls = []
    for name in ("bias_relu_", "bias_relu_pool_", "cat_affine_relu"):
        monkeypatch.setattr(epilogue, name, lambda *a: calls.append(a))
    folded = folded_unet(filters=(8, 16))
    x = _input(16)
    folded(x)["probs"].sum().backward()  # autograd recording: a training forward
    live = UNet(6, n_classes=1, filters=(8, 16), factors=(2, 2), head="sigmoid").eval()
    with torch.inference_mode():
        live(x)  # BatchNorm between the conv and its ReLU
    assert calls == []


def test_serve_forward_span_counts_the_launches_of_its_chip_batch():
    net = folded_unet(filters=(8, 16))
    engine = TiledInferenceEngine(lambda c: net(c)["probs"], kernel=16, buffer=8,
                                  batch_size=4, blend="hann", device="cpu")
    scene = np.random.default_rng(0).random((40, 50, 6), dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.predict_scene(scene)
    forwards = [s.attrs for s in span_log() if s.name == "serve.forward"]
    assert len(forwards) == 3  # 12 chips in batches of 4
    # the CPU launches no kernel
    assert all(a["kernels"] == 0 and a["pooled"] == 0 for a in forwards)


def test_serve_forward_span_counts_the_pooling_launches(monkeypatch):
    """With the gate opened on the CPU (each wrapper's calls counted as its
    launches), every chip batch of a 2-level U-Net carries ``kernels`` 12
    (8 ``bias_relu_``, 2 ``bias_relu_pool_``, 2 ``cat_affine_relu``) and
    ``pooled`` 2."""
    net = folded_unet(filters=(8, 16))
    engine = TiledInferenceEngine(lambda c: net(c.contiguous())["probs"], kernel=16, buffer=8,
                                  batch_size=4, blend="hann", device="cpu")
    scene = np.random.default_rng(0).random((40, 50, 6), dtype=np.float32)
    _spies(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.predict_scene(scene)
    forwards = [s.attrs for s in span_log() if s.name == "serve.forward"]
    assert len(forwards) == 3
    assert all(a["kernels"] == 12 and a["pooled"] == 2 for a in forwards)
