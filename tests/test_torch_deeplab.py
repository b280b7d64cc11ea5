"""The port's DeepLab v3+ (models/deeplab.py) against the JAX package's in
float32 on the CPU, with weights carried by ``flax_to_torch``, at ResNet
stages 1/1/1/1 and an ASPP of 32 (the JAX tests' size):

- eval-mode logits/probs at 64² and 72² (72²: odd sides below the stem
  and a non-integer resize, C5 of 5² to C2 of 18²) within 1e-5 x
  max|logit|;
- train-mode forwards at batch 2 and 1 (at batch 1 the image-pooling
  branch normalizes one value per channel): logits at rtol 1e-5 with atol
  3e-5 x max|logit| (flax's one-pass variance E[x²] - E[x]² against
  torch's two-pass one), the updated running statistics at rtol 1e-5
  with atol 1e-5 x max|statistic| (some means sit near 0);
- one Adam step of both packages' train steps on the parking loss (the
  float32 loss at rtol 1e-5; gradients, weights and statistics after the
  step in float64, where the comparison is not at the mercy of ReLU
  inputs within rounding of 0);
- the SAME padding and bilinear resize against XLA's and
  ``jax.image.resize`` at even and odd sides;
- the zoo's deeplab family and the checkpoint's ``arch``.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

from satellite_computervision_tpu.models import DeepLabV3Plus as JaxDeepLab
from satellite_computervision_tpu.train import zoo as jzoo
from satellite_computervision_tpu.train.config import PARKING_CONFIG as JAX_PARKING
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu.train.trainer import make_train_step as jax_make_train_step
from satellite_computervision_tpu_torch.models import DeepLabV3Plus, flax_to_torch
from satellite_computervision_tpu_torch.models.blocks import BatchNorm
from satellite_computervision_tpu_torch.models.deeplab import (
    SameConv2d,
    max_pool_same,
    resize_bilinear,
    same_pads,
)
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import (
    build_empty,
    load_checkpoint,
    save_checkpoint,
)
from satellite_computervision_tpu_torch.train.config import PARKING_CONFIG
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

SMALL = dict(stage_sizes=(1, 1, 1, 1), aspp_features=32)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The suite runs in several worker processes (pytest-xdist) on one
    host; torch's default of a thread per core in each of them
    oversubscribes the CPU, and these CPU-bound tests then run several
    times slower. Two threads per process while the module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_variables(shapes, rng):
    """A flax variable tree of ``shapes`` (from ``jax.eval_shape``) filled
    from ``rng``: He-normal kernels, BN scales near 1, small biases and
    means, variances in [0.5, 1.5]."""
    def param(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    def stat(path, s):
        if path[-1].key == "mean":
            return (rng.normal(size=s.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, shapes["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"])}


@pytest.fixture(scope="module")
def jax_deeplab():
    jmodel = JaxDeepLab(n_classes=1, **SMALL)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    return jmodel, random_variables(shapes, np.random.default_rng(6))


def _bridged(v, **kw):
    model = build_empty(DeepLabV3Plus, 3, **SMALL, **kw)
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model), assign=True)
    return model


@pytest.mark.parametrize("side", [64, 72])
def test_eval_forward_matches_jax(jax_deeplab, rng, side):
    jmodel, v = jax_deeplab
    x = rng.normal(size=(2, side, side, 3)).astype(np.float32)
    want = jax.jit(jmodel.apply)(v, x)
    with torch.no_grad():
        got = _bridged(v).eval()(torch.from_numpy(x))
    scale = float(np.abs(want["logits"]).max())
    assert scale > 1.0  # not a saturated or dead map
    for key in ("logits", "probs"):
        assert got[key].dtype == torch.float32 and got[key].shape == (2, side, side, 1)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=1e-5 * scale)
    assert got["classes"].dtype == torch.int32
    # a probability within float noise of the threshold may flip
    assert np.mean(got["classes"].numpy() != np.asarray(want["classes"])) < 1e-3


@pytest.mark.parametrize("batch", [2, 1])
def test_train_forward_and_running_stats_match_jax(jax_deeplab, rng, batch):
    jmodel, v = jax_deeplab
    x = rng.normal(size=(batch, 64, 64, 3)).astype(np.float32)
    want, mutated = jax.jit(lambda v, x: jmodel.apply(v, x, train=True,
                                                      mutable=["batch_stats"]))(v, x)
    model = _bridged(v).train()
    got = model(torch.from_numpy(x))["logits"].detach().numpy()
    want_logits = np.asarray(want["logits"])
    np.testing.assert_allclose(got, want_logits, rtol=1e-5,
                               atol=3e-5 * np.abs(want_logits).max())
    stats = flax_to_torch(v["params"], jax.device_get(mutated["batch_stats"]), model)
    n_bn = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            want_stat = stats[name].numpy()
            np.testing.assert_allclose(buf.numpy(), want_stat, rtol=1e-5,
                                       atol=1e-5 * np.abs(want_stat).max(), err_msg=name)
            n_bn += 1
    assert n_bn == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_batch_norm_of_one_value_per_channel_matches_flax(rng):
    """A (1, 1, 1, C) batch: flax gives the bias, zero gradients to the
    input and the scale, and a running variance updated with 0."""
    x = rng.normal(size=(1, 1, 1, 5)).astype(np.float32)
    stats = {"mean": rng.normal(size=5).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 5).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": rng.normal(size=5).astype(np.float32)}
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)

    def jloss(params, x):
        y, mut = jbn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return (y * np.arange(1, 6)).sum(), (y, mut["batch_stats"])

    (_, (want, want_stats)), (gp, gx) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        params, x)
    bn = BatchNorm(5, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn.train()(xt)
    (y.permute(0, 2, 3, 1) * torch.arange(1, 6)).sum().backward()
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want))
    np.testing.assert_array_equal(y.detach().flatten().numpy(), params["bias"])
    np.testing.assert_array_equal(xt.grad.numpy(), 0.0)
    np.testing.assert_array_equal(bn.weight.grad.numpy(), np.asarray(gp["scale"]))
    np.testing.assert_array_equal(bn.bias.grad.numpy(), np.asarray(gp["bias"]))
    np.testing.assert_array_equal(np.asarray(gx), 0.0)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want_stats["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want_stats["var"]),
                               rtol=1e-6)


def test_one_adam_step_matches_jax(jax_deeplab, rng):
    """One step of both packages' ``make_train_step`` on a batch of 2 with
    the deeplab family's loss (weighted BCE, the parking preset's
    pos_weight 20) and Adam 9e-4, in float64 on both sides (the logits
    still cast to float32, as both models do): the gradients within 1e-6 x
    the largest of their tensor, the running statistics at rtol 1e-6, the
    updated weights within 1e-6 where the gradient is clear of 0. In
    float32 the port's step gives the same loss (rtol 1e-5), but the
    gradients of either package stray from float64 by up to a few
    percent on this batch: a ReLU whose input lies within rounding of 0
    passes or stops a gradient term depending on the last bit (and flax's
    one-pass variance E[x²] - E[x]² adds its own cancellation). The JAX
    gradients are read back from Adam's first moment (``mu = 0.1 g`` after
    one step)."""
    jmodel, v = jax_deeplab
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    y = (x[..., :1] + 0.5 * x[..., 1:2] > 0.8).astype(np.float32)
    jloss_fn, jkey = jzoo.get_family("deeplab").loss(JAX_PARKING)
    lr = PARKING_CONFIG.learning_rate
    with jax.enable_x64(True):
        jmodel64 = JaxDeepLab(n_classes=1, dtype=jnp.float64, **SMALL)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        tx = optax.adam(lr)
        jstate = TrainState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                            batch_stats=v64["batch_stats"], opt_state=tx.init(v64["params"]),
                            apply_fn=jmodel64.apply, tx=tx)
        jstate, jout = jax_make_train_step(jloss_fn, jkey, donate=False)(
            jstate, (jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)))
        jout = jax.device_get(jout)
        want_grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                            jax.device_get(jstate.opt_state[0].mu))
        want_params = jax.device_get(jstate.params)
        want_stats = jax.device_get(jstate.batch_stats)

    loss_fn, key = zoo.get_family("deeplab").loss(PARKING_CONFIG)
    assert key == jkey == "logits"
    step = make_train_step(loss_fn, key)
    out32 = step(create_train_state(_bridged(v), lr), (torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(float(out32["loss"]), float(jout["loss"]), rtol=1e-5)

    model = _bridged(v).double()
    state = create_train_state(model, lr)
    out = step(state, (torch.from_numpy(x).double(), torch.from_numpy(y).double()))
    # both models cast the logits to float32, so the loss is a float32 sum
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-6)
    np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))
    assert state.step == 1

    def as_torch(params, stats):  # float64 trees into the port's keys
        return flax_to_torch(*(jax.tree_util.tree_map(np.float64, t) for t in (params, stats)),
                             model)

    grads = flax_to_torch(want_grads, v["batch_stats"], model)
    stepped = flax_to_torch(want_params, want_stats, model)
    for name, p in model.named_parameters():
        want_g = grads[name].numpy()
        g_scale = np.abs(want_g).max()
        # (+1e-12: a conv bias ahead of a train-mode BN has a gradient of 0)
        np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0,
                                   atol=1e-6 * g_scale + 1e-12, err_msg=name)
        # Adam's first step moves each weight by lr * g / (|g| + eps): by
        # lr where the gradient is clear of 0
        clear = np.abs(want_g) > 1e-6 * g_scale
        np.testing.assert_allclose(p.detach().numpy()[clear], stepped[name].numpy()[clear],
                                   rtol=0, atol=1e-6, err_msg=name)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stepped[name].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=name)


@pytest.mark.parametrize("kernel,stride,dilation", [(7, 2, 1), (3, 2, 1), (1, 2, 1),
                                                    (3, 1, 2), (3, 1, 1), (1, 1, 1)])
def test_same_pads_match_xla(kernel, stride, dilation):
    for side in (4, 5, 18, 63, 64, 65, 72, 73, 512, 768):
        want = jax.lax.padtype_to_pads((side,), ((kernel - 1) * dilation + 1,), (stride,),
                                       "SAME")[0]
        assert same_pads(side, kernel, stride, dilation) == tuple(want), side


@pytest.mark.parametrize("side", [16, 17, 18, 19])
def test_strided_conv_and_pool_match_flax(rng, side):
    """The stem's 7x7 stride-2 conv, a stage's 3x3 stride-2 conv and the
    3x3 stride-2 max-pool on even and odd sides (the pool's pad is -inf:
    the inputs are all negative)."""
    x = rng.normal(size=(2, side, side, 3)).astype(np.float32) - 5.0
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for k in (7, 3):
        conv = fnn.Conv(4, (k, k), strides=(2, 2), padding="SAME", use_bias=False)
        kern = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
        want = np.asarray(conv.apply({"params": {"kernel": kern}}, x))
        mod = SameConv2d(3, 4, k, stride=2)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()))
            got = mod(xt).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, -(-side // 2), -(-side // 2), 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    want = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", [(5, 18), (4, 16), (18, 72), (3, 7), (16, 64), (9, 9)])
def test_resize_matches_jax_image(rng, src, dst):
    x = rng.normal(size=(2, src, src + 1, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, dst, dst + 3, 3), method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst + 3))
    # float32 rounding of the weighted sums
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("classes", [1, 3])
def test_zoo_deeplab_family_matches_jax(classes):
    from satellite_computervision_tpu.train.config import CONFIGS as JAX_CONFIGS

    for k in (512, 32):
        cfg = dataclasses.replace(PARKING_CONFIG, kernel_size=k, num_classes=classes)
        jcfg = dataclasses.replace(JAX_CONFIGS["parking"], kernel_size=k, num_classes=classes)
        fam, jfam = zoo.get_family("deeplab"), jzoo.get_family("deeplab")
        ((xs,), (jx,)) = fam.example_inputs(cfg), jfam.example_inputs(jcfg)
        assert xs.shape == np.shape(jx) == (1, max(64, k), max(64, k), 3)
    # shapes only: the model and its forward on the meta device
    model = build_empty(fam.build, cfg, **SMALL)
    assert isinstance(model, DeepLabV3Plus) and model.threshold == cfg.threshold
    assert model.head_kind == ("sigmoid" if classes == 1 else "softmax")
    with torch.no_grad():
        out = model.eval()(torch.zeros((1, 64, 64, 3), device="meta"))
    assert out["logits"].shape == (1, 64, 64, classes)
    assert out["classes"].shape == ((1, 64, 64, 1) if classes == 1 else (1, 64, 64))
    (loss_fn, key), (jloss_fn, jkey) = fam.loss(cfg), jfam.loss(jcfg)
    assert key == jkey == "logits"
    rng = np.random.default_rng(0)
    y = (rng.uniform(size=(2, 8, 8, classes)) > 0.8).astype(np.float32)
    p = rng.normal(0, 3, y.shape).astype(np.float32)
    np.testing.assert_allclose(loss_fn(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
                               np.asarray(jloss_fn(y, p)), rtol=1e-5, atol=1e-6)
    full = build_empty(fam.build, PARKING_CONFIG)
    assert full.kwargs["stage_sizes"] == (3, 4, 6, 3) and full.kwargs["aspp_rates"] == (6, 12, 18)
    assert full.aspp.ConvBNAct_0.Conv_0.out_channels == 256 and full.backbone.out_channels == 2048
    # the ASPP keeps the blocks' BN, the rest the ResNet's
    assert full.aspp.ConvBNAct_5.BatchNorm_0.eps == 1e-3
    assert full.aspp.ConvBNAct_5.BatchNorm_0.momentum == pytest.approx(0.01)
    assert full.low_bn.eps == 1e-5 and full.decoder_bn1.momentum == pytest.approx(0.1)
    assert full.backbone.stage3_block5.bn2.eps == 1e-5


def test_checkpoint_records_deeplab(jax_deeplab, tmp_path, rng):
    model = _bridged(jax_deeplab[1], threshold=0.3).eval()
    save_checkpoint(str(tmp_path), model, {"step": 1})
    blob = torch.load(tmp_path / "best" / "model.pt", weights_only=True)
    assert blob["arch"] == "deeplab"
    loaded, meta = load_checkpoint(str(tmp_path))
    assert isinstance(loaded, DeepLabV3Plus) and meta == {"step": 1}
    assert loaded.kwargs == model.kwargs
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(loaded(x)["logits"], model(x)["logits"], rtol=0, atol=0)
