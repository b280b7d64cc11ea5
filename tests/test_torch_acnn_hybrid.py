"""The port's ACNN, hierarchical ACNN (models/acnn.py) and hybrid U-Net +
ConvLSTM (models/hybrid.py) against the JAX package's in float32 on the
CPU, with seeded weights carried by ``flax_to_torch``, at features 4-8,
8²-24² and T 3:

- eval forwards within 1e-5 x max|logit| (probabilities within 1e-5);
  train forwards within 3e-5 x max|logit| (flax's one-pass variance, as
  tests/test_torch_deeplab.py) and the updated running statistics at
  rtol 1e-5 with atol 1e-5 x max|statistic|;
- the gradients of one train-mode loss within 1e-3 x max|grad| of their
  tensor (plus 1e-6 x the largest gradient, for the conv biases ahead of a
  train-mode BN, whose true gradient is 0);
- ``blocks.resize_nearest`` equal to ``jax.image.resize(method="nearest")``
  at integer and non-integer ratios (torch's ``"nearest"`` is not: the
  hybrid's 9² -> 24² and 32² -> 240² show it), the hybrid held at a
  non-integer ratio;
- the factor-3 transposed conv: flax's SAME ``ConvTranspose`` gives
  ``out[3m + r] = x[m] k[2 - r]``, which the bridged ``ConvTranspose2d``
  reproduces;
- the default hybrid at the landcover preset's 256² fails in both
  packages (JAX in ``jax.eval_shape``, the port on the meta device) and
  builds at 240²;
- a fresh model of each family starts from flax's initialization.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from satellite_computervision_tpu.models import acnn as ja
from satellite_computervision_tpu.models import hybrid as jhy
from satellite_computervision_tpu.train import zoo as jzoo
from satellite_computervision_tpu.train.config import CONFIGS as JAX_CONFIGS
from satellite_computervision_tpu_torch.models import acnn as ta
from satellite_computervision_tpu_torch.models import flax_to_torch
from satellite_computervision_tpu_torch.models import hybrid as thy
from satellite_computervision_tpu_torch.models.blocks import DecoderBlock, resize_nearest
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import (
    build_empty,
    load_checkpoint,
    save_checkpoint,
)
from satellite_computervision_tpu_torch.train.config import CONFIGS
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401

B, C, S = 2, 3, 2  # batch, image bands, series bands


def _variables(jmod, rng, *args):
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), *args)
    return random_variables(shapes, rng)


def _bridged(model, v):
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    return model


def _case(name, rng):
    """(JAX model, port model, numpy inputs, output keys held)."""
    img = rng.normal(size=(B, 12, 12, C)).astype(np.float32)
    if name in ("acnn", "acnn_blocks3"):
        n_blocks = 2 if name == "acnn" else 3
        return (ja.ACNN(n_classes=5, n_blocks=n_blocks, features=6),
                ta.ACNN(C, 5, n_blocks=n_blocks, features=6), (img,), ("logits", "probs"))
    if name == "hierarchical":
        # the series at 5²: a non-integer resize ratio onto the 12² trunk
        series = rng.normal(size=(B, 3, 5, 5, S)).astype(np.float32)
        keys = tuple(f"{h}_{k}" for h in ("sub", "acnn", "lstm") for k in ("logits", "probs"))
        return (ja.HierarchicalACNN(n_classes=6, acnn_classes=5, sub_classes=3, n_blocks=4,
                                    features=4, lstm_features=5),
                ta.HierarchicalACNN(C, S, 6, 5, 3, n_blocks=4, features=4, lstm_features=5),
                (img, series), keys)
    # the hybrid: a U-Net of 24² pooled by 3 then 2, the series at 9²
    img = rng.normal(size=(B, 24, 24, C)).astype(np.float32)
    series = rng.normal(size=(B, 3, 9, 9, S)).astype(np.float32)
    kw = dict(filters=(4, 8), factors=(3, 2), lstm_features=5)
    return (jhy.HybridUNetLSTM(n_classes=4, **kw), thy.HybridUNetLSTM(C, S, 4, **kw),
            (img, series), ("logits", "probs"))


NAMES = ["acnn", "acnn_blocks3", "hierarchical", "hybrid"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(rng, name, train):
    jmod, mod, inputs, keys = _case(name, rng)
    v = _variables(jmod, rng, *inputs)
    if train:
        want, mutated = jax.jit(lambda v, *a: jmod.apply(
            v, *a, train=True, mutable=["batch_stats"]))(v, *inputs)
    else:
        want = jax.jit(jmod.apply)(v, *inputs)
    mod = _bridged(mod, v).train(train)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(a) for a in inputs))
    for key in keys:
        w = np.asarray(want[key])
        assert got[key].dtype == torch.float32 and got[key].shape == w.shape
        scale = max(np.abs(w).max(), 1.0) if key.endswith("logits") else 1.0
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=(3e-5 if train else 1e-5) * scale, err_msg=key)
    if "classes" in want:
        assert got["classes"].dtype == torch.int32
        assert np.mean(got["classes"].numpy() != np.asarray(want["classes"])) < 1e-3
    if train:
        stats = flax_to_torch(v["params"], jax.device_get(mutated["batch_stats"]), mod)
        n = 0
        for bname, buf in mod.named_buffers():
            if bname.endswith(("running_mean", "running_var")):
                w = stats[bname].numpy()
                np.testing.assert_allclose(buf.numpy(), w, rtol=1e-5,
                                           atol=1e-5 * np.abs(w).max(), err_msg=bname)
                n += 1
        assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in mod.modules())


@pytest.mark.parametrize("variant", [1, 2])
def test_trunk_variants_match_jax(rng, variant):
    """Variant 1 feeds each block's plain conv the previous block's raw
    dilated-conv output, variant 2 its activated output; every tap held."""
    x = rng.normal(size=(B, 10, 10, C)).astype(np.float32)
    jmod = ja.ACNNTrunk(n_blocks=3, features=5, variant=variant)
    v = _variables(jmod, rng, x)
    want = jmod.apply(v, x)
    mod = _bridged(ta.ACNNTrunk(C, n_blocks=3, features=5, variant=variant), v).eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert mod.dilated_conv_0_2.dilation == (3, 3)


@pytest.mark.parametrize("name", ["acnn", "hierarchical", "hybrid"])
def test_gradients_match_jax(rng, name):
    """Gradients of a train-mode cross entropy on every softmax head
    against one-hot targets."""
    jmod, mod, inputs, keys = _case(name, rng)
    v = _variables(jmod, rng, *inputs)
    v["params"] = jax.tree_util.tree_map(lambda a: a * 0.5, v["params"])
    probs = [k for k in keys if k.endswith("probs")]
    out = jax.jit(jmod.apply)(v, *inputs)
    targets = {k: np.eye(out[k].shape[-1], dtype=np.float32)[
        rng.integers(0, out[k].shape[-1], out[k].shape[:-1])] for k in probs}

    def jloss(params):
        o = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, *inputs, train=True,
                       mutable=["batch_stats"])[0]
        return sum(-jnp.sum(targets[k] * jnp.log(o[k])) for k in probs)

    grads = jax.device_get(jax.jit(jax.grad(jloss))(v["params"]))
    want = flax_to_torch(grads, v["batch_stats"], mod)
    mod = _bridged(mod, v).train()
    o = mod(*(torch.from_numpy(a) for a in inputs))
    sum(-(torch.from_numpy(targets[k]) * torch.log(o[k])).sum() for k in probs).backward()
    g_scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for pname, p in mod.named_parameters():
        w = want[pname].numpy()
        # (+1e-6 x the largest gradient: a conv bias ahead of a train-mode BN
        # has a gradient of 0, float32 sums leave rounding there)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max() + 1e-6 * g_scale, err_msg=pname)


@pytest.mark.parametrize("src,dst", [((9, 9), (24, 24)), ((32, 32), (240, 240)),
                                     ((5, 7), (12, 12)), ((32, 32), (256, 256)),
                                     ((12, 12), (5, 5))])
def test_resize_nearest_matches_jax(rng, src, dst):
    x = rng.normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, *dst, 3), method="nearest"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resize_nearest(xt, dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    plain = torch.nn.functional.interpolate(xt, size=dst, mode="nearest").permute(0, 2, 3, 1)
    integer = all(d % s == 0 for s, d in zip(src, dst))
    assert np.array_equal(plain.numpy(), want) == integer


def test_factor_three_transposed_conv_matches_flax(rng):
    x = rng.normal(size=(1, 4, 5, 2)).astype(np.float32)
    jconv = fnn.ConvTranspose(3, (3, 3), strides=(3, 3), padding="SAME")
    v = jax.device_get(jconv.init(jax.random.key(1), x))
    want = np.asarray(jconv.apply(v, x))
    k, bias = v["params"]["kernel"], v["params"]["bias"]
    assert want.shape == (1, 12, 15, 3)
    for m, r in ((0, 0), (2, 1), (3, 2)):
        for n, s in ((1, 0), (4, 2)):
            np.testing.assert_allclose(
                want[0, 3 * m + r, 3 * n + s], x[0, m, n] @ k[2 - r, 2 - s] + bias,
                rtol=1e-5, atol=1e-6)
    conv = DecoderBlock(2, 1, 3, up=3).ConvTranspose_0  # the hybrid decoder's first up
    assert conv.kernel_size == conv.stride == (3, 3) and conv.padding == (0, 0)
    conv.load_state_dict(flax_to_torch(v["params"], None, conv))
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("config", ["landcover", "wetland"])
def test_default_hybrid_at_256_fails_in_both(config):
    cfg, jcfg = CONFIGS[config], JAX_CONFIGS[config]
    assert cfg.kernel_size == jcfg.kernel_size == 256
    fam, jfam = zoo.get_family("hybrid"), jzoo.get_family("hybrid")
    jmodel = jfam.build(jcfg)
    with pytest.raises(TypeError, match="Cannot concatenate"):
        jax.eval_shape(jmodel.init, jax.random.key(0), *jfam.example_inputs(jcfg))
    model = build_empty(fam.build, cfg).eval()
    meta = [torch.from_numpy(a).to("meta") for a in fam.example_inputs(cfg)]
    with pytest.raises(ValueError, match="does not survive the pool factors"):
        model(*meta)
    # 240 = 10 x 24 round-trips (3, 2, 2, 2) in both
    small = [torch.zeros((1, 240, 240, len(cfg.bands)), device="meta"), meta[1]]
    with torch.no_grad():
        assert model(*small)["probs"].shape == (1, 240, 240, cfg.num_classes)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), np.zeros((1, 240, 240, 4)),
                            np.zeros((1, 6, 32, 32, 4)))
    assert "unet" in shapes["params"]


FRESH = {
    "convlstm": dict(features=6),
    "lstm_autoencoder": dict(features=5),
    "hybrid": dict(filters=(4, 8), factors=(3, 2), lstm_features=5),
    "acnn": dict(n_blocks=2, features=6),
    "hierarchical": dict(n_blocks=2, features=4, lstm_features=5),
}


@pytest.mark.parametrize("family", sorted(FRESH))
def test_fresh_model_starts_from_flax_init(family):
    """A new model's tensors against a JAX ``init`` of the same family:
    the same keys (bridged), zero biases, unit BN scales and variances,
    zero means, and kernels with flax's lecun-normal spread
    (std sqrt(1/fan_in), truncated at 2 std)."""
    cfg = dataclasses.replace(CONFIGS["landcover" if family in ("hybrid", "acnn",
                                                                "hierarchical") else
                                      "timeseries"], kernel_size=24)
    jcfg = dataclasses.replace(JAX_CONFIGS[cfg.name], kernel_size=24)
    fam, jfam = zoo.get_family(family), jzoo.get_family(family)
    model = fam.build(cfg, **FRESH[family])
    jmodel = jfam.build(jcfg, **FRESH[family])
    v = jax.device_get(jax.jit(jmodel.init)(jax.random.key(0), *jfam.example_inputs(jcfg)))
    want = flax_to_torch(v["params"], v["batch_stats"], model)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, t in got.items():
        w = want[key]
        assert t.shape == w.shape, key
        if key.endswith(("bias", "running_mean")):
            assert not t.any() and not w.any(), key
        elif key.endswith(("running_var", "num_batches_tracked")) or t.dim() == 1:
            torch.testing.assert_close(t, w.to(t.dtype), msg=key)
        else:
            fan_in = t[0].numel() if "ConvTranspose" not in key else t.shape[0] * t[0, 0].numel()
            std = fan_in ** -0.5
            assert float(t.abs().max()) <= 2 * std * 1.0001 / 0.8796 + 1e-6, key
            if t.numel() >= 500:
                for spread in (t.std(), w.std()):
                    assert 0.8 * std < float(spread) < 1.2 * std, key


@pytest.mark.parametrize("name", ["acnn", "hierarchical", "hybrid"])
def test_checkpoint_round_trip(tmp_path, rng, name):
    _, mod, inputs, keys = _case(name, rng)
    mod.eval()
    save_checkpoint(str(tmp_path), mod, {"step": 1})
    blob = torch.load(tmp_path / "best" / "model.pt", weights_only=True)
    assert blob["arch"] == {"acnn": "acnn", "hierarchical": "hierarchical",
                            "hybrid": "hybrid"}[name]
    loaded, _ = load_checkpoint(str(tmp_path))
    assert type(loaded) is type(mod) and loaded.kwargs == mod.kwargs
    with torch.no_grad():
        a, b = (m(*(torch.from_numpy(x) for x in inputs)) for m in (mod, loaded))
    for key in keys:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
