"""The port's ASPP (models/blocks.py) and SiameseUNet (models/siamese.py)
against the JAX package's in float32, with weights carried by
``flax_to_torch``: eval forwards at rtol 1e-4 / atol 1e-5 (the same math
summed in another order by another conv library, as
tests/test_torch_unet.py), and one train step through both packages'
``make_train_step`` with the siamese family's loss (loss at rtol 1e-5;
every gradient at rtol 1e-4 / atol 1e-6; the running statistics after the
shared towers' two updates at rtol 1e-5, momentum 0.99)."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.models import SiameseUNet as JaxSiamese
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models.blocks import ASPP as JaxASPP
from satellite_computervision_tpu.train import zoo as jzoo
from satellite_computervision_tpu.train.config import CHANGE_CONFIG as JAX_CHANGE
from satellite_computervision_tpu.train.trainer import TrainState
from satellite_computervision_tpu.train.trainer import make_train_step as jax_make_train_step
from satellite_computervision_tpu_torch.models import ASPP, SiameseUNet, UNet, flax_to_torch
from satellite_computervision_tpu_torch.train import zoo
from satellite_computervision_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from satellite_computervision_tpu_torch.train.config import CHANGE_CONFIG
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(filters=(4, 8), factors=(2, 2))


def _randomized(v, rng):
    """Weights and BN statistics redrawn with numpy, so no BatchNorm is the
    identity."""
    v = dict(v)
    v["params"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    return v


def _bridged(model, v):
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    return model


@pytest.mark.parametrize("rates,image_pooling,in_ch,features", [
    ((3, 6, 12), False, 8, 12),
    ((6, 12, 18), True, 16, 8),
], ids=["siamese-rates", "deeplab-rates-pooled"])
def test_aspp_matches_jax(rng, rates, image_pooling, in_ch, features):
    jmod = JaxASPP(features, rates=rates, image_pooling=image_pooling)
    x = rng.normal(size=(2, 16, 16, in_ch)).astype(np.float32)
    v = _randomized(jax.device_get(jmod.init(jax.random.key(0), jnp.asarray(x))), rng)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))

    mod = ASPP(in_ch, features, rates, image_pooling).eval()
    # flax's creation order: 1x1, one per rate, [pool], fuse
    n = 1 + len(rates) + image_pooling + 1
    assert sorted(name for name, _ in mod.named_children()) == sorted(
        f"ConvBNAct_{i}" for i in range(n))
    # a dilated 3x3 "same" conv pads its rate on each side, as flax's SAME
    for i, rate in enumerate(rates, start=1):
        conv = getattr(mod, f"ConvBNAct_{i}").Conv_0
        assert conv.dilation == (rate, rate) and conv.kernel_size == (3, 3)
    _bridged(mod, v)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("output_bias", [None, -1.5], ids=["no-bias", "bias"])
@pytest.mark.parametrize("convs_per_block", [1, 2])
def test_siamese_matches_jax(rng, convs_per_block, output_bias):
    kw = dict(SMALL, convs_per_block=convs_per_block, output_bias=output_bias)
    jmodel = JaxSiamese(**kw)
    before = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    after = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    init = jax.device_get(jmodel.init(jax.random.key(0), jnp.asarray(before),
                                      jnp.asarray(after)))
    # a fresh port model starts from flax's init: zero biases, the head's
    # output_bias
    model = SiameseUNet(4, **kw)
    want_head = 0.0 if output_bias is None else output_bias
    assert torch.all(model.head.bias == want_head)
    np.testing.assert_array_equal(init["params"]["head"]["bias"], [want_head])
    assert model.kwargs["output_bias"] == output_bias

    v = _randomized(init, rng)
    want = jmodel.apply(v, jnp.asarray(before), jnp.asarray(after))
    _bridged(model, v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(before), torch.from_numpy(after))
    for key in ("logits", "probs"):
        assert got[key].dtype == torch.float32 and got[key].shape == (2, 32, 32, 1)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    assert got["classes"].dtype == torch.int32
    # a probability within float noise of the threshold may flip
    assert np.mean(got["classes"].numpy() != np.asarray(want["classes"])) < 1e-3
    # the argument order matters: swapping the scenes changes the answer
    with torch.no_grad():
        swapped = model(torch.from_numpy(after), torch.from_numpy(before))["logits"]
    assert not torch.allclose(swapped, got["logits"])


def test_one_train_step_matches_jax(rng):
    """One step of both packages' ``make_train_step`` on a (before, after)
    batch, momentum 0.99: each encoder and the ASPP normalize each tower
    with its own batch statistics and update the running statistics twice,
    after tower first."""
    jmodel = JaxSiamese(**SMALL)
    before = rng.normal(size=(4, 16, 16, 4)).astype(np.float32)
    after = before + rng.normal(size=before.shape).astype(np.float32) * 0.5
    y = (np.abs(after - before).mean(-1, keepdims=True) > 0.4).astype(np.float32)
    v = _randomized(jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((1, 16, 16, 4)),
                                               jnp.zeros((1, 16, 16, 4)))), rng)
    v["params"] = jax.tree_util.tree_map(lambda a: a / 0.3 * 0.1, v["params"])
    jloss_fn, jkey = jzoo.get_family("siamese").loss(JAX_CHANGE)

    def jloss(params):
        out, mutated = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]},
                                    before, after, train=True, mutable=["batch_stats"])
        return jloss_fn(y, out[jkey]), mutated["batch_stats"]

    (want_loss, want_stats), want_grads = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    tx = optax.adam(9e-4)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
                        apply_fn=jmodel.apply, tx=tx)
    jstate, jout = jax_make_train_step(jloss_fn, jkey, donate=False)(
        jstate, ((jnp.asarray(before), jnp.asarray(after)), jnp.asarray(y)))
    np.testing.assert_allclose(float(jout["loss"]), float(want_loss), rtol=1e-6)

    model = _bridged(SiameseUNet(4, **SMALL, bn_momentum=0.99), v)
    loss_fn, key = zoo.get_family("siamese").loss(CHANGE_CONFIG)
    assert key == jkey == "logits"
    state = create_train_state(model, 9e-4)
    out = make_train_step(loss_fn, key)(
        state, ((torch.from_numpy(before), torch.from_numpy(after)), torch.from_numpy(y)))
    np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(out["cm"].numpy(), np.asarray(jout["cm"]))
    assert state.step == 1

    grads = flax_to_torch(jax.device_get(want_grads), v["batch_stats"], model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    stats = flax_to_torch(v["params"], jax.device_get(want_stats), model)
    step_stats = flax_to_torch(v["params"], jax.device_get(jstate.batch_stats), model)
    n_bn = 0
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(buf.numpy(), step_stats[name].numpy(), rtol=1e-5,
                                       err_msg=name)
            n_bn += 1
    assert n_bn == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())


def test_bridge_refuses_the_other_architecture(rng):
    """A U-Net tree has no place in a SiameseUNet, and the reverse."""
    x = jnp.zeros((1, 16, 16, 4))
    jsiam = JaxSiamese(**SMALL)
    vs = jax.device_get(jsiam.init(jax.random.key(0), x, x))
    junet = JaxUNet(n_classes=1, head="sigmoid", **SMALL)
    vu = jax.device_get(junet.init(jax.random.key(0), x))
    with pytest.raises(KeyError):
        flax_to_torch(vu["params"], vu["batch_stats"], SiameseUNet(4, **SMALL))
    with pytest.raises(KeyError):
        flax_to_torch(vs["params"], vs["batch_stats"], UNet(4, n_classes=1, head="sigmoid",
                                                            **SMALL))
    # the matching pairs bridge
    flax_to_torch(vs["params"], vs["batch_stats"], SiameseUNet(4, **SMALL))
    flax_to_torch(vu["params"], vu["batch_stats"], UNet(4, n_classes=1, head="sigmoid", **SMALL))


def test_checkpoint_records_the_architecture(tmp_path, rng):
    model = SiameseUNet(4, **SMALL, threshold=0.3).eval()
    save_checkpoint(str(tmp_path), model, {"step": 1})
    blob = torch.load(tmp_path / "best" / "model.pt", weights_only=True)
    assert blob["arch"] == "siamese"
    loaded, meta = load_checkpoint(str(tmp_path))
    assert isinstance(loaded, SiameseUNet) and meta == {"step": 1}
    assert loaded.kwargs == model.kwargs
    x = torch.from_numpy(rng.normal(size=(1, 16, 16, 4)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(loaded(x, x * 2)["logits"], model(x, x * 2)["logits"],
                                   rtol=0, atol=0)
