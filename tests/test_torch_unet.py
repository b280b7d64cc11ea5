"""The port's UNet (models/unet.py, blocks.py), its BN fold (fold.py) and
the flax weight bridge (bridge.py) against the JAX UNet in float32 eval
mode. Tolerance rtol 1e-4 / atol 1e-5: the same math, summed in another
order by another conv library."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models import fold_unet_variables
from satellite_computervision_tpu_torch.models import UNet, flax_to_torch, fold_unet
from satellite_computervision_tpu_torch.models.unet import space_to_depth

TOL = dict(rtol=1e-4, atol=1e-5)
HEADS = {"sigmoid": 1, "softmax": 3, "linear": 2}


def _jax_variables(model, x, rng):
    """flax init, then weights and BN stats redrawn with numpy so that no
    BatchNorm is the identity."""
    v = jax.device_get(model.init(jax.random.key(0), jnp.asarray(x)))
    v["params"] = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=np.shape(a)) * 0.3).astype(np.float32), v["params"])
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (np.abs(rng.normal(size=np.shape(a))) + 0.3).astype(np.float32),
        v["batch_stats"])
    return v


def _outputs(head):
    return ["continuous"] if head == "linear" else ["logits", "probs", "classes"]


def _torch_forward(model, x):
    with torch.no_grad():
        return {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}


def _check(got, want, head):
    for key in _outputs(head):
        if key == "classes":
            # a probability within float noise of the threshold may flip
            assert np.mean(got[key] != np.asarray(want[key])) < 1e-3
        else:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)


@pytest.mark.parametrize("convs_per_block", [1, 2])
@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_unet_matches_jax(rng, head, s2d, convs_per_block):
    kwargs = dict(n_classes=HEADS[head], filters=(4, 8), factors=(2, 2), head=head,
                  convs_per_block=convs_per_block, space_to_depth=s2d)
    jmodel = JaxUNet(**kwargs)
    x = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    v = _jax_variables(jmodel, x, rng)
    want = jmodel.apply(v, jnp.asarray(x))

    model = UNet(6, **kwargs).eval()
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    got = _torch_forward(model, x)
    _check(got, want, head)

    # the port's fold == the port's unfolded forward == JAX's folded forward
    folded = fold_unet(model)
    assert folded.fold_bn and not any("BatchNorm" in k for k in folded.state_dict())
    got_folded = _torch_forward(folded, x)
    for key in _outputs(head):
        if key != "classes":
            np.testing.assert_allclose(got_folded[key], got[key], **TOL)
    jfolded, vf = fold_unet_variables(jmodel, v)
    want_folded = jfolded.apply(vf, jnp.asarray(x))
    _check(got_folded, want_folded, head)

    # a folded flax tree bridges onto the folded port model
    bridged = UNet(6, fold_bn=True, **kwargs).eval()
    bridged.load_state_dict(flax_to_torch(vf["params"], None, bridged))
    for key, val in _torch_forward(bridged, x).items():
        np.testing.assert_array_equal(val, got_folded[key])


def test_space_to_depth_channel_order():
    """Channel (dy*2 + dx)*C + c of the S2D output is pixel (2i+dy, 2j+dx)
    channel c — not F.pixel_unshuffle's c*4 + dy*2 + dx."""
    x = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    y = space_to_depth(x)
    assert y.shape == (2, 2, 3, 12)
    for dy in (0, 1):
        for dx in (0, 1):
            for c in range(3):
                torch.testing.assert_close(y[..., (dy * 2 + dx) * 3 + c],
                                           x[:, dy::2, dx::2, c])


def test_conv_transpose_bridge_flips_kernel(rng):
    """flax ConvTranspose((2,2), strides 2, SAME) == torch ConvTranspose2d
    with the kernel flipped in space and (in, out) moved to the front."""
    import flax.linen as fnn

    x = rng.normal(size=(1, 5, 5, 3)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), padding="SAME")
    v = layer.init(jax.random.key(1), jnp.asarray(x))
    kernel = np.asarray(v["params"]["kernel"])
    want = np.asarray(layer.apply(v, jnp.asarray(x)))
    conv = torch.nn.ConvTranspose2d(3, 4, 2, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))))
        conv.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bridge_rejects_mismatched_tree(rng):
    jmodel = JaxUNet(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid",
                     space_to_depth=True)
    v = _jax_variables(jmodel, np.zeros((1, 16, 16, 6), np.float32), rng)
    plain = UNet(6, n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")
    with pytest.raises(KeyError):  # the stem's weights have no place
        flax_to_torch(v["params"], v["batch_stats"], plain)
