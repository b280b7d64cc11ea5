"""torchvision-layout ResNet weights for the port's DeepLab backbone
(``models/deeplab.py``) against the JAX package's loader and exporter,
and the bridge on bias-less convs: every comparison is exact (the same
float32 values copied, transposed or not)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.models import DeepLabV3Plus as JaxDeepLab
from satellite_computervision_tpu.models import UNet as JaxUNet
from satellite_computervision_tpu.models.deeplab import (
    load_torch_resnet_weights as jax_load_torch_resnet_weights,
)
from satellite_computervision_tpu_torch.models import (
    DeepLabV3Plus,
    UNet,
    export_torch_resnet_weights,
    flax_to_torch,
    load_torch_resnet_weights,
)
from satellite_computervision_tpu_torch.models.deeplab import torchvision_keys
from satellite_computervision_tpu_torch.train.checkpoint import build_empty
from test_deeplab_weights import _synthetic_resnet_state_dict
from test_torch_deeplab import random_variables, two_torch_threads  # noqa: F401

SMALL = dict(stage_sizes=(1, 1, 1, 1), aspp_features=16)


@pytest.fixture(scope="module")
def jax_tree():
    shapes = jax.eval_shape(JaxDeepLab(n_classes=1, **SMALL).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    return random_variables(shapes, np.random.default_rng(8))


def _bridged(v):
    model = build_empty(DeepLabV3Plus, 3, **SMALL)
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model), assign=True)
    return model


def test_loader_matches_jax_loader_and_bridge(jax_tree, tmp_path):
    """A torchvision state_dict (with ``fc.*`` and ``num_batches_tracked``)
    through the JAX loader then the bridge, and through the port's loader
    onto the bridged model: the same state_dict."""
    sd = _synthetic_resnet_state_dict(torchvision_extras=True)
    path = str(tmp_path / "resnet.pth")
    torch.save(sd, path)
    params, stats = jax_load_torch_resnet_weights(jax_tree["params"], path,
                                                  jax_tree["batch_stats"])
    want = flax_to_torch(params, stats, build_empty(DeepLabV3Plus, 3, **SMALL))

    model = _bridged(jax_tree)
    loaded = load_torch_resnet_weights(model, path)
    assert sorted(loaded) == sorted(torchvision_keys(model).values())
    assert len(loaded) == 85  # stem conv + BN, 4 blocks of 3 convs + 3 BNs + projection
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    # the warm-started weights reached the model: the stem is the file's
    torch.testing.assert_close(model.backbone.stem_conv.weight, sd["conv1.weight"], rtol=0,
                               atol=0)
    # and what is not the backbone kept the bridged values
    torch.testing.assert_close(model.head.weight, _bridged(jax_tree).head.weight, rtol=0, atol=0)


def test_full_resnet50_schema_loads_every_backbone_key(tmp_path):
    """The exact torchvision resnet50 key schema (stages 3/4/6/3, 320 keys
    with ``num_batches_tracked`` and ``fc``) onto the full-width model: all
    265 conv and BN tensors land, each equal to the file's."""
    sd = _synthetic_resnet_state_dict(stage_sizes=(3, 4, 6, 3), torchvision_extras=True)
    assert len(sd) == 320
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    model = build_empty(DeepLabV3Plus, 3).to_empty(device="cpu")
    loaded = load_torch_resnet_weights(model, path)
    keys = torchvision_keys(model)
    assert len(loaded) == len(keys) == 265
    state = model.state_dict()
    for tv, port in keys.items():
        torch.testing.assert_close(state[port], sd[tv], rtol=0, atol=0, msg=tv)
    assert not set(sd) - set(keys) - {k for k in sd if k.startswith("fc.")
                                      or k.endswith("num_batches_tracked")}


def test_export_load_roundtrip_is_identity(jax_tree, tmp_path):
    """A backbone exported in torchvision layout and loaded onto another
    model lands bit-identically; the JAX loader reads the port's file into
    the same values."""
    model = _bridged(jax_tree)
    path = str(tmp_path / "exported.pth")
    sd = export_torch_resnet_weights(model, path)
    assert "conv1.weight" in sd and sd["bn1.num_batches_tracked"].dtype == torch.long
    assert sd["layer2.0.downsample.0.weight"].shape == (512, 256, 1, 1)
    assert len(sd) == 85 + 17  # one num_batches_tracked per BN
    shapes = jax.eval_shape(JaxDeepLab(n_classes=1, **SMALL).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    fresh = random_variables(shapes, np.random.default_rng(9))
    other = _bridged(fresh)
    load_torch_resnet_weights(other, path)
    want, got = model.state_dict(), other.state_dict()
    for key in torchvision_keys(model).values():
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)

    params, stats = jax_load_torch_resnet_weights(fresh["params"], path, fresh["batch_stats"])
    via_jax = flax_to_torch(params, stats, build_empty(DeepLabV3Plus, 3, **SMALL))
    for key in torchvision_keys(model).values():
        torch.testing.assert_close(via_jax[key], want[key], rtol=0, atol=0, msg=key)


def test_loader_refuses_a_deeper_resnet_and_other_shapes(jax_tree, tmp_path):
    model = _bridged(jax_tree)
    path = str(tmp_path / "deep.pth")
    torch.save(_synthetic_resnet_state_dict(stage_sizes=(2, 1, 1, 1)), path)
    with pytest.raises(KeyError, match="layer1.1.conv1.weight has no place"):
        load_torch_resnet_weights(model, path)
    sd = _synthetic_resnet_state_dict()
    sd["conv1.weight"] = sd["conv1.weight"][:, :2]  # a 2-band stem
    torch.save(sd, path)
    with pytest.raises(ValueError, match="conv1.weight"):
        load_torch_resnet_weights(model, path)


def test_bridge_bias_less_convs_and_other_architectures(jax_tree):
    """DeepLab's convs have no bias and bridge so; a tree with a bias the
    port's conv lacks, a U-Net tree, or a DeepLab tree into a U-Net raise."""
    model = build_empty(DeepLabV3Plus, 3, **SMALL)  # the bridge reads names and shapes
    assert model.backbone.stem_conv.bias is None and model.decoder_conv0.bias is None
    assert model.head.bias is not None and model.aspp.ConvBNAct_0.Conv_0.bias is not None
    sd = flax_to_torch(jax_tree["params"], jax_tree["batch_stats"], model)
    assert "backbone.stem_conv.bias" not in sd and "head.bias" in sd
    extra = jax.tree_util.tree_map(lambda a: a, jax_tree["params"])
    extra["low_proj"]["bias"] = np.zeros(48, np.float32)
    with pytest.raises(KeyError, match="low_proj"):
        flax_to_torch(extra, jax_tree["batch_stats"], model)
    small_unet = dict(n_classes=1, filters=(4, 8), factors=(2, 2), head="sigmoid")
    vu = jax.device_get(jax.eval_shape(JaxUNet(**small_unet).init, jax.random.key(0),
                                       jnp.zeros((1, 16, 16, 3))))
    vu = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), vu)
    with pytest.raises(KeyError):
        flax_to_torch(vu["params"], vu["batch_stats"], model)
    with pytest.raises(KeyError):
        flax_to_torch(jax_tree["params"], jax_tree["batch_stats"],
                      build_empty(UNet, 3, **small_unet))
