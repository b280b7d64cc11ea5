"""The Prithvi-EO-2.0 ViT with its segmentation head (``models/prithvi.py``)
on the CPU at a small size, against the benchmark's plain reference
(``perfbench/reference/prithvi.py``): its forward, the position table,
its softmax head, the serving cast, the tiled engine, its spans and its
checkpoint.

The file imports no JAX; its card tests are in ``tests/test_torch_cuda.py``.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import inputs  # noqa: E402
from perfbench.families.unet import load  # noqa: E402
from perfbench.reference import prithvi as ref  # noqa: E402
from perfbench.reference.layers import Ops  # noqa: E402
from perfbench.reference.tiling import blend_scene  # noqa: E402
from satellite_computervision_tpu_torch import predict  # noqa: E402
from satellite_computervision_tpu_torch.geo import read_geotiff  # noqa: E402
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine  # noqa: E402
from satellite_computervision_tpu_torch.models import PrithviSegmenter  # noqa: E402
from satellite_computervision_tpu_torch.models.prithvi import sincos_3d  # noqa: E402
from satellite_computervision_tpu_torch.train import zoo  # noqa: E402
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from satellite_computervision_tpu_torch.train.config import (  # noqa: E402
    LANDCOVER_CONFIG,
    SOLAR_CONFIG,
)
from satellite_computervision_tpu_torch.utils.profiling import span_log  # noqa: E402

CPU = torch.device("cpu")
# width 64, 2 layers of 4 heads, patch 8, 2 frames of 3 bands, 32^2 chips
SMALL = dict(in_channels=6, frames=2, patch=8, width=64, depth=2, heads=4, mlp=128, n_classes=1,
             head="sigmoid", threshold=0.5, head_widths=[16, 8, 4], mean=[5000.0, 4000.0, 3000.0],
             std=[2000.0, 1500.0, 1000.0], bn_eps=1e-3, bn_momentum=0.99)
IMAGERY = {"dtype": "uint16", "range": [1, 10000], "noise": 150.0, "cells": [8, 32]}
# float32 on both sides, the same products summed in other orders (a
# linear map against a stride-8 conv, SDPA against softmax(QK^T)V):
# agreement to rounding of logits of order 1
ATOL = 1e-4


def _kwargs(model=SMALL):
    keys = ("frames", "patch", "width", "depth", "heads", "mlp", "n_classes", "head",
            "threshold", "head_widths", "mean", "std", "bn_momentum")
    return {k: model[k] for k in keys}


def _weights(seed=3, model=SMALL, side=32):
    """The reference's seeded weights, the head's BatchNorm calibrated on
    four chips as the benchmark does it."""
    w = inputs.draw_weights(ref.specs(model), inputs.generator(seed, "weights", CPU), CPU)
    chips = _chips(seed, 4, side, model["in_channels"])
    with torch.no_grad():
        ref.logits(w, chips, model, Ops("float32"), bn="calibrate")
    return w


def _chips(seed, n, side, channels):
    gen = inputs.generator(seed, "chips", CPU)
    return inputs.imagery(gen, n, side, channels, IMAGERY, CPU).round()


def _model(w, model=SMALL):
    with torch.device("meta"):
        net = PrithviSegmenter(model["in_channels"], **_kwargs(model))
    return load(net, CPU, w).eval()


@pytest.mark.parametrize("side", [32, 48])
def test_forward_matches_the_reference(side):
    w = _weights()
    net = _model(w)
    x = _chips(7, 3, side, 6)
    with torch.no_grad():
        out = net(x)
        want = ref.logits(w, x, SMALL, Ops("float32"))
    assert out["logits"].shape == (3, side, side, 1) and out["logits"].dtype == torch.float32
    assert want.std() > 0.1  # the calibrated head answers, not a constant
    torch.testing.assert_close(out["logits"], want, rtol=0, atol=ATOL)
    torch.testing.assert_close(out["probs"], torch.sigmoid(want), rtol=0, atol=ATOL)
    assert out["classes"].dtype == torch.int32


def test_softmax_head_matches_the_reference():
    """A multi-class preset's head (the zoo picks softmax for more than
    one class): the logits the reference's, ``probs`` their softmax over
    the classes, ``classes`` its argmax as (B, H, W) int32."""
    model = dict(SMALL, n_classes=3, head="softmax")
    w = _weights(model=model)
    net = _model(w, model)
    x = _chips(9, 2, 32, 6)
    with torch.no_grad():
        out = net(x)
        want = ref.logits(w, x, model, Ops("float32"))
    assert out["logits"].shape == (2, 32, 32, 3)
    torch.testing.assert_close(out["logits"], want, rtol=0, atol=ATOL)
    torch.testing.assert_close(out["probs"], torch.softmax(want, dim=-1), rtol=0, atol=ATOL)
    assert out["classes"].shape == (2, 32, 32) and out["classes"].dtype == torch.int32
    assert torch.equal(out["classes"], torch.argmax(out["probs"], dim=-1).to(torch.int32))
    assert len(out["classes"].unique()) > 1  # the calibrated head picks more than one class
    built = zoo.get_family("prithvi").build(LANDCOVER_CONFIG, width=32, depth=1, heads=2, mlp=64,
                                            patch=4, head_widths=(8, 4))
    assert built.kwargs["head"] == "softmax" and built.kwargs["n_classes"] == 8


def _formula(width, frames, rows, cols):
    """The table written out token by token: zero, then per token its
    column's, row's and frame's [sin, cos] at 10000^(-2i/d)."""
    part = width // 16
    out = np.zeros((1 + frames * rows * cols, width))
    n = 1
    for t in range(frames):
        for r in range(rows):
            for c in range(cols):
                row = []
                for pos, d in ((c, 6 * part), (r, 6 * part), (t, 4 * part)):
                    omega = [10000.0 ** (-2.0 * i / d) for i in range(d // 2)]
                    row += [math.sin(pos * o) for o in omega] + [math.cos(pos * o) for o in omega]
                out[n] = row
                n += 1
    return torch.from_numpy(out).float()


@pytest.mark.parametrize("width,frames,rows,cols", [(1024, 4, 14, 14), (64, 3, 5, 7)])
def test_position_table_is_the_formula(width, frames, rows, cols):
    got = sincos_3d(width, frames, rows, cols)
    # the table's entries are sines and cosines of at most 13 radians,
    # computed in float64 on both sides and rounded to float32 once
    torch.testing.assert_close(got, _formula(width, frames, rows, cols), rtol=0, atol=1e-6)
    torch.testing.assert_close(got, ref.position_table(width, frames, rows, cols, CPU),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="divisible by 16"):
        sincos_3d(72, 1, 2, 2)


def test_position_table_follows_the_input_grid():
    """A model serves any side that is a multiple of the patch (the
    table is computed for the grid); others are refused."""
    net = _model(_weights())
    with torch.no_grad():
        net(_chips(1, 1, 32, 6))
        net(_chips(1, 1, 40, 6))
        assert set(k[:3] for k in net.encoder._tables) == {(2, 4, 4), (2, 5, 5)}
        with pytest.raises(ValueError, match="patches"):
            net(_chips(1, 1, 36, 6))


def test_patch_embedding_is_the_published_conv3d():
    """The model card's patch embedding is a Conv3d of kernel and stride
    (1, p, p); its weight flattened after the first axis, the linear map
    of each frame's patches embeds as that Conv3d does."""
    w = _weights()
    net = _model(w)
    d, bands, p = SMALL["width"], 3, SMALL["patch"]
    conv = torch.nn.Conv3d(bands, d, (1, p, p), stride=(1, p, p))
    with torch.no_grad():
        conv.weight.copy_(w["encoder.patch_embed.proj.weight"].view(d, bands, 1, p, p))
        conv.bias.copy_(w["encoder.patch_embed.proj.bias"])
        x = _chips(2, 2, 32, 6)
        std = (x.view(2, 32, 32, 2, 3) - torch.tensor(SMALL["mean"])) / torch.tensor(SMALL["std"])
        want = conv(std.permute(0, 4, 3, 1, 2))  # (B, width, frames, rows, cols)
        tokens = net.encoder.embed(std.reshape(2, 32, 32, 6), frames=2)
        got = tokens[:, 1:] - net.encoder.positions(2, 4, 4, tokens)[1:]
    # the same dot products of 192 terms, in another order
    torch.testing.assert_close(got, want.flatten(2).transpose(1, 2), rtol=0, atol=1e-5)


def test_to_serving_casts_to_bfloat16_channels_last():
    """``predict.to_serving``'s card cast (bfloat16, channels-last) on the
    CPU: no 5-D weight refuses the format; the head's convs take it; the
    standardisation stays float32 (its constants are no parameters)."""
    w = _weights()
    net = _model(w)
    served = net.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    conv = served.head.stages[0].conv.Conv_0.weight
    assert conv.dtype == torch.bfloat16 and conv.is_contiguous(memory_format=torch.channels_last)
    assert all(p.dim() <= 4 for p in served.parameters())
    assert predict.to_serving(_model(w), CPU, torch.bfloat16).head.out.weight.dtype \
        == torch.bfloat16
    x = _chips(4, 2, 32, 6)
    with torch.no_grad():
        got = served(x)["probs"]
        want = torch.sigmoid(ref.logits(w, x, SMALL, Ops("float32")))
    assert got.dtype == torch.float32
    # bfloat16 keeps 8 bits: two layers and the head move a probability by
    # a few hundredths at most
    assert (got - want).abs().max() < 0.05


def test_engine_matches_the_reference_blend():
    """A 2-frame scene through ``TiledInferenceEngine`` (hann blend, 24 +
    8 geometry, a batch that pads) against ``reference/tiling.py``."""
    w = _weights()
    net = _model(w)
    scene = inputs.host_images(inputs.generator(5, "scene", CPU), 1, 70, 6, IMAGERY, CPU)[0]
    engine = TiledInferenceEngine(lambda x: net(x)["probs"], kernel=24, buffer=8, batch_size=4,
                                  blend="hann", device="cpu")
    with torch.no_grad():
        got = engine.predict_scene(scene)
        want = blend_scene(torch.from_numpy(scene), lambda c: torch.sigmoid(
            ref.logits(w, c, SMALL, Ops("float32"))), 24, 8, 4)
    assert got.shape == (70, 70, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_vit_spans_under_a_profiler():
    """One ``vit.embed``, ``vit.encoder`` and ``vit.head`` per forward, in
    that order, each inside the engine's ``serve.forward``; ``vit.encoder``
    with the attention's shapes (and no ``batch``, the training batch's
    id in the span log)."""
    net = _model(_weights())
    scene = _chips(6, 1, 40, 6)[0]
    engine = TiledInferenceEngine(lambda x: net(x)["probs"], kernel=24, buffer=8, batch_size=4,
                                  blend="hann", device="cpu")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        engine.predict_scene(scene)
    log = span_log()
    forwards = {r.id: r for r in log if r.name == "serve.forward"}
    vit = [r for r in log if r.name.startswith("vit.")]
    assert len(forwards) == 1 and [r.name for r in vit] == ["vit.embed", "vit.encoder", "vit.head"]
    assert all(r.parent in forwards for r in vit)
    enc = vit[1]
    assert enc.attrs == {"chips": 4, "tokens": 1 + 2 * 4 * 4, "heads": 4, "head_dim": 16,
                         "layers": 2, "dtype": "float32"}
    assert vit[0].attrs == vit[2].attrs == {"chips": 4}


def test_load_model_serves_a_saved_checkpoint(tmp_path):
    w = _weights()
    net = _model(w)
    save_checkpoint(str(tmp_path), net, {"step": 1})
    served = predict.load_model(str(tmp_path), CPU, arch="prithvi")
    x = _chips(8, 2, 32, 6)
    with torch.no_grad():
        torch.testing.assert_close(served(x)["probs"], net(x)["probs"], rtol=0, atol=0)
    assert served.kwargs == net.kwargs
    with pytest.raises(ValueError, match="holds a prithvi model, not a unet"):
        predict.load_model(str(tmp_path), CPU, arch="unet")
    (tmp_path / "jax" / "best").mkdir(parents=True)
    (tmp_path / "jax" / "best" / "state.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="the JAX package has no prithvi"):
        predict.load_model(str(tmp_path / "jax"), CPU, arch="prithvi")


def test_zoo_builds_and_the_cli_serves_it(tmp_path):
    """The zoo's ``prithvi`` takes a preset's bands as one date; the
    ``predict`` CLI serves its checkpoint over a scene."""
    fam = zoo.get_family("prithvi")
    net = fam.build(SOLAR_CONFIG, width=32, depth=1, heads=2, mlp=64, patch=4,
                    head_widths=(8, 4))
    assert net.kwargs["in_channels"] == 6 and net.kwargs["frames"] == 1
    (x,) = fam.example_inputs(SOLAR_CONFIG)
    with torch.no_grad():
        assert net.eval()(torch.from_numpy(x[:, :32, :32]))["probs"].shape == (1, 32, 32, 1)
    save_checkpoint(str(tmp_path), net)
    scene = np.random.default_rng(0).uniform(0, 1, (40, 36, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    out = tmp_path / "pred.tif"
    predict.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", str(tmp_path),
                  "--model", "prithvi", "--kernel", "24", "--buffer", "8", "--batch-size", "4",
                  "--uint8", "--device", "cpu", "--output", str(out)])
    pred, _ = read_geotiff(str(out))
    assert pred.shape == (40, 36, 1) and pred.dtype == np.uint8


def test_train_cli_trains_it(tmp_path, monkeypatch):
    """``train --model prithvi`` on EE-schema TFRecords at a small width:
    MAE's initialisation, two steps, a checkpoint ``predict`` reads."""
    import dataclasses

    from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
    from satellite_computervision_tpu_torch.train import __main__ as train_cli

    small = dataclasses.replace(SOLAR_CONFIG, kernel_size=32, batch_size=2, axes=(0, 1))
    monkeypatch.setitem(train_cli.CONFIGS, "solar", small)
    fam = zoo.FAMILIES["prithvi"]
    monkeypatch.setitem(zoo.FAMILIES, "prithvi", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, width=32, depth=1, heads=2, mlp=64, patch=8,
                                               head_widths=(8, 4, 4), **kw)))
    rng = np.random.default_rng(0)
    chips = tmp_path / "train.tfrecord.gz"
    write_tfrecord_file(str(chips), [
        {**{b: rng.uniform(0, 0.3, 32 * 32).astype(np.float32) for b in small.bands},
         "landcover": (rng.uniform(size=32 * 32) > 0.7).astype(np.float32)} for _ in range(4)])
    ckpt = str(tmp_path / "run")
    trainer = train_cli.main(["--config", "solar", "--model", "prithvi", "--train", str(chips),
                              "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", "2",
                              "--batch-size", "2", "--device", "cpu"])
    assert trainer.state.step == 2
    cls = trainer.state.model.encoder.cls_token
    assert torch.isfinite(cls).all() and 0.005 < cls.std() < 0.05  # N(0, 0.02^2), moved a little
    served = predict.load_model(ckpt, CPU, arch="prithvi")
    assert served.kwargs["width"] == 32
