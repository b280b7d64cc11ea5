"""SatlasPretrain's multi-image Swin-v2 segmenter (``models/satlas.py``) on
the CPU at a small size, against the benchmark's plain reference
(``perfbench/reference/satlas.py``): its forward, the shift mask, the
position-bias table, padding and the unshifted case, patch merging, the
ignored k bias, the temperature's clamp, the max over dates, the mask
cache, the stage graphs' bookkeeping, the serving cast, the tiled engine, its spans, its checkpoint and
the CLIs.

The file imports no JAX; its card tests are in ``tests/test_torch_cuda.py``.
"""

import ast
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
from perfbench.families import satlas as family  # noqa: E402
from perfbench.reference import satlas as ref  # noqa: E402
from perfbench.reference.layers import Ops  # noqa: E402
from perfbench.reference.tiling import blend_scene  # noqa: E402
from satellite_computervision_tpu_torch import predict  # noqa: E402
from satellite_computervision_tpu_torch.geo import read_geotiff  # noqa: E402
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine  # noqa: E402
from satellite_computervision_tpu_torch.models import SatlasSwinSegmenter  # noqa: E402
from satellite_computervision_tpu_torch.models import satlas  # noqa: E402
from satellite_computervision_tpu_torch.train import zoo  # noqa: E402
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG  # noqa: E402
from satellite_computervision_tpu_torch.utils.profiling import span_log  # noqa: E402

CPU = torch.device("cpu")
# width 16, stages of 2 blocks with 2/2/4/4 heads, window 4, patch 4, 2
# dates of 3 bands
SMALL = dict(in_channels=6, bands=3, frames=2, patch=4, embed=16, depths=[2, 2, 2, 2],
             heads=[2, 2, 4, 4], window=4, mlp_ratio=2, fpn=8, upsample_widths=[8, 8],
             head_width=8, n_classes=1, head="sigmoid", threshold=0.5,
             scale=[8160.0, 6000.0, 9000.0])
IMAGERY = {"dtype": "uint16", "range": [1, 10000], "noise": 150.0, "cells": [8, 32]}
# float32 on both sides, the same products summed in other orders (SDPA
# against softmax(.)v, a batch of dates against a loop over them):
# agreement to rounding of logits of order 1
ATOL = 1e-5


def _weights(seed=3, model=SMALL):
    return inputs.draw_weights(ref.specs(model), inputs.generator(seed, "weights", CPU), CPU)


def _chips(seed, n, side, channels=6):
    gen = inputs.generator(seed, "chips", CPU)
    return inputs.imagery(gen, n, side, channels, IMAGERY, CPU).round()


def _model(w, model=SMALL):
    return family.build(model, CPU, w).eval()


# 32: every stage's map a multiple of the window (8, 4, 2, 1 after the
# first: the window covers them); 44: an 11 x 11 map padded to 12, odd
# sides merged (6, 3, 2); 60: 15, 8, 4, 2
@pytest.mark.parametrize("side", [32, 44, 60])
def test_forward_matches_the_reference(side):
    w = _weights()
    net = _model(w)
    x = _chips(7, 2, side)
    with torch.no_grad():
        out = net(x)
        want = ref.logits(w, x, SMALL, Ops("float32"))
    assert out["logits"].shape == (2, side, side, 1) and out["logits"].dtype == torch.float32
    assert want.std() > 0.01  # the map answers, not a constant
    torch.testing.assert_close(out["logits"], want, rtol=0, atol=ATOL)
    torch.testing.assert_close(out["probs"], torch.sigmoid(want), rtol=0, atol=ATOL)
    assert out["classes"].dtype == torch.int32


def test_softmax_head_and_sides_not_of_the_patch():
    model = dict(SMALL, n_classes=3, head="softmax")
    w = _weights(model=model)
    net = _model(w, model)
    x = _chips(9, 1, 32)
    with torch.no_grad():
        out = net(x)
        want = ref.logits(w, x, model, Ops("float32"))
        with pytest.raises(ValueError, match="patches"):
            net(_chips(9, 1, 34))
    torch.testing.assert_close(out["logits"], want, rtol=0, atol=ATOL)
    assert out["classes"].shape == (1, 32, 32)
    assert torch.equal(out["classes"], torch.argmax(out["probs"], dim=-1).to(torch.int32))


def _torchvision_labels(pad_h, pad_w, window, shift_h, shift_w):
    """torchvision's ``shifted_window_attention`` region map, transcribed:
    slices ``(0, -w), (-w, -s), (-s, None)`` per axis, labelled in order."""
    label = np.zeros((pad_h, pad_w))
    count = 0
    for h0, h1 in ((0, -window), (-window, -shift_h), (-shift_h, None)):
        for w0, w1 in ((0, -window), (-window, -shift_w), (-shift_w, None)):
            label[h0:h1, w0:w1] = count
            count += 1
    return label


@pytest.mark.parametrize("pad_h,pad_w,shift_h,shift_w", [(16, 16, 4, 4), (24, 16, 4, 4),
                                                         (8, 16, 0, 4), (32, 24, 4, 4)])
def test_shift_mask_is_torchvisions_regions(pad_h, pad_w, shift_h, shift_w):
    window = 8
    got = satlas.shift_mask(pad_h, pad_w, window, shift_h, shift_w)
    lab = _torchvision_labels(pad_h, pad_w, window, shift_h, shift_w)
    rows, cols = pad_h // window, pad_w // window
    assert got.shape == (rows * cols, 64, 64)
    for r in range(rows):
        for c in range(cols):
            cell = lab[r * window:(r + 1) * window, c * window:(c + 1) * window].reshape(-1)
            want = np.where(cell[None, :] != cell[:, None], -100.0, 0.0)
            np.testing.assert_array_equal(got[r * cols + c].numpy(), want)
    # the reference's labels, cut along each axis on its own, mask the same
    # pairs
    mine = (ref.region_labels(pad_h, window, shift_h, CPU)[:, None] * 3
            + ref.region_labels(pad_w, window, shift_w, CPU)[None, :])
    mine = ref.to_windows(mine[None, :, :, None], window)[0, :, :, 0]
    assert torch.equal(got, torch.where(mine[:, :, None] != mine[:, None, :], -100.0, 0.0))
    # only the last row and column of windows straddle regions
    assert (got[0] == 0).all() and (got[-1] == -100).any()


def test_window_geometry_pads_and_skips_the_roll_a_window_covers():
    assert satlas.window_geometry(128, 128, 8) == (128, 128, 4, 4)
    assert satlas.window_geometry(11, 11, 8) == (16, 16, 4, 4)
    assert satlas.window_geometry(8, 20, 8) == (8, 24, 0, 4)
    assert satlas.window_geometry(3, 2, 8) == (8, 8, 0, 0)


def test_a_map_the_window_covers_is_not_shifted():
    """A 16^2 chip: a 4 x 4 map under a window of 4, no roll in either
    block; the forward is the reference's, and the shifted block's mask is
    the position bias alone, the same in every window."""
    w = _weights()
    net = _model(w)
    attn = net.backbone.stages[0].blocks[1].attn
    assert attn.shifted and attn.geometry(4, 4) == (4, 4, 0, 0)
    x = _chips(4, 2, 16)
    with torch.no_grad():
        torch.testing.assert_close(net(x)["logits"], ref.logits(w, x, SMALL, Ops("float32")),
                                   rtol=0, atol=ATOL)
        mask, _ = attn.mask_and_scale((4, 4, 0, 0), 4, torch.float32)
        bias = attn.position_bias() - satlas.BIAS_CENTRE
    assert mask.shape == (1, 2, 16, 16)
    torch.testing.assert_close(mask[0], bias, rtol=0, atol=0)


def test_position_bias_table_is_the_formula():
    table = satlas.relative_coords_table(8)
    assert table.shape == (15 * 15, 2)

    def f(d):
        u = 8.0 * d / 7
        return math.copysign(math.log2(abs(u) + 1.0) / 3.0, u) if d else 0.0

    for dy, dx in [(-7, -7), (0, 0), (-1, 3), (7, 7), (2, -5)]:
        row = (dy + 7) * 15 + (dx + 7)
        assert table[row].tolist() == pytest.approx([f(dy), f(dx)], abs=1e-6)
    assert table[(7 + 7) * 15 + 14].tolist() == pytest.approx([1.0566416, 1.0566416], abs=1e-6)
    index = satlas.relative_position_index(8)
    # token 9 is (1, 1), token 0 is (0, 0): offset (1, 1)
    assert index[9, 0] == (1 + 7) * 15 + (1 + 7) and index[0, 9] == (-1 + 7) * 15 + (-1 + 7)
    w = _weights()
    net = _model(w)
    for stage in range(4):
        prefix = f"backbone.stages.{stage}.blocks.0.attn"
        got = net.backbone.stages[stage].blocks[0].attn.position_bias()
        torch.testing.assert_close(got, ref.position_bias(w, prefix, 4), rtol=0, atol=1e-5)
        assert (got > 0).all() and (got < 16).all()


@pytest.mark.parametrize("h,w", [(5, 7), (6, 3), (1, 1)])
def test_patch_merging_at_odd_sides(h, w):
    torch.manual_seed(h * 10 + w)
    merge = satlas.PatchMergingV2(4).eval()
    with torch.no_grad():
        merge.norm.weight.uniform_(0.5, 1.5)
        merge.norm.bias.uniform_(-0.2, 0.2)
    p = {f"m.{k}": v for k, v in merge.state_dict().items()}
    x = torch.randn(2, h, w, 4)
    with torch.no_grad():
        got = merge(x)
        want = ref.merge(x, p, "m", Ops("float32"))
    assert got.shape == (2, -(-h // 2), -(-w // 2), 8)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the first token of (0, 0), (1, 0), (0, 1), (1, 1), in that order
    padded = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    order = torch.cat([padded[:, 0, 0], padded[:, 1, 0], padded[:, 0, 1], padded[:, 1, 1]], -1)
    torch.testing.assert_close(got[:, 0, 0], merge.norm(merge.reduction(order)), rtol=0, atol=0)


def test_k_bias_is_ignored_and_q_bias_is_not():
    w = _weights()
    net = _model(w)
    x = _chips(2, 1, 32)
    qkv = net.backbone.stages[0].blocks[0].attn.qkv
    c = qkv.in_features
    with torch.no_grad():
        before = net(x)["logits"]
        qkv.bias[c:2 * c] += 5.0
        assert torch.equal(net(x)["logits"], before)
        qkv.bias[:c] += 0.5
        assert not torch.allclose(net(x)["logits"], before, atol=1e-4)


def test_logit_scale_is_clamped_at_ln_100():
    w = _weights()
    x = _chips(5, 1, 32)
    name = "backbone.stages.0.blocks.1.attn.logit_scale"
    outs = []
    for value in (math.log(100.0), 7.0, 3.0):
        w2 = dict(w, **{name: torch.full_like(w[name], value)})
        net = _model(w2)
        with torch.no_grad():
            outs.append(net(x)["logits"])
            torch.testing.assert_close(outs[-1], ref.logits(w2, x, SMALL, Ops("float32")),
                                       rtol=0, atol=ATOL)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)  # e^7 > 100: clamped
    assert not torch.allclose(outs[0], outs[2], atol=1e-4)


def test_dates_reduce_by_their_max():
    """The map is blind to the order of the dates, and a date that repeats
    another adds nothing to the max."""
    w = _weights()
    net = _model(w)
    x = _chips(6, 2, 32)
    swapped = torch.cat([x[..., 3:], x[..., :3]], dim=-1)
    twice = torch.cat([x[..., :3], x[..., :3]], dim=-1)
    with torch.no_grad():
        torch.testing.assert_close(net(swapped)["logits"], net(x)["logits"], rtol=0, atol=1e-6)
        one = SatlasSwinSegmenter(3, frames=1, **{k: SMALL[k] for k in family.KEYS
                                                  if k not in ("frames", "scale")},
                                  scale=SMALL["scale"])
        one.load_state_dict(net.state_dict())
        torch.testing.assert_close(net(twice)["logits"], one.eval()(x[..., :3])["logits"],
                                   rtol=0, atol=1e-6)


def test_mask_is_cached_until_the_weights_change():
    w = _weights()
    net = _model(w)
    attn = net.backbone.stages[0].blocks[1].attn
    x = _chips(3, 1, 32)
    with torch.no_grad():
        net(x)
        first = attn.mask_and_scale(attn.geometry(8, 8), 2, torch.float32)[0]
        assert first.shape == (2 * 4, 2, 16, 16)  # a copy per window of each image
        net(x)
        assert attn.mask_and_scale(attn.geometry(8, 8), 2, torch.float32)[0] is first
        attn.cpb_mlp[2].weight.mul_(3.0)
        got = net(x)["logits"]
    w2 = dict(w, **{k: v.clone() for k, v in net.state_dict().items()})
    torch.testing.assert_close(got, ref.logits(w2, x, SMALL, Ops("float32")), rtol=0, atol=ATOL)
    assert attn.mask_and_scale(attn.geometry(8, 8), 2, torch.float32)[0] is not first
    # with autograd on, the mask is built in the graph and nothing is cached
    attn._cache.clear()
    net(x)["logits"].sum().backward()
    assert not attn._cache and attn.cpb_mlp[2].weight.grad.abs().sum() > 0


def test_stage_spans_count_the_masks_distinct_bytes():
    """What ``swin_attn_roofline`` counts of the masks from a ``swin.stage``
    span: the values a block's ``attn_mask`` holds once the copies of its
    images are left out (a window's in a rolled block, one otherwise), at
    a map whose first two stages roll (16^2 and 8^2, windows of 4) and
    whose last two the window covers (4^2, and 2^2 padded to 4^2: no
    roll)."""
    from perfbench import window_attention_counts

    net = _model(_weights())
    y = torch.zeros(3, 16, 16, SMALL["embed"])
    with torch.no_grad():
        for stage, attrs in zip(net.backbone.stages, net.backbone.stage_attrs(y)):
            h, w = y.shape[1:3]
            if stage.downsample is not None:
                h, w = -(-h // 2), -(-w // 2)
            distinct = 0
            for block in stage.blocks:
                attn = block.attn
                mask = attn.mask_and_scale(attn.geometry(h, w), 3, torch.float32)[0]
                copies = attrs["windows"] if attn.rolls(h, w) else 1
                assert mask.shape[0] == (3 * copies if copies > 1 else 1)
                distinct += mask[:copies].numel() * 4
            assert window_attention_counts.mask_bytes(attrs) == distinct
            assert attrs["mask_bytes"] >= distinct
            y = stage(y)
    assert [a["rolled"] for a in net.backbone.stage_attrs(torch.zeros(3, 16, 16, 16))] == \
        [1, 1, 0, 0]


def _graph_stubs(monkeypatch):
    """A capture that records the stages and a replay that runs them, on
    the CPU; the calls made, in order."""
    calls = []

    def capture(self):
        calls.append("capture")
        return not calls.count("fail")

    def replay(self, x, spans):
        calls.append("replay")
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats

    monkeypatch.setattr(satlas, "graphable", lambda x: not torch.is_grad_enabled())
    monkeypatch.setattr(satlas.StageGraphs, "capture", capture)
    monkeypatch.setattr(satlas.StageGraphs, "replay", replay)
    return calls


def test_stages_are_captured_on_the_third_forward_of_a_shape(monkeypatch):
    """The graph bookkeeping on the CPU: two eager forwards of a shape,
    the capture on the third, replays after; a changed parameter starts
    the count again; a failed capture leaves the shape eager. Outside a
    graphable forward (autograd on) nothing is counted."""
    calls = _graph_stubs(monkeypatch)
    w = _weights()
    net = _model(w)
    x = _chips(3, 1, 32)
    want = ref.logits(w, x, SMALL, Ops("float32"))
    with torch.no_grad():
        for _ in range(4):
            torch.testing.assert_close(net(x)["logits"], want, rtol=0, atol=ATOL)
        assert calls == ["capture", "replay", "replay"]
        net.backbone.stages[2].blocks[0].norm1.weight.add_(0.0)  # a new version
        for _ in range(3):
            net(x)
        assert calls[3:] == ["capture", "replay"]
        calls.append("fail")
        for _ in range(4):
            net(_chips(3, 1, 16))
        assert calls[-2:] == ["fail", "capture"]
        assert None in net.backbone._graphs.values()
    net(x)  # autograd on: eager, not counted
    assert calls[-1] == "capture"


def test_the_backbone_keeps_the_graphs_of_at_most_four_shapes(monkeypatch):
    """Three forwards each of six input shapes: each shape is captured and
    replayed on its third, and the backbone keeps the last four shapes'
    entries (the least recently used dropped, and captured again when it
    comes back)."""
    calls = _graph_stubs(monkeypatch)
    net = _model(_weights())
    sides = [16, 24, 32, 40, 48, 56]
    with torch.no_grad():
        for side in sides:
            for _ in range(3):
                net(_chips(3, 1, side))
        assert calls == ["capture", "replay"] * 6
        assert len(net.backbone._graphs) == satlas.MAX_GRAPHS == 4
        assert [k[0][1:3] for k in net.backbone._graphs] == [(s // 4, s // 4) for s in sides[2:]]
        assert all(isinstance(g, satlas.StageGraphs) for g in net.backbone._graphs.values())
        for _ in range(3):
            net(_chips(3, 1, sides[0]))
        assert calls[12:] == ["capture", "replay"] and len(net.backbone._graphs) == 4


def test_to_serving_casts_to_bfloat16_channels_last():
    w = _weights()
    served = predict.to_serving(_model(w), CPU, torch.bfloat16)
    served = served.to(memory_format=torch.channels_last)
    conv = served.upsample[0].conv.weight
    assert conv.dtype == torch.bfloat16 and conv.is_contiguous(memory_format=torch.channels_last)
    x = _chips(4, 2, 32)
    with torch.no_grad():
        got = served(x)["probs"]
        want = torch.sigmoid(ref.logits(w, x, SMALL, Ops("float32")))
    assert got.dtype == torch.float32
    # bfloat16 keeps 8 bits: eight small blocks and the head move a
    # probability by a few hundredths at most
    assert (got - want).abs().max() < 0.05


def test_engine_matches_the_reference_blend():
    """A 2-date scene through ``TiledInferenceEngine`` (hann blend, 24 + 8
    geometry, a batch that pads) against ``reference/tiling.py``."""
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


def test_swin_spans_under_a_profiler():
    """Per forward one ``swin.embed``, four ``swin.stage`` with the
    attention's shapes, then ``satlas.aggregate``, ``satlas.fpn`` and
    ``satlas.head``, each inside the engine's ``serve.forward``; no
    attribute is named ``batch`` (the training batch's id in the log)."""
    net = _model(_weights())
    scene = _chips(6, 1, 40)[0]  # one chip of 44^2: maps 11, 6, 3, 2
    engine = TiledInferenceEngine(lambda x: net(x)["probs"], kernel=40, buffer=4, batch_size=2,
                                  blend="hann", device="cpu")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        engine.predict_scene(scene)
    log = span_log()
    forwards = {r.id: r for r in log if r.name == "serve.forward"}
    mine = [r for r in log if r.name.startswith(("swin.", "satlas."))]
    assert len(forwards) == 1
    assert [r.name for r in mine] == ["swin.embed"] + ["swin.stage"] * 4 + [
        "satlas.aggregate", "satlas.fpn", "satlas.head"]
    assert all(r.parent in forwards for r in mine)
    stages = [r.attrs for r in mine[1:5]]
    assert all("batch" not in r.attrs for r in mine)
    # images 2 chips x 2 dates; windows of 4^2 over maps padded to 12, 8, 4, 4;
    # the masks of a block without a roll and of a rolled one (a copy a
    # window of each image; stages 2-3 are one window, not rolled)
    assert stages[0] == {"stage": 0, "images": 4, "windows": 9, "tokens": 16, "heads": 2,
                         "head_dim": 8, "layers": 2, "rolled": 1, "dtype": "float32",
                         "mask_bytes": (1 + 4 * 9) * 2 * 16 * 16 * 4, "padded_tokens": 144 - 121}
    assert [s["mask_bytes"] for s in stages[1:]] == [(1 + 4 * 4) * 2 * 256 * 4, 2 * 4 * 256 * 4,
                                                     2 * 4 * 256 * 4]
    assert [(s["windows"], s["heads"], s["head_dim"], s["rolled"], s["padded_tokens"])
            for s in stages[1:]] == [(4, 2, 16, 1, 64 - 36), (1, 4, 16, 0, 16 - 9),
                                     (1, 4, 32, 0, 16 - 4)]
    assert mine[0].attrs == {"images": 4} and mine[5].attrs == {"images": 4, "frames": 2}
    assert mine[6].attrs == mine[7].attrs == {"chips": 2}


def test_load_model_serves_a_saved_checkpoint(tmp_path):
    w = _weights()
    net = _model(w)
    save_checkpoint(str(tmp_path), net, {"step": 1})
    served = predict.load_model(str(tmp_path), CPU, arch="satlas")
    x = _chips(8, 2, 32)
    with torch.no_grad():
        torch.testing.assert_close(served(x)["probs"], net(x)["probs"], rtol=0, atol=0)
    assert served.kwargs == net.kwargs
    with pytest.raises(ValueError, match="holds a satlas model, not a prithvi"):
        predict.load_model(str(tmp_path), CPU, arch="prithvi")
    (tmp_path / "jax" / "best").mkdir(parents=True)
    (tmp_path / "jax" / "best" / "state.msgpack").write_bytes(b"")
    with pytest.raises(ValueError, match="the JAX package has no satlas"):
        predict.load_model(str(tmp_path / "jax"), CPU, arch="satlas")


def test_zoo_builds_and_the_cli_serves_it(tmp_path):
    """The zoo's ``satlas`` takes a preset's bands as one date (scaled
    already); the ``predict`` CLI serves its checkpoint over a scene."""
    fam = zoo.get_family("satlas")
    net = fam.build(SOLAR_CONFIG, embed=8, depths=(1, 1), heads=(2, 2), window=4, fpn=8,
                    upsample_widths=(4, 4), head_width=4)
    assert net.kwargs["in_channels"] == 6 and net.kwargs["frames"] == 1
    assert net.kwargs["scale"] is None
    (x,) = fam.example_inputs(SOLAR_CONFIG)
    with torch.no_grad():
        assert net.eval()(torch.from_numpy(x[:, :32, :32]))["probs"].shape == (1, 32, 32, 1)
    save_checkpoint(str(tmp_path), net)
    scene = np.random.default_rng(0).uniform(0, 1, (40, 36, 6)).astype(np.float32)
    np.save(tmp_path / "scene.npy", scene)
    out = tmp_path / "pred.tif"
    predict.main(["scene", "--input", str(tmp_path / "scene.npy"), "--ckpt", str(tmp_path),
                  "--model", "satlas", "--kernel", "24", "--buffer", "8", "--batch-size", "4",
                  "--uint8", "--device", "cpu", "--output", str(out)])
    pred, _ = read_geotiff(str(out))
    assert pred.shape == (40, 36, 1) and pred.dtype == np.uint8


def test_train_and_evaluate_clis_take_it(tmp_path, monkeypatch):
    """``train --model satlas`` on EE-schema TFRecords at a small width:
    torchvision's initialisation, two steps, a checkpoint that ``predict``
    and ``evaluate --model satlas`` read."""
    import dataclasses

    from satellite_computervision_tpu_torch import evaluate as evaluate_cli
    from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
    from satellite_computervision_tpu_torch.train import __main__ as train_cli

    small = dataclasses.replace(SOLAR_CONFIG, kernel_size=32, batch_size=2, axes=(0, 1))
    monkeypatch.setitem(train_cli.CONFIGS, "solar", small)
    monkeypatch.setitem(evaluate_cli.CONFIGS, "solar", small)
    fam = zoo.FAMILIES["satlas"]
    monkeypatch.setitem(zoo.FAMILIES, "satlas", dataclasses.replace(
        fam, build=lambda cfg, **kw: fam.build(cfg, embed=8, depths=(1, 1), heads=(2, 2),
                                               window=4, fpn=8, upsample_widths=(4, 4),
                                               head_width=4, **kw)))
    rng = np.random.default_rng(0)
    chips = tmp_path / "train.tfrecord.gz"
    write_tfrecord_file(str(chips), [
        {**{b: rng.uniform(0, 0.3, 32 * 32).astype(np.float32) for b in small.bands},
         "landcover": (rng.uniform(size=32 * 32) > 0.7).astype(np.float32)} for _ in range(4)])
    ckpt = str(tmp_path / "run")
    trainer = train_cli.main(["--config", "solar", "--model", "satlas", "--train", str(chips),
                              "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", "2",
                              "--batch-size", "2", "--device", "cpu"])
    assert trainer.state.step == 2
    attn = trainer.state.model.backbone.stages[0].blocks[0].attn
    assert torch.allclose(attn.logit_scale, torch.full_like(attn.logit_scale, math.log(10.0)),
                          atol=0.01)  # log 10, moved a little
    assert predict.load_model(ckpt, CPU, arch="satlas").kwargs["embed"] == 8
    report = evaluate_cli.main(["--config", "solar", "--model", "satlas", "--ckpt", ckpt,
                                "--eval", str(chips), "--batch-size", "2", "--device", "cpu"])
    assert np.asarray(report["counts"]).sum() == 4 * 32 * 32


def test_reference_imports_nothing_of_the_port():
    tree = ast.parse((REPO / "perfbench" / "reference" / "satlas.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {n.split(".")[0] for n in names} <= {"__future__", "math", "torch", "perfbench"}
    assert all(n == "perfbench.reference.layers" for n in names if n.startswith("perfbench"))
