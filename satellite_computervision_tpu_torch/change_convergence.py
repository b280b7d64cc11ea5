"""Change-detection convergence run in the port: quality evidence at
workload scale.

The twin of ``examples/change_convergence.py``: the FULL Siamese U-Net
(filters 32/64/128, ASPP per tower) trained under the reference's
optimization config (4 S2 bands per date, 256² chips, batch 8, Adam 9e-4,
weighted BCE pos_weight 4, threshold 0.5) on the JAX script's procedural
before/after pairs: per-date radiometric drift, vegetation phenology
between dates (not change), water and pre-existing structures in both
dates, new construction in the after date (change). ``_date_dn`` and
``make_chip`` are copies of the JAX script's, so both train on the same
chips in the same order.

The chips are z-normalized per pixel across bands, the serving transform
(the reference trains on /10000 chips but serves band-normalized scenes;
the harness trains on what it serves, as the JAX one does). After
training, ``--scene-eval`` runs the serving path: synthetic item sets with
cloud-masked NaN patches -> ``cloud.compositing.change_pair_composite`` on
the device -> the tiled engine over the 8-band stack in ``hann`` mode (one
``hann_stitch``) and ``whole`` mode, IoU per mode. On CUDA the forward
runs in bfloat16 under autocast; on the CPU in float32. JSONL goes to
``runs/torch/change_convergence.jsonl`` by default.

Usage:
  python -m satellite_computervision_tpu_torch.change_convergence \\
      --train-size 400 --eval-size 96 --epochs 20 --scene-eval
  ... --device cpu                          # on the CPU (default cuda)
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np
import torch
import torch.nn as nn

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.cloud.compositing import change_pair_composite
from satellite_computervision_tpu_torch.convergence_common import (
    autocast,
    run_convergence,
    scene_iou,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import SiameseUNet, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

BANDS = ("B02", "B03", "B04", "B08")
NB = len(BANDS)
K = 256

# per-band (vegetation, soil, water, built) mean DNs — S2 L2A-ish
VEG = np.array([400, 600, 400, 3200], np.float32)
SOIL = np.array([1100, 1300, 1600, 2600], np.float32)
WATER = np.array([450, 500, 400, 200], np.float32)
BUILT = np.array([1600, 1700, 1900, 1500], np.float32)


class StackedSiamese(nn.Module):
    """One-input wrapper: (B, H, W, 2*NB) -> SiameseUNet(before, after), so
    the 8-band stacked pair rides the shared loop and the tiled engine.
    The Siamese U-Net sits under ``core``, as in the JAX wrapper's tree."""

    def __init__(self, threshold: float = 0.5):
        super().__init__()
        self.core = SiameseUNet(NB, filters=(32, 64, 128), factors=(2, 2, 2),
                                threshold=threshold)

    def forward(self, x):
        return self.core(x[..., :NB], x[..., NB:])


def normalize_composite(composite: np.ndarray, axis: int = -1,
                        epsilon: float = 1e-8) -> np.ndarray:
    """Host numpy z-score along ``axis`` with NaN-ignoring moments: the
    chips' transform, a copy of the JAX package's (numpy) function, so the
    chips are bit-equal to the JAX script's. The served scenes go through
    the port's device ``cloud.compositing.normalize_composite``."""
    composite = np.asarray(composite, np.float32)
    with warnings.catch_warnings():
        # pixels NaN in every band (cloud-masked everywhere) stay NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        mean = np.nanmean(composite, axis=axis, keepdims=True)
        std = np.nanstd(composite, axis=axis, keepdims=True)
    return (composite - mean) / (std + epsilon)


def _date_dn(rng, veg_frac, season):
    """(K, K, 4) DNs for one date: vegetation/soil mix at a seasonal
    vegetation level, with per-date radiometric gain/offset drift."""
    vf = np.clip(veg_frac * season, 0.0, 1.0)[..., None]
    dn = vf * VEG + (1.0 - vf) * SOIL
    gain = rng.uniform(0.85, 1.2)
    offset = rng.uniform(-80, 120)
    return dn * gain + offset


def make_chip(split: str, index: int):
    """Deterministic ((K,K,8) z-normed stacked pair, (K,K,1) change label)."""
    rng = np.random.default_rng(stable_seed(split, index))

    veg_frac = 0.5 + 0.5 * smooth_field(rng, K)
    # phenology confuser: the whole scene greens up/browns down between
    # dates — a large spectral change that must NOT be called change
    before = _date_dn(rng, veg_frac, season=rng.uniform(0.55, 1.0))
    after = _date_dn(rng, veg_frac, season=rng.uniform(0.25, 0.9))
    label = np.zeros((K, K), np.float32)

    # water body, constant in both dates (40%)
    if rng.random() < 0.4:
        cy, cx = rng.integers(30, K - 30, 2)
        r = rng.integers(12, 36)
        yy, xx = np.ogrid[:K, :K]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        w = WATER * rng.uniform(0.9, 1.1)
        before[blob] = w
        after[blob] = w

    def put_built(img, fy, fx, side, jitter):
        img[fy : fy + side, fx : fx + side] = BUILT * jitter + rng.normal(
            0, 40, (side, side, NB)
        )

    # pre-existing structure in BOTH dates = no change (50%)
    if rng.random() < 0.5:
        side = int(rng.integers(16, 48))
        fy, fx = (int(v) for v in rng.integers(4, K - 52, 2))
        j = rng.uniform(0.9, 1.1)
        put_built(before, fy, fx, side, j)
        put_built(after, fy, fx, side, j * rng.uniform(0.95, 1.05))

    # new construction in the AFTER date only = change (60%)
    if rng.random() < 0.6:
        side = int(rng.integers(24, 72))
        fy, fx = (int(v) for v in rng.integers(4, K - 76, 2))
        put_built(after, fy, fx, side, rng.uniform(0.9, 1.1))
        label[fy : fy + side, fx : fx + side] = 1.0

    before += rng.normal(0, 45, before.shape)
    after += rng.normal(0, 45, after.shape)

    # train on exactly the serving transform: per-pixel z-normalization
    # across bands, which also absorbs the per-date gain/offset drift
    x = np.concatenate(
        [normalize_composite(before), normalize_composite(after)], axis=-1
    )
    return x.astype(np.float16), label[..., None].astype(np.uint8)


def scene_eval(model, threshold, grid=4, seed=123, device="cuda", compute_dtype=None):
    """The serving path end to end: item sets -> change_pair_composite (on
    ``device``) -> tiled engines (hann chip grid AND whole-scene) -> IoU
    per mode."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    h = w = grid * K
    veg_frac = 0.5 + 0.5 * smooth_field(rng, h)
    label = np.zeros((h, w), np.float32)

    def items(season, farms, date):
        out = []
        for _ in range(3):
            dn = _date_dn(rng, veg_frac, season * rng.uniform(0.95, 1.05))
            dn = dn + rng.normal(0, 45, dn.shape)
            for (fy, fx, side) in farms:
                dn[fy : fy + side, fx : fx + side] = BUILT * rng.uniform(
                    0.9, 1.1
                ) + rng.normal(0, 40, (side, side, NB))
            # cloud-masked nodata patch (compositing must fill it)
            cy, cx = rng.integers(0, h - 64), rng.integers(0, w - 64)
            dn[cy : cy + 64, cx : cx + 64] = np.nan
            out.append({
                "datetime": date,
                "bands": {b: dn[..., i] for i, b in enumerate(BANDS)},
            })
        return out

    olds, news = [], []
    for _ in range(6):  # pre-existing structures
        side = int(rng.integers(16, 48))
        fy, fx = (int(v) for v in rng.integers(8, h - 56, 2))
        olds.append((fy, fx, side))
    for _ in range(8):  # new construction
        side = int(rng.integers(24, 72))
        fy, fx = (int(v) for v in rng.integers(8, h - 80, 2))
        news.append((fy, fx, side))
        label[fy : fy + side, fx : fx + side] = 1.0

    before_items = items(rng.uniform(0.55, 1.0), olds, "2021-06-01")
    after_items = items(rng.uniform(0.25, 0.9), olds + news, "2022-06-01")
    stack = change_pair_composite(before_items, after_items, BANDS, device=device)

    model.eval()

    def predict(chips):
        with torch.no_grad(), autocast(device, compute_dtype):
            return model(chips)["probs"]

    want = label.astype(bool)
    out = {}
    for mode, kw in [
        ("hann", dict(blend="hann", index_mode="grid")),
        ("whole", dict(tile_mode="whole", whole_multiple=8)),
    ]:
        eng = TiledInferenceEngine(predict, kernel=K, buffer=128, batch_size=8,
                                   out_channels=1, device=device, **kw)
        prob = eng.predict_scene(stack).float().cpu().numpy()[..., 0]
        out[mode] = scene_iou(prob, want, threshold)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-size", type=int, default=400)
    ap.add_argument("--eval-size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--pos-weight", type=float, default=4.0)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--out", default="runs/torch/change_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene-eval", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    model = StackedSiamese(threshold=args.threshold)
    model = flax_init_(model, torch.Generator().manual_seed(args.seed)).to(device)
    state = create_train_state(model, args.lr)
    loss_fn = lambda y, p: losses.weighted_bce(  # noqa: E731
        y, p, pos_weight=args.pos_weight, logits=True)
    train_step = make_train_step(loss_fn, pred_key="logits", num_classes=2,
                                 compute_dtype=compute_dtype)
    eval_step = make_eval_step(loss_fn, pred_key="logits", num_classes=2,
                               compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "a")

    print(f"change convergence: {args.train_size} pair chips x "
          f"{args.epochs} epochs, batch {args.batch_size}, device {device}")
    state, best = run_convergence(
        state, train_step, eval_step, make_chip, args, log,
        keep_best_state=args.scene_eval)

    summary = {"final": {k: round(float(v), 4) for k, v in best.items()},
               "config": vars(args)}
    if args.scene_eval:
        iou = scene_eval(state.model, args.threshold, device=device,
                         compute_dtype=compute_dtype)
        print("SCENE_EVAL " + json.dumps(iou))
        log.write(json.dumps({"scene_eval_iou": iou}) + "\n")
        summary["scene_eval_iou"] = iou
    print("SUMMARY " + json.dumps(summary))
    log.write(json.dumps(summary) + "\n")
    log.close()
    return summary


if __name__ == "__main__":
    main()
