"""Solar-config convergence run in the port: the quality-parity harness.

The twin of ``examples/solar_convergence.py``: the FULL solar U-Net
(filters 32…512, factors 2 x 5, sigmoid head, threshold 0.9) trained under
the reference's optimization config (Adam 9e-4, weighted BCE on logits,
batch 16) on the JAX script's procedural Sentinel-2-like chips (6 bands
of reflectance; solar farms of striped panel rows; water and dark-road
confusers). ``make_chip`` is a copy of the JAX script's, so both train on
the same chips in the same order. Metrics per epoch: loss, IoU(solar),
F1, precision, recall and accuracy at the 0.9 threshold, written as JSONL
(default ``runs/torch/solar_convergence.jsonl``) with a final summary.

On CUDA the forward runs in bfloat16 under autocast over float32
parameters (the JAX model's ``dtype=bfloat16``); on the CPU in float32.
The best epoch's weights are saved as a checkpoint of the port
(``train/checkpoint.py``) in ``<out without .jsonl>_ckpt/best/model.pt``,
which the ``predict`` and ``evaluate`` CLIs load. ``--scene-eval`` scores
the final model over a 1024² scene of 4 x 4 unseen chips through the
tiled engine in three modes: ``chips`` (overwrite), ``hann`` (one
``hann_stitch``) and ``whole``.

Usage:
  python -m satellite_computervision_tpu_torch.solar_convergence \\
      --train-size 1540 --eval-size 330 --epochs 20 --scene-eval
  ... --space-to-depth                      # the S2D variant
  ... --device cpu                          # on the CPU (default cuda)
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.convergence_common import (
    autocast,
    binary_metrics,  # noqa: F401  (re-export, as the JAX script does)
    run_convergence,
    scene_iou,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import UNet, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
from satellite_computervision_tpu_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

BANDS = 6  # B2, B3, B4, B8, B11, B12
K = 256

# per-band (background-mix, vegetation, panel, water) mean DNs/1e4,
# loosely matching S2 L2A surface-reflectance statistics
VEG = np.array([0.031, 0.055, 0.034, 0.345, 0.176, 0.085], np.float32)
SOIL = np.array([0.110, 0.140, 0.180, 0.270, 0.320, 0.270], np.float32)
PANEL = np.array([0.060, 0.065, 0.060, 0.085, 0.100, 0.080], np.float32)
WATER = np.array([0.045, 0.050, 0.040, 0.020, 0.010, 0.008], np.float32)


def make_chip(split: str, index: int, k: int = K):
    """Deterministic (features (k,k,6) refl, label (k,k,1)) for an index:
    float16 features and uint8 labels (half the host-to-device bytes).
    ``k`` is the tile side (``--tile``); feature scales are in pixels, so
    a 512² chip is more landscape, not rescaled content."""
    rng = np.random.default_rng(stable_seed(split, index))

    veg_frac = 0.5 + 0.5 * smooth_field(rng, k)  # spatially correlated mix
    veg_frac = np.clip(veg_frac, 0.0, 1.0)[..., None]
    chip = veg_frac * VEG + (1 - veg_frac) * SOIL

    label = np.zeros((k, k), np.float32)

    # water confuser (30% of chips): dark blob
    if rng.random() < 0.3:
        cy, cx = rng.integers(30, k - 30, 2)
        r = rng.integers(12, 40)
        yy, xx = np.ogrid[:k, :k]
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        chip[blob] = WATER * rng.uniform(0.8, 1.2)

    # dark road confuser (40%)
    if rng.random() < 0.4:
        w = rng.integers(2, 5)
        pos = rng.integers(0, k - w)
        dark = PANEL * rng.uniform(0.9, 1.1) * np.array([1, 1, 1.2, 1.3, 1.5, 1.4], np.float32)
        if rng.random() < 0.5:
            chip[pos : pos + w, :] = dark
        else:
            chip[:, pos : pos + w] = dark

    # solar farm (60%): block of panel rows with row-gap striping
    if rng.random() < 0.6:
        fh = int(rng.integers(24, 96))
        fw = int(rng.integers(24, 96))
        fy = int(rng.integers(4, k - fh - 4))
        fx = int(rng.integers(4, k - fw - 4))
        farm = np.tile(PANEL, (fh, fw, 1)) * rng.uniform(0.9, 1.1)
        # panel-row striping: every 4th row line shows ground between rows
        stripe = (np.arange(fh) % 4 == 3)[:, None, None]
        ground = veg_frac[fy : fy + fh, fx : fx + fw] * VEG + (
            1 - veg_frac[fy : fy + fh, fx : fx + fw]
        ) * SOIL
        chip[fy : fy + fh, fx : fx + fw] = np.where(stripe, ground, farm)
        label[fy : fy + fh, fx : fx + fw] = 1.0

    chip = chip + rng.normal(0, 0.008, chip.shape).astype(np.float32)
    return np.clip(chip, 0, 1).astype(np.float16), label[..., None].astype(np.uint8)


def scene_eval(model, threshold, space_to_depth, device, compute_dtype=None, grid=4):
    """Full-scene inference quality of ``model``: the engine's three modes
    (chips, hann, whole) over one ``grid*K``² scene tiled from unseen
    chips -> {mode: IoU}. Kernel 256, buffer 128, batch 8."""
    model.eval()

    def predict(chips):
        with torch.no_grad(), autocast(device, compute_dtype):
            return model(chips)["probs"]

    pairs = [make_chip("scene", i) for i in range(grid * grid)]
    scene = np.concatenate(
        [np.concatenate([pairs[r * grid + c][0] for c in range(grid)], 1)
         for r in range(grid)], 0)
    labels = np.concatenate(
        [np.concatenate([pairs[r * grid + c][1] for c in range(grid)], 1)
         for r in range(grid)], 0)[..., 0].astype(bool)
    scene_dev = torch.from_numpy(scene).to(device)

    out = {}
    for mode, kw in [
        ("chips", dict(blend="overwrite", index_mode="grid")),
        ("hann", dict(blend="hann", index_mode="grid")),
        # S2D folds 2x2 before the 5-level trunk -> total downsample 64
        ("whole", dict(tile_mode="whole", whole_multiple=64 if space_to_depth else 32)),
    ]:
        eng = TiledInferenceEngine(predict, kernel=K, buffer=128, batch_size=8,
                                   out_channels=1, device=device, **kw)
        prob = eng.predict_scene(scene_dev).float().cpu().numpy()[..., 0]
        out[mode] = scene_iou(prob, labels, threshold)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-size", type=int, default=1540)
    ap.add_argument("--eval-size", type=int, default=330)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--pos-weight", type=float, default=2.0)
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--bn-momentum", type=float, default=0.9)
    ap.add_argument("--tile", type=int, default=K,
                    help="training tile side (default 256 = the reference "
                    "chip export; 512 = the large-tile training geometry)")
    ap.add_argument("--space-to-depth", action="store_true")
    ap.add_argument("--out", default="runs/torch/solar_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene-eval", action="store_true",
                    help="after training, score full-scene inference modes "
                    "(chips / hann / whole) on a 4x4-chip eval scene")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    model = UNet(
        BANDS,
        n_classes=1,
        filters=(32, 64, 128, 256, 512),
        factors=(2, 2, 2, 2, 2),
        head="sigmoid",
        threshold=args.threshold,
        bn_momentum=args.bn_momentum,
        space_to_depth=args.space_to_depth,
    )
    model = flax_init_(model, torch.Generator().manual_seed(args.seed)).to(device)
    state = create_train_state(model, args.lr)
    loss_fn = lambda y, p: losses.weighted_bce(y, p, pos_weight=args.pos_weight, logits=True)  # noqa: E731
    train_step = make_train_step(loss_fn, pred_key="logits", num_classes=2,
                                 compute_dtype=compute_dtype)
    eval_step = make_eval_step(loss_fn, pred_key="logits", num_classes=2,
                               compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    ckpt = os.path.splitext(args.out)[0] + "_ckpt"
    log = open(args.out, "a")

    print(f"solar convergence: {args.train_size} chips x {args.epochs} epochs, "
          f"batch {args.batch_size}, tile {args.tile}, "
          f"space_to_depth={args.space_to_depth}, device {device}")
    chip_fn = (make_chip if args.tile == K
               else lambda split, index: make_chip(split, index, k=args.tile))

    def keep(state, best):
        save_checkpoint(ckpt, state.model, {
            "epoch": best["epoch"], "metrics": {k: float(v) for k, v in best.items()}})

    state, best = run_convergence(
        state, train_step, eval_step, chip_fn, args, log,
        extra_record={"space_to_depth": args.space_to_depth, "tile": args.tile},
        on_best=keep,
    )
    print(f"best checkpoint (epoch {best.get('epoch')}): {ckpt}/best/model.pt")

    if args.scene_eval:
        # full-scene inference quality on the trained (final) model, as
        # the JAX script scores it
        iou = scene_eval(state.model, args.threshold, args.space_to_depth, device,
                         compute_dtype)
        print("SCENE_EVAL " + json.dumps(iou))
        log.write(json.dumps({"scene_eval_iou": iou}) + "\n")
        log.flush()

    summary = {"final": {k: round(float(v), 4) for k, v in best.items()},
               "config": vars(args)}
    print("SUMMARY " + json.dumps(summary))
    log.write(json.dumps(summary) + "\n")
    log.close()
    return summary


if __name__ == "__main__":
    main()
