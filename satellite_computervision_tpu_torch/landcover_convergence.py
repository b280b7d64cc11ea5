"""Multiclass land-cover convergence run in the port: quality evidence for
the gen_dice / weighted-categorical-crossentropy loss paths.

The twin of ``examples/landcover_convergence.py``: a FULL multiclass
U-Net (filters 32/64/128/256, factors 2 x 4, softmax head) trained under
the reference's land-cover optimization config (4 NAIP bands, 256² chips,
batch 8, Adam 9e-4, 8 classes) on the JAX script's procedural chips:
contiguous class regions (argmax of per-class smooth fields), spectrally
confusable class pairs under per-chip illumination drift, building
rectangles and thin roads. ``make_chip`` and the palette are copies of the
JAX script's, so both train on the same chips in the same order.

Per epoch: mean IoU, accuracy and per-class IoU of all 8 classes from the
streaming confusion matrix, with ``loss_name`` (and ``gdl_counts`` under
gen_dice) in every record, as JSONL (default
``runs/torch/landcover_convergence.jsonl``) with a final summary.
``--scene-eval`` serves the BEST epoch's model over a 1024² scene of 4 x 4
unseen chips through the tiled engine with 8 output channels in two modes:
``hann`` (one ``hann_stitch`` of the 16 chips' 8-class softmax maps) and
``whole``; argmax, a per-class confusion matrix and its mean IoU per mode.

On CUDA the forward runs in bfloat16 under autocast over float32
parameters (the JAX model's ``dtype=bfloat16``); on the CPU in float32.

Usage:
  python -m satellite_computervision_tpu_torch.landcover_convergence --loss wcce --scene-eval
  ... --loss gen_dice --gdl-counts batch
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
    multiclass_metrics,
    run_convergence,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import UNet, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

K = 256
CLASSES = ["water", "tree", "grass", "barren",
           "impervious", "road", "crop", "wetland"]
NCLASS = len(CLASSES)

# per-class (R, G, B, N) reflectance means on NAIP's 0-1 scale — chosen
# so the confusable pairs overlap (tree/wetland/water share low visible;
# road/impervious share grey visible; grass/crop share green+NIR)
SIGS = np.array([
    [0.10, 0.14, 0.20, 0.06],   # water
    [0.14, 0.24, 0.13, 0.58],   # tree
    [0.34, 0.44, 0.24, 0.52],   # grass
    [0.55, 0.50, 0.44, 0.38],   # barren
    [0.56, 0.56, 0.56, 0.30],   # impervious
    [0.32, 0.32, 0.34, 0.16],   # road (darker grey, low NIR)
    [0.42, 0.50, 0.28, 0.66],   # crop (brighter green, high NIR)
    [0.17, 0.26, 0.20, 0.42],   # wetland (tree-water mix)
], np.float32)
NB = SIGS.shape[1]

# natural background classes laid out as contiguous patches
NATURAL = [0, 1, 2, 3, 6, 7]  # water, tree, grass, barren, crop, wetland

# mild inverse-frequency weighting for wcce: the rare classes (water,
# wetland, road) get pulled up, as the reference's per-class weight
# vectors do
WCCE_WEIGHTS = [2.0, 1.0, 1.0, 1.0, 1.0, 2.0, 1.0, 2.0]


def make_chip(split: str, index: int):
    """Deterministic ((K,K,4) float16 NAIP chip, (K,K,8) uint8 one-hot)."""
    rng = np.random.default_rng(stable_seed(split, index))

    # contiguous regions: per-class smooth field + bias, argmax wins.
    # biases tilt the mix so rarer classes (water, wetland) form fewer,
    # smaller patches — realistic class imbalance for the weighted losses
    bias = np.array([-0.55, 0.25, 0.30, -0.05, 0.0, 0.0, 0.05, -0.45],
                    np.float32)
    fields = np.stack([
        smooth_field(rng, K, scale=32) + bias[c] for c in NATURAL
    ])
    label = np.asarray(NATURAL, np.int32)[np.argmax(fields, axis=0)]

    # buildings: impervious rectangles (60% of chips, 1-4 of them)
    if rng.random() < 0.6:
        for _ in range(int(rng.integers(1, 5))):
            h, w = (int(v) for v in rng.integers(10, 42, 2))
            y, x = int(rng.integers(0, K - h)), int(rng.integers(0, K - w))
            label[y : y + h, x : x + w] = 4
    # roads: thin straight cuts (70% of chips)
    if rng.random() < 0.7:
        for _ in range(int(rng.integers(1, 3))):
            w = int(rng.integers(3, 7))
            pos = int(rng.integers(0, K - w))
            if rng.random() < 0.5:
                label[pos : pos + w, :] = 5
            else:
                label[:, pos : pos + w] = 5

    chip = SIGS[label]
    # per-chip illumination drift + within-class texture
    chip = chip * rng.uniform(0.85, 1.15) + rng.uniform(-0.03, 0.03)
    chip = chip + rng.normal(0, 0.035, chip.shape).astype(np.float32)
    chip = chip + 0.05 * smooth_field(rng, K, scale=16)[..., None]

    onehot = np.eye(NCLASS, dtype=np.uint8)[label]
    return np.clip(chip, 0, 1).astype(np.float16), onehot


def build_model(seed: int) -> UNet:
    """The multiclass U-Net (32…256, softmax head), flax-initialized from
    ``seed``."""
    model = UNet(NB, n_classes=NCLASS, filters=(32, 64, 128, 256), factors=(2, 2, 2, 2),
                 head="softmax")
    return flax_init_(model, torch.Generator().manual_seed(seed))


def make_loss(name: str, gdl_counts: str = "batch"):
    """``loss(y, probs)`` of ``--loss``: wcce with :data:`WCCE_WEIGHTS`, or
    gen_dice with whole-batch or per-element class counts."""
    if name == "wcce":
        return lambda y, p: losses.weighted_categorical_crossentropy(
            y, p, WCCE_WEIGHTS, reduce_mean=True)
    return lambda y, p: losses.gen_dice(y, p, batch_counts=(gdl_counts == "batch"))


def scene_eval(model, device, compute_dtype=None, grid=4):
    """Multiclass scene serving: one ``grid*K``² scene tiled from unseen
    chips through the tiled engine (kernel 256, buffer 128, batch 8, 8
    softmax channels), argmax -> per-class confusion -> mean IoU per mode
    (``hann``: one ``hann_stitch``; ``whole``)."""
    model.eval()

    def predict(chips):
        with torch.no_grad(), autocast(device, compute_dtype):
            return model(chips)["probs"]

    tiles = [make_chip("scene", i) for i in range(grid * grid)]
    scene = np.concatenate(
        [np.concatenate([tiles[r * grid + c][0] for c in range(grid)], 1)
         for r in range(grid)], 0)
    labels = np.argmax(np.concatenate(
        [np.concatenate([tiles[r * grid + c][1] for c in range(grid)], 1)
         for r in range(grid)], 0), -1)
    scene_dev = torch.from_numpy(scene).to(device)

    out = {}
    for mode, kw in [
        ("hann", dict(blend="hann", index_mode="grid")),
        ("whole", dict(tile_mode="whole", whole_multiple=16)),
    ]:
        eng = TiledInferenceEngine(predict, kernel=K, buffer=128, batch_size=8,
                                   out_channels=NCLASS, device=device, **kw)
        pred = torch.argmax(eng.predict_scene(scene_dev), -1).cpu().numpy()
        cm = np.zeros((NCLASS, NCLASS), np.float64)
        np.add.at(cm, (labels.reshape(-1), pred.reshape(-1)), 1.0)
        out[mode] = round(multiclass_metrics(cm)["mean_iou"], 4)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--loss", choices=["gen_dice", "wcce"], default="gen_dice")
    ap.add_argument("--gdl-counts", choices=["element", "batch"],
                    default="batch",
                    help="gen_dice class-count pooling: 'batch' = Sudre et "
                    "al.'s whole-batch counts (stable); 'element' = per "
                    "batch element (1/count^2 explodes when a class has "
                    "few pixels in one element)")
    ap.add_argument("--train-size", type=int, default=800)
    ap.add_argument("--eval-size", type=int, default=160)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--out", default="runs/torch/landcover_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene-eval", action="store_true",
                    help="after training, score the BEST state's mean IoU "
                    "over a held-out 1024^2 scene through the tiled "
                    "engine (hann + whole modes)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    model = build_model(args.seed).to(device)
    state = create_train_state(model, args.lr)
    loss_fn = make_loss(args.loss, args.gdl_counts)
    train_step = make_train_step(loss_fn, pred_key="probs", num_classes=NCLASS,
                                 compute_dtype=compute_dtype)
    eval_step = make_eval_step(loss_fn, pred_key="probs", num_classes=NCLASS,
                               compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "a")
    print(f"landcover convergence ({args.loss}): {args.train_size} chips x "
          f"{args.epochs} epochs, batch {args.batch_size}, {NCLASS} classes, "
          f"device {device}")
    state, best = run_convergence(
        state, train_step, eval_step, make_chip, args, log,
        extra_record={"loss_name": args.loss,
                      **({"gdl_counts": args.gdl_counts}
                         if args.loss == "gen_dice" else {})},
        num_classes=NCLASS,
        metrics_fn=lambda cm: multiclass_metrics(cm, CLASSES),
        keep_best_state=args.scene_eval,
    )

    miou = None
    if args.scene_eval:
        miou = scene_eval(state.model, device, compute_dtype)
        print("SCENE_EVAL " + json.dumps(miou))
        log.write(json.dumps({"scene_eval_mean_iou": miou, "loss_name": args.loss}) + "\n")
        log.flush()

    summary = {"loss_name": args.loss,
               "final": {k: round(float(v), 4) for k, v in best.items()},
               "config": vars(args)}
    print("SUMMARY " + json.dumps(summary))
    log.write(json.dumps(summary) + "\n")
    log.close()
    if miou is not None:
        summary["scene_eval_mean_iou"] = miou
    return summary


if __name__ == "__main__":
    main()
