"""Hybrid U-Net + ConvLSTM convergence run in the port: quality evidence for
the hybrid family, the reference's wetland/landcover workhorse.

The twin of ``examples/hybrid_convergence.py``: the full two-branch
``HybridUNetLSTM`` (a U-Net over the single-date image with pools 3, 2, 2,
2, a ConvLSTM branch over a 3x coarser series, fused by a 1x1 conv)
trained with weighted categorical CE (weights [2, 1, 1, 1, 1, 2], Adam
9e-4) on the JAX script's procedural chips: six classes in contiguous
patches, grass and crop spectrally identical in the single date and
separable only through the seasonal amplitude of the series, which is
block-averaged 3x coarser than the image. At the script's 96² the pools
take 96 -> 32 -> 16 -> 8 -> 4, which round-trips. ``make_chip`` and
``batches`` are copies of the JAX script's numpy code, so both train on
the same chips in the same order.

Per epoch: mean IoU, accuracy and per-class IoU, as JSONL (default
``runs/torch/hybrid_convergence.jsonl``) with a final summary of the best
epoch on the unrounded mean IoU.

On CUDA the forward runs in bfloat16 under autocast over float32
parameters (the JAX model's ``dtype=bfloat16``); the ConvLSTM carry stays
float32. The JAX loop hands each step a fresh ``jax.random`` key; the
port's step takes none: the script builds the model with ``dropout`` None,
so nothing draws from it.

Usage:
  python -m satellite_computervision_tpu_torch.hybrid_convergence
  ... --device cpu                          # on the CPU (default cuda)
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.convergence_common import (
    AMPS,
    CLASSES,
    NCLASS,
    PERIOD,
    SIGS,
    autocast,
    chip_batches,
    multiclass_metrics,
    port_timings,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.models import HybridUNetLSTM, losses
from satellite_computervision_tpu_torch.models import metrics as metrics_lib
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

K, T, NB = 96, 6, 4  # U-Net grid 96^2 (divisible by 3*2*2*2), 6-step series
KS = K // 3  # series grid: 3x coarser (NAIP 1 m vs S2 ~3 m analog)
WEIGHTS = [2.0, 1.0, 1.0, 1.0, 1.0, 2.0]


def make_chip(split: str, index: int):
    """Deterministic ((K,K,4) f16 NAIP-scale image, (T,KS,KS,4) f16
    coarse series, (K,K,6) u8 one-hot labels)."""
    rng = np.random.default_rng(stable_seed(split, index))

    bias = np.array([-0.5, 0.2, 0.2, 0.2, -0.1, -0.4], np.float32)
    fields = np.stack([
        smooth_field(rng, K, scale=32) + bias[c] for c in range(NCLASS)
    ])
    label = np.argmax(fields, axis=0).astype(np.int32)
    base = SIGS[label]
    illum = rng.uniform(0.85, 1.15)

    img = base * illum + rng.normal(0, 0.03, base.shape)
    img = img + 0.05 * smooth_field(rng, K, scale=16)[..., None]
    img = np.clip(img, 0, 1.5).astype(np.float16)

    # coarse seasonal series: block-average the fine grid 3x, then cycle
    t0 = rng.uniform(0, PERIOD)
    t = (t0 + np.arange(T)).reshape(T, 1, 1, 1)
    season = np.sin(2 * np.pi * t / PERIOD)
    season_dir = np.array([-0.3, 0.4, 0.0, 1.0], np.float32)
    amp = AMPS[label][..., None]
    fine = base[None] + amp[None] * season * season_dir  # (T, K, K, 4)
    coarse = fine.reshape(T, KS, 3, KS, 3, NB).mean(axis=(2, 4))
    coarse = coarse * illum + rng.normal(0, 0.03, coarse.shape)
    series = np.clip(coarse, 0, 1.5).astype(np.float16)

    onehot = np.eye(NCLASS, dtype=np.uint8)[label]
    return img, series, onehot


def batches(split, n, batch, rng, shuffle=True, device="cuda", timing=None):
    """``((img, series), y)`` device batches in the JAX script's order."""
    for img, ser, y in chip_batches(make_chip, split, n, batch, rng, shuffle=shuffle,
                                    device=device, timing=timing):
        yield (img, ser), y


def build_model(lstm_features: int, seed: int):
    model = HybridUNetLSTM(NB, NB, n_classes=NCLASS, lstm_features=lstm_features)
    return flax_init_(model, torch.Generator().manual_seed(seed))


def loss_fn(y, p):
    return losses.weighted_categorical_crossentropy(y, p, WEIGHTS, reduce_mean=True)


def eval_batch(model, x, y, compute_dtype=None):
    """(loss, confusion matrix) of one batch with the running BN
    statistics."""
    model.eval()
    with torch.no_grad(), autocast(x[0].device, compute_dtype):
        out = model(*x)
    with torch.no_grad():
        cm = metrics_lib.confusion_matrix(torch.argmax(y, -1), out["classes"], NCLASS)
        return loss_fn(y, out["probs"]), cm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-size", type=int, default=640)
    ap.add_argument("--eval-size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--lstm-features", type=int, default=32)
    ap.add_argument("--out", default="runs/torch/hybrid_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    state = create_train_state(build_model(args.lstm_features, args.seed).to(device), args.lr)
    train_step = make_train_step(loss_fn, pred_key="probs", num_classes=NCLASS,
                                 compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as log:
        print(f"hybrid convergence: {args.train_size} chips x {args.epochs} "
              f"epochs, batch {args.batch_size}, {NCLASS} classes, device {device}")

        rng = np.random.default_rng(args.seed)
        best, best_miou = None, float("-inf")
        for epoch in range(args.epochs):
            t0 = time.time()
            timing = {"synth_secs": 0.0}
            tloss, steps = None, 0
            for x, y in batches("train", args.train_size, args.batch_size, rng,
                                device=device, timing=timing):
                out = train_step(state, (x, y))
                tloss = out["loss"] if tloss is None else tloss + out["loss"]
                steps += 1
            train_secs = time.time() - t0

            cm = np.zeros((NCLASS, NCLASS), np.float64)
            eloss, esteps = None, 0
            for x, y in batches("eval", args.eval_size, args.batch_size, rng,
                                shuffle=False, device=device, timing=timing):
                loss, bcm = eval_batch(state.model, x, y, compute_dtype)
                cm += bcm.cpu().numpy().astype(np.float64)
                eloss = loss if eloss is None else eloss + loss
                esteps += 1

            m = multiclass_metrics(cm, CLASSES)
            rec = {
                "epoch": epoch,
                "train_loss": float(tloss) / max(steps, 1),
                "eval_loss": float(eloss) / max(esteps, 1),
                **{k: round(float(v), 4) for k, v in m.items()},
                "secs": round(time.time() - t0, 1),
                **port_timings(steps, args.batch_size, train_secs, timing),
            }
            # unrounded monitor, tracked apart from the rounded record
            if m["mean_iou"] >= best_miou:
                best_miou = float(m["mean_iou"])
                best = {"epoch": epoch,
                        **{k: round(float(v), 4) for k, v in m.items() if k != "iou"}}
            print(json.dumps(rec))
            log.write(json.dumps(rec) + "\n")
            log.flush()

        summary = {"final": best, "config": vars(args)}
        print("SUMMARY " + json.dumps(summary))
        log.write(json.dumps(summary) + "\n")
    return summary


if __name__ == "__main__":
    main()
