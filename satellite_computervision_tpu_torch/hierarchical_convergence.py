"""Hierarchical ACNN + LSTM convergence run in the port: quality evidence
for the ACNN and hierarchical families and the multi-head weighted-CCE
loss.

The twin of ``examples/hierarchical_convergence.py``: the full three-head
``HierarchicalACNN`` (a coarse ``sub_probs`` head at mid trunk depth, a
fine ``acnn_probs`` head from the single-date image, a ``lstm_probs`` head
fused with a ConvLSTM branch over a Sentinel-2-like series) trained under
the reference's optimization config (Adam 9e-4, the summed per-head
weighted CCE, main-head class weights [2, 1, 1, 1, 1, 2]) on the JAX
script's procedural chips: six classes in contiguous patches, grouped into
three super-classes; grass and crop share one single-date signature and
differ only in seasonal amplitude in the series, with a random per-chip
season phase. ``make_chip`` and ``batches`` are copies of the JAX script's
numpy code, so both train on the same chips in the same order.

Per epoch: mean IoU and per-class IoU through ``lstm_probs``, mean, crop
and grass IoU through ``acnn_probs``, and the super-class mean IoU, as
JSONL (default ``runs/torch/hierarchical_convergence.jsonl``) with a final
summary of the best epoch on the unrounded ``lstm_probs`` mean IoU.

On CUDA the forward runs in bfloat16 under autocast over float32
parameters (the JAX model's ``dtype=bfloat16``); the ConvLSTM carry stays
float32. The JAX loop hands each step a fresh ``jax.random`` key; the
port's step takes none, and ``HierarchicalACNN`` has no dropout to draw.

Usage:
  python -m satellite_computervision_tpu_torch.hierarchical_convergence
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
    NSUB,
    PERIOD,
    SIGS,
    SUB_OF,
    SUBCLASSES,
    autocast,
    chip_batches,
    multiclass_metrics,
    port_timings,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.models import HierarchicalACNN, losses
from satellite_computervision_tpu_torch.models import metrics as metrics_lib
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

K, T, NB = 128, 6, 4
W_MAIN = np.array([2.0, 1.0, 1.0, 1.0, 1.0, 2.0], np.float32)
W_SUB = np.ones(NSUB, np.float32)


def make_chip(split: str, index: int):
    """Deterministic ((K,K,4) f16 image, (T,K,K,4) f16 series,
    (K,K,6) u8 one-hot main, (K,K,3) u8 one-hot sub)."""
    rng = np.random.default_rng(stable_seed(split, index))

    # contiguous class patches; biases keep water/wetland rarer
    bias = np.array([-0.5, 0.2, 0.2, 0.2, -0.1, -0.4], np.float32)
    fields = np.stack([
        smooth_field(rng, K, scale=32) + bias[c] for c in range(NCLASS)
    ])
    label = np.argmax(fields, axis=0).astype(np.int32)

    base = SIGS[label]  # (K, K, 4)
    illum = rng.uniform(0.85, 1.15)

    # timeseries: per-pixel seasonal cycle whose amplitude is set by the
    # class; random per-chip phase so the model must read it, not a clock
    t0 = rng.uniform(0, PERIOD)
    t = (t0 + np.arange(T)).reshape(T, 1, 1, 1)
    season = np.sin(2 * np.pi * t / PERIOD)  # (T,1,1,1)
    amp = AMPS[label][..., None]  # (K, K, 1)
    # greening raises NIR (band 3) and G (band 1), dims R a touch
    season_dir = np.array([-0.3, 0.4, 0.0, 1.0], np.float32)
    series = base + amp * season * season_dir
    series = series * illum + rng.normal(0, 0.03, series.shape)
    series = np.clip(series, 0, 1.5).astype(np.float16)

    # single-date image = an independent draw near mid-season (what the
    # acnn head sees; grass==crop here by construction)
    img = base * illum + rng.normal(0, 0.03, base.shape)
    img = img + 0.05 * smooth_field(rng, K, scale=16)[..., None]
    img = np.clip(img, 0, 1.5).astype(np.float16)

    y_main = np.eye(NCLASS, dtype=np.uint8)[label]
    y_sub = np.eye(NSUB, dtype=np.uint8)[SUB_OF[label]]
    return img, series, y_main, y_sub


def batches(split, n, batch, rng, shuffle=True, device="cuda", timing=None):
    """``((img, series), (y_main, y_sub))`` device batches in the JAX
    script's order."""
    for img, ser, ym, ys in chip_batches(make_chip, split, n, batch, rng, shuffle=shuffle,
                                         device=device, timing=timing):
        yield (img, ser), (ym, ys)


def build_model(n_blocks: int, features: int, lstm_features: int, seed: int):
    model = HierarchicalACNN(NB, NB, n_classes=NCLASS, acnn_classes=NCLASS, sub_classes=NSUB,
                             n_blocks=n_blocks, features=features,
                             lstm_features=lstm_features)
    return flax_init_(model, torch.Generator().manual_seed(seed))


def loss_fn(y, out):
    """The summed weighted CCE of the three heads."""
    y_main, y_sub = y
    wcce = losses.weighted_categorical_crossentropy
    return (wcce(y_main, out["lstm_probs"], W_MAIN, reduce_mean=True)
            + wcce(y_main, out["acnn_probs"], W_MAIN, reduce_mean=True)
            + wcce(y_sub, out["sub_probs"], W_SUB, reduce_mean=True))


def eval_batch(model, x, y, compute_dtype=None):
    """(loss, {head: confusion matrix}) of one batch with the running BN
    statistics; the ``lstm`` and ``acnn`` heads against the main classes,
    ``sub`` against the super-classes."""
    model.eval()
    with torch.no_grad(), autocast(x[0].device, compute_dtype):
        out = model(*x)
    with torch.no_grad():
        y_main, y_sub = y
        ym = torch.argmax(y_main, -1)
        cms = {head: metrics_lib.confusion_matrix(
            ym, torch.argmax(out[f"{head}_probs"], -1), NCLASS) for head in ("lstm", "acnn")}
        cms["sub"] = metrics_lib.confusion_matrix(
            torch.argmax(y_sub, -1), torch.argmax(out["sub_probs"], -1), NSUB)
        return loss_fn(y, out), cms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-size", type=int, default=480)
    ap.add_argument("--eval-size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--lstm-features", type=int, default=32)
    ap.add_argument("--out", default="runs/torch/hierarchical_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    model = build_model(args.n_blocks, args.features, args.lstm_features, args.seed)
    state = create_train_state(model.to(device), args.lr)
    train_step = make_train_step(loss_fn, pred_key=None, num_classes=NCLASS,
                                 compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as log:
        print(f"hierarchical convergence: {args.train_size} chips x "
              f"{args.epochs} epochs, batch {args.batch_size}, "
              f"{NCLASS} classes / {NSUB} super-classes, device {device}")

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

            cms = {"lstm": np.zeros((NCLASS, NCLASS)),
                   "acnn": np.zeros((NCLASS, NCLASS)),
                   "sub": np.zeros((NSUB, NSUB))}
            eloss, esteps = None, 0
            for x, y in batches("eval", args.eval_size, args.batch_size, rng,
                                shuffle=False, device=device, timing=timing):
                loss, bcms = eval_batch(state.model, x, y, compute_dtype)
                for k in cms:
                    cms[k] += bcms[k].cpu().numpy().astype(np.float64)
                eloss = loss if eloss is None else eloss + loss
                esteps += 1

            m_lstm = multiclass_metrics(cms["lstm"], CLASSES)
            m_acnn = multiclass_metrics(cms["acnn"], CLASSES)
            m_sub = multiclass_metrics(cms["sub"], SUBCLASSES)
            rec = {
                "epoch": epoch,
                "train_loss": float(tloss) / max(steps, 1),
                "eval_loss": float(eloss) / max(esteps, 1),
                **{k: round(float(v), 4) for k, v in m_lstm.items()},
                **{f"acnn_{k}": round(float(v), 4) for k, v in m_acnn.items()
                   if k in ("mean_iou", "iou_crop", "iou_grass")},
                "sub_mean_iou": round(m_sub["mean_iou"], 4),
                "secs": round(time.time() - t0, 1),
                **port_timings(steps, args.batch_size, train_secs, timing),
            }
            # track the unrounded monitor apart from the rounded record
            if best is None or m_lstm["mean_iou"] >= best_miou:
                best_miou = float(m_lstm["mean_iou"])
                best = {
                    "epoch": epoch,
                    "mean_iou": round(m_lstm["mean_iou"], 4),
                    "iou_crop": round(m_lstm["iou_crop"], 4),
                    "iou_grass": round(m_lstm["iou_grass"], 4),
                    "acnn_mean_iou": round(m_acnn["mean_iou"], 4),
                    "acnn_iou_crop": round(m_acnn["iou_crop"], 4),
                    "acnn_iou_grass": round(m_acnn["iou_grass"], 4),
                    "sub_mean_iou": round(m_sub["mean_iou"], 4),
                    "accuracy": round(m_lstm["accuracy"], 4),
                }
            print(json.dumps(rec))
            log.write(json.dumps(rec) + "\n")
            log.flush()

        summary = {"final": best, "config": vars(args)}
        print("SUMMARY " + json.dumps(summary))
        log.write(json.dumps(summary) + "\n")
    return summary


if __name__ == "__main__":
    main()
