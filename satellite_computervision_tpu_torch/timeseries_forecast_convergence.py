"""ConvLSTM next-image forecast convergence run in the port: quality
evidence for the timeseries family and the masked-MSE loss.

The twin of ``examples/timeseries_forecast_convergence.py``: the
``LSTMModel`` (a ConvLSTM stack, capped ReLU, features 32) trained under
the reference's timeseries config (4 bands, 64² chips, T = 6, batch 16,
Adam 9e-4, masked MSE) on the JAX script's procedural seasonal series: a
per-pixel seasonal harmonic with spatially correlated phase, amplitude and
mean, a random per-chip season offset, and NaN cloud holes in the target
frame. ``make_chip`` is a copy of the JAX script's, so both train on the
same series in the same order.

Per epoch: the forecast MSE, the persistence baseline's MSE (next = last
observed frame, on the same finite-target pixels) and the skill against
it, as JSONL (default ``runs/torch/timeseries_forecast.jsonl``, the JAX
default's name) with a final summary of the best epoch on skill.

On CUDA the forward runs in bfloat16 under autocast over float32
parameters (the JAX model's ``dtype=bfloat16``); the ConvLSTM carry stays
float32. The JAX loop hands each step a fresh ``jax.random`` key; the
port's step takes none: the script builds the model with ``dropout`` None,
so nothing draws from it.

Usage:
  python -m satellite_computervision_tpu_torch.timeseries_forecast_convergence
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
    autocast,
    chip_batches,
    port_timings,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.models import LSTMModel, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

T, K, C = 6, 64, 4  # TIMESERIES_CONFIG: 6 timesteps, 64^2 chips, 4 bands
PERIOD = 12.0  # seasonal period in observation steps (bimonthly S2 revisit)


def make_chip(split: str, index: int):
    """Deterministic ((T-1, K, K, C) float16 inputs, (K, K, C) float32
    next-frame target with NaN cloud holes)."""
    rng = np.random.default_rng(stable_seed(split, index))

    # landscape: per-band mean level, seasonal amplitude and phase vary
    # smoothly in space (patches of vegetation green up together)
    mean = 0.7 + 0.25 * smooth_field(rng, K)[..., None]
    amp = 0.25 + 0.15 * smooth_field(rng, K)[..., None]
    phase = 1.5 * smooth_field(rng, K)[..., None]
    band_scale = rng.uniform(0.7, 1.1, (1, 1, C)).astype(np.float32)

    t0 = rng.uniform(0, PERIOD)  # random season start per chip
    t = (t0 + np.arange(T)).reshape(T, 1, 1, 1)
    series = mean + amp * np.sin(2 * np.pi * t / PERIOD + phase)
    series = series * band_scale
    series = series + rng.normal(0, 0.02, series.shape)
    series = np.clip(series, 0.0, 2.0).astype(np.float32)

    feats = series[: T - 1].astype(np.float16)
    label = series[T - 1]
    # NaN cloud holes in the target (1-3 patches): mse_4d must skip them
    for _ in range(int(rng.integers(1, 4))):
        h, w = (int(v) for v in rng.integers(6, 20, 2))
        y, x = int(rng.integers(0, K - h)), int(rng.integers(0, K - w))
        label[y : y + h, x : x + w] = np.nan
    return feats, label


def build_model(features: int, seed: int):
    model = LSTMModel(C, C, features=features)
    return flax_init_(model, torch.Generator().manual_seed(seed))


def eval_batch(model, x, y, compute_dtype=None):
    """(forecast MSE, persistence MSE) of one batch with the running BN
    statistics, on the same finite-target pixels."""
    model.eval()
    with torch.no_grad(), autocast(x.device, compute_dtype):
        pred = model(x)
    with torch.no_grad():
        return losses.masked_mse(y, pred), losses.masked_mse(y, x[:, -1].float())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-size", type=int, default=1600)
    ap.add_argument("--eval-size", type=int, default=320)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--features", type=int, default=32)
    ap.add_argument("--out", default="runs/torch/timeseries_forecast.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    state = create_train_state(build_model(args.features, args.seed).to(device), args.lr)
    train_step = make_train_step(losses.masked_mse, num_classes=2, compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "a")
    print(f"timeseries forecast convergence: {args.train_size} series x "
          f"{args.epochs} epochs, batch {args.batch_size}, T={T}, device {device}")
    rng = np.random.default_rng(args.seed)
    best = None
    for epoch in range(args.epochs):
        t0 = time.time()
        timing = {"synth_secs": 0.0}
        tloss, steps = None, 0
        for x, y in chip_batches(make_chip, "train", args.train_size, args.batch_size, rng,
                                 device=device, timing=timing):
            outs = train_step(state, (x, y))
            tloss = outs["loss"] if tloss is None else tloss + outs["loss"]
            steps += 1
        train_secs = time.time() - t0

        emse, epers, esteps = None, None, 0
        for x, y in chip_batches(make_chip, "eval", args.eval_size, args.batch_size, rng,
                                 shuffle=False, device=device, timing=timing):
            m, p = eval_batch(state.model, x, y, compute_dtype)
            emse = m if emse is None else emse + m
            epers = p if epers is None else epers + p
            esteps += 1
        mse = float(emse) / max(esteps, 1)
        pers = float(epers) / max(esteps, 1)
        skill = 1.0 - mse / max(pers, 1e-12)
        rec = {
            "epoch": epoch,
            "train_loss": float(tloss) / max(steps, 1),
            "eval_mse": round(mse, 6),
            "persistence_mse": round(pers, 6),
            "skill_vs_persistence": round(skill, 4),
            "secs": round(time.time() - t0, 1),
            **port_timings(steps, args.batch_size, train_secs, timing),
        }
        if best is None or skill >= best["skill_vs_persistence"]:
            best = {"epoch": epoch, "eval_mse": round(mse, 6),
                    "persistence_mse": round(pers, 6),
                    "skill_vs_persistence": round(skill, 4)}
        print(json.dumps(rec))
        log.write(json.dumps(rec) + "\n")
        log.flush()

    summary = {"final": best, "config": vars(args)}
    print("SUMMARY " + json.dumps(summary))
    log.write(json.dumps(summary) + "\n")
    log.close()
    return summary


if __name__ == "__main__":
    main()
