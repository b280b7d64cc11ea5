"""ConvLSTM-autoencoder convergence run in the port: quality evidence for
the LSTM-AE family's two-headed training objective.

The twin of ``examples/lstm_ae_convergence.py``: the full two-head
``LSTMAutoencoder`` (``temporal`` reconstructs the time-reversed input
through a repeated-state ConvLSTM decoder; ``single`` predicts the next
frame from the encoded state and the target time's sin/cos plane) trained
under the reference objective (summed masked MSE of both heads, Adam 9e-4)
on the JAX script's procedural seasonal series: a per-pixel seasonal
harmonic with spatially correlated phase and amplitude, a random per-chip
season offset, NaN cloud holes in the next-frame target. ``make_chip`` and
``batches`` are copies of the JAX script's numpy code, so both train on
the same series in the same order.

Per epoch: the ``single`` head's forecast MSE, the ``temporal`` head's
reconstruction MSE, the persistence baseline's MSE (next = last observed
frame) and the skill against it, as JSONL (default
``runs/torch/lstm_ae_convergence.jsonl``) with a final summary of the best
epoch on skill.

On CUDA the forward runs in bfloat16 under autocast over float32
parameters (the JAX model's ``dtype=bfloat16``); the ConvLSTM carry stays
float32. The JAX loop hands each step a fresh ``jax.random`` key; the
port's step takes none, and ``LSTMAutoencoder`` has no dropout to draw.

Usage:
  python -m satellite_computervision_tpu_torch.lstm_ae_convergence
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
from satellite_computervision_tpu_torch.models import LSTMAutoencoder, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

T, K, C = 6, 64, 4  # 6-step series, 64^2 chips, 4 bands (TIMESERIES_CONFIG)
T_IN = T - 1  # 5 observed frames in, frame 6 out
PERIOD = 12.0


def make_chip(split: str, index: int):
    """Deterministic ((T_IN,K,K,C) f16 inputs, (K,K,2) f32 target-time
    sin/cos, (T_IN,K,K,C) f32 reversed-sequence target, (K,K,C) f32
    next-frame target with NaN cloud holes)."""
    rng = np.random.default_rng(stable_seed(split, index))
    mean = 0.7 + 0.25 * smooth_field(rng, K)[..., None]
    amp = 0.25 + 0.15 * smooth_field(rng, K)[..., None]
    phase = 1.5 * smooth_field(rng, K)[..., None]
    band_scale = rng.uniform(0.7, 1.1, (1, 1, C)).astype(np.float32)
    t0 = rng.uniform(0, PERIOD)
    t = (t0 + np.arange(T)).reshape(T, 1, 1, 1)
    series = mean + amp * np.sin(2 * np.pi * t / PERIOD + phase)
    series = series * band_scale
    series = series + rng.normal(0, 0.02, series.shape)
    series = np.clip(series, 0.0, 2.0).astype(np.float32)

    feats = series[:T_IN].astype(np.float16)
    temporal_y = series[:T_IN][::-1].copy()  # the reversed inputs
    single_y = series[T_IN].copy()
    for _ in range(int(rng.integers(1, 4))):
        h, w = (int(v) for v in rng.integers(6, 20, 2))
        y, x = int(rng.integers(0, K - h)), int(rng.integers(0, K - w))
        single_y[y : y + h, x : x + w] = np.nan
    # the reference reads this off the chip filename's start month; here
    # the generator knows the true target time
    theta = 2 * np.pi * (t0 + T_IN) / PERIOD
    sincos = np.broadcast_to(
        np.array([np.sin(theta), np.cos(theta)], np.float32), (K, K, 2)
    ).copy()
    return feats, sincos, temporal_y, single_y


def batches(split, n, batch, rng, shuffle=True, device="cuda", timing=None):
    """``((feats, sincos), (temporal_y, single_y))`` device batches in the
    JAX script's order."""
    for x, sc, ty, sy in chip_batches(make_chip, split, n, batch, rng, shuffle=shuffle,
                                      device=device, timing=timing):
        yield (x, sc), (ty, sy)


def build_model(features: int, seed: int):
    model = LSTMAutoencoder(C, n_classes=C, n_time=T_IN, features=features)
    return flax_init_(model, torch.Generator().manual_seed(seed))


def _frames(seq):
    """(B, T, H, W, C) -> (B*T, H, W, C)."""
    return seq.reshape((-1,) + tuple(seq.shape[2:]))


def loss_fn(y, out):
    """The summed masked MSE of both heads (the zoo's LSTM-AE loss)."""
    temporal_y, single_y = y
    return losses.mse_4d(single_y, out["single"]) + losses.mse_4d(
        _frames(temporal_y), _frames(out["temporal"]))


def eval_batch(model, x, y, compute_dtype=None):
    """(forecast MSE, reconstruction MSE, persistence MSE) of one batch with
    the running BN statistics."""
    model.eval()
    with torch.no_grad(), autocast(x[0].device, compute_dtype):
        out = model(*x)
    with torch.no_grad():
        temporal_y, single_y = y
        return (losses.mse_4d(single_y, out["single"]),
                losses.mse_4d(_frames(temporal_y), _frames(out["temporal"])),
                losses.mse_4d(single_y, x[0][:, -1].float()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train-size", type=int, default=1280)
    ap.add_argument("--eval-size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--out", default="runs/torch/lstm_ae_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    state = create_train_state(build_model(args.features, args.seed).to(device), args.lr)
    train_step = make_train_step(loss_fn, pred_key=None, num_classes=2,
                                 compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as log:
        print(f"lstm-ae convergence: {args.train_size} series x {args.epochs} "
              f"epochs, batch {args.batch_size}, T_in={T_IN}, device {device}")

        rng = np.random.default_rng(args.seed)
        best = None
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

            sums, esteps = None, 0
            for x, y in batches("eval", args.eval_size, args.batch_size, rng,
                                shuffle=False, device=device, timing=timing):
                vals = eval_batch(state.model, x, y, compute_dtype)
                sums = vals if sums is None else tuple(a + b for a, b in zip(sums, vals))
                esteps += 1
            single_mse, temporal_mse, pers_mse = (float(v) / max(esteps, 1) for v in sums)
            skill = 1.0 - single_mse / max(pers_mse, 1e-12)
            rec = {
                "epoch": epoch,
                "train_loss": float(tloss) / max(steps, 1),
                "forecast_mse": round(single_mse, 6),
                "reconstruction_mse": round(temporal_mse, 6),
                "persistence_mse": round(pers_mse, 6),
                "skill_vs_persistence": round(skill, 4),
                "secs": round(time.time() - t0, 1),
                **port_timings(steps, args.batch_size, train_secs, timing),
            }
            if best is None or skill >= best["skill_vs_persistence"]:
                best = {k: rec[k] for k in
                        ("epoch", "forecast_mse", "reconstruction_mse",
                         "persistence_mse", "skill_vs_persistence")}
            print(json.dumps(rec))
            log.write(json.dumps(rec) + "\n")
            log.flush()

        summary = {"final": best, "config": vars(args)}
        print("SUMMARY " + json.dumps(summary))
        log.write(json.dumps(summary) + "\n")
    return summary


if __name__ == "__main__":
    main()
