"""Timeseries next-image forecasting demo in the port, with the ConvLSTM
model.

The twin of ``examples/timeseries_forecast.py`` (the reference's LSTM
workflow: random sequence rotation -> get_lstm_model with a capped ReLU) on
its synthetic seasonal dataset: pixels oscillate through a harmonic plus
noise, and the model learns to forecast the next step from the preceding
five. An ``LSTMModel`` (features 8) trains for ``--steps`` steps (Adam
2e-3, masked MSE) on series whose start is rotated at random
(``data.chip_generators.rearrange_timeseries``) and split into inputs and
the next step (``split_timeseries``); then its forecast MSE on 16 fresh
series must beat the persistence baseline (the last frame again).
``make_series_batch`` is a copy of the JAX script's, drawn from the same
``np.random.default_rng(0)`` stream as the rotations. The model computes in
float32, as the JAX script's does; its train step draws nothing (no
dropout), so the JAX step key has no counterpart.

Usage: python -m satellite_computervision_tpu_torch.timeseries_forecast [--steps N]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.chip_generators import (
    rearrange_timeseries,
    split_timeseries,
)
from satellite_computervision_tpu_torch.models import LSTMModel, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

T, K, C = 6, 16, 3


def make_series_batch(rng, b=8):
    """(B, T, K, K, C) seasonal series: per-pixel phase + harmonic."""
    phase = rng.uniform(0, 2 * np.pi, (b, 1, K, K, 1))
    amp = rng.uniform(0.2, 0.5, (b, 1, K, K, C))
    t = np.arange(T + 1).reshape(1, T + 1, 1, 1, 1)
    series = 0.5 + amp * np.sin(2 * np.pi * t / T + phase)
    series += rng.normal(0, 0.02, series.shape)
    return np.clip(series, 0, 2).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    model = flax_init_(LSTMModel(C, C, features=8), torch.Generator().manual_seed(0)).to(device)
    state = create_train_state(model, 2e-3)
    # LSTMModel returns the activation tensor itself (not a head dict)
    train_step = make_train_step(losses.masked_mse, pred_key="continuous", num_classes=2)
    t0 = time.time()
    first = last = None
    for step_i in range(args.steps):
        series = make_series_batch(rng)
        rotated, _ = rearrange_timeseries(series, rng)
        feats, labels = split_timeseries(rotated, C)
        out = train_step(state, (torch.from_numpy(np.ascontiguousarray(feats)).to(device),
                                 torch.from_numpy(np.ascontiguousarray(labels)).to(device)))
        loss = float(out["loss"])
        first = loss if first is None else first
        last = loss
        if step_i % 40 == 0:
            print(f"step {step_i}: mse={loss:.5f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s; "
          f"mse {first:.4f} -> {last:.4f}")

    # forecast quality vs a persistence baseline (predict last frame again)
    series = make_series_batch(rng, b=16)
    feats, labels = split_timeseries(series, C)
    model.eval()
    with torch.no_grad():
        pred = model(torch.from_numpy(np.ascontiguousarray(feats)).to(device)).cpu().numpy()
    model_mse = float(np.mean((pred - labels) ** 2))
    persist_mse = float(np.mean((feats[:, -1] - labels) ** 2))
    print(f"forecast mse={model_mse:.5f} vs persistence={persist_mse:.5f}")
    if not model_mse < persist_mse:
        raise RuntimeError("model should beat persistence")
    print("OK")
    return {"forecast_mse": model_mse, "persistence_mse": persist_mse}


if __name__ == "__main__":
    main()
