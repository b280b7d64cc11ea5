"""Multi-state batch inference sweep with calibration + accuracy stats.

The twin of ``examples/multistate_sweep.py`` (the JAX package's BASELINE
config #5): sweep a model across state-sized scenes (DE/MD/PA/NY/VA/WV in
the reference's deployment), with cross-scene histogram calibration
(``cloud.calibration.equalize_collection``, host numpy) and per-state
accuracy statistics (``models.metrics``). Synthetic scenes stand in for the
STAC composites; the compute path is the production one: one chip batch
across the whole stack (``TiledInferenceEngine.predict_scene_batch``),
uint8 out. Runs on the GPU by default; pass ``--device cpu`` for the CPU.

Usage: python -m satellite_computervision_tpu_torch.multistate_sweep [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.cloud.calibration import equalize_collection
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import metrics

STATES = ["DE", "MD", "PA", "NY", "VA", "WV"]
BIASES = [1.0, 1.3, 0.8, 1.1, 0.9, 1.2]  # per-state radiometry drift
K, B, C = 64, 32, 4
H = W = 320


def synth_state(rng, bias, h=H, w=W, c=C):
    """A state scene with its own radiometric bias + ground truth."""
    scene = rng.uniform(0.05, 0.25, (h, w, c)).astype(np.float32) * bias
    truth = np.zeros((h, w), np.int32)
    for _ in range(6):
        y, x = rng.integers(10, h - 30, 2)
        hh, ww = rng.integers(10, 24, 2)
        scene[y : y + hh, x : x + ww] += 0.4 * bias
        truth[y : y + hh, x : x + ww] = 1
    return scene, truth


def state_report(preds, truths):
    """Per-state accuracy, mean IoU and F1 of uint8 (S, H, W, 1)
    predictions thresholded at 127 against (S, H, W) truths."""
    report = {}
    for name, pred, truth in zip(STATES, preds, truths):
        cm = metrics.confusion_matrix(torch.as_tensor(truth),
                                      torch.as_tensor(pred[..., 0] > 127).to(torch.int32), 2)
        report[name] = {k: round(float(v), 4) for k, v in metrics.finalize_metrics(cm).items()}
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    scenes, truths = zip(*(synth_state(rng, b) for b in BIASES))

    # 1. cross-scene calibration: harmonize every state to the first
    #    (utils/calibration.py equalize_collection equivalent)
    calibrated = equalize_collection(list(scenes))

    # 2. a lightweight "trained" model: threshold on mean reflectance
    #    (keeps the example fast; serve a trained checkpoint for real use)
    def predict(chips):
        score = chips.mean(-1, keepdim=True)
        return torch.sigmoid((score - 0.28) * 40.0)

    engine = TiledInferenceEngine(
        predict, kernel=K, buffer=B, batch_size=8, out_channels=1,
        output_transform=lambda p: (p * 255.0).to(torch.uint8), device=device,
    )

    # 3. one chip batch across the whole sweep
    stack = np.stack(calibrated)
    t0 = time.time()
    preds = engine.predict_scene_batch(stack).cpu().numpy()
    dt = time.time() - t0
    mpix = stack.shape[0] * H * W / 1e6

    # 4. per-state accuracy stats
    report = state_report(preds, truths)
    print(json.dumps(report, indent=2))
    print(f"sweep: {len(STATES)} states, {mpix:.1f} MPix in {dt:.2f}s")
    worst = min(report.values(), key=lambda s: s["mean_iou"])
    if not worst["mean_iou"] > 0.7:
        raise RuntimeError(f"a state's mean IoU is 0.7 or less: {report}")
    print("OK")
    return report


if __name__ == "__main__":
    main()
