"""Multiclass land-cover demo in the port: a multiclass U-Net trained with
the generalized dice loss.

The twin of ``examples/landcover_multiclass.py`` (the reference's
land-cover story: multiclass get_unet_model + gen_dice, one-hot labels) on
its synthetic 4-class chips: 32² blocks of 8² class cells with per-class
5-band signatures plus noise. A U-Net (filters 8/16, softmax head) trains
for ``--steps`` steps through the ``Trainer`` (Adam 2e-3, gen_dice on the
probabilities); then the per-class confusion report over 4 fresh batches
(``train.evaluate``), whose mean IoU must exceed 0.6. ``signatures`` and
``make_batch`` are copies of the JAX script's numpy code, drawn from the
same ``np.random.default_rng`` streams. The model computes in float32, as
the JAX script's does; its train step draws nothing (no dropout), so the
JAX step key has no counterpart.

Usage: python -m satellite_computervision_tpu_torch.landcover_multiclass [--steps N]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.models import UNet, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.evaluate import (
    evaluate_confusion,
    format_confusion_report,
)
from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state

K, C, NCLASS = 32, 5, 4
CLASSES = ["water", "forest", "field", "built"]


def signatures() -> np.ndarray:
    """(NCLASS, C) per-class band signatures."""
    sig_rng = np.random.default_rng(42)
    return sig_rng.random((NCLASS, C)).astype(np.float32)


def make_batch(rng, sigs, b=8):
    """(B, K, K, C) float32 features and (B, K, K, NCLASS) one-hot labels
    of 8² class cells."""
    labels = rng.integers(0, NCLASS, (b, K, K))
    for i in range(b):
        labels[i] = labels[i, ::8, ::8].repeat(8, 0).repeat(8, 1)
    x = sigs[labels] + rng.normal(0, 0.05, (b, K, K, C)).astype(np.float32)
    return x.astype(np.float32), np.eye(NCLASS, dtype=np.float32)[labels]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    sigs = signatures()

    def batch():
        return tuple(torch.from_numpy(a).to(device) for a in make_batch(rng, sigs))

    model = UNet(C, n_classes=NCLASS, filters=(8, 16), factors=(2, 2), head="softmax")
    model = flax_init_(model, torch.Generator().manual_seed(0)).to(device)
    trainer = Trainer(create_train_state(model, 2e-3), lambda y, p: losses.gen_dice(y, p),
                      pred_key="probs", num_classes=NCLASS)
    t0 = time.time()
    for step in range(args.steps):
        out = trainer.train_step(trainer.state, batch())
        if step % 20 == 0:
            print(f"step {step}: dice loss={float(out['loss']):.4f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    model.eval()

    def predict(x):
        with torch.no_grad():
            return model(x)["classes"]

    report = evaluate_confusion(predict, [batch() for _ in range(4)], NCLASS,
                                class_names=CLASSES)
    print(format_confusion_report(report))
    if not report["overall"]["mean_iou"] > 0.6:
        raise RuntimeError(f"mean IoU should exceed 0.6: {report['overall']}")
    print("OK")
    return report


if __name__ == "__main__":
    main()
