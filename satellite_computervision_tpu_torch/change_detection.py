"""Change-detection demo in the port: a Siamese U-Net + ASPP on
before/after pairs.

The twin of ``examples/change_detection.py`` (the reference's Siamese
story, make_siamese_unet + SiameseDataGenerator) on its synthetic data:
paired Sentinel-2-like 32² chips where "after" adds bright patches that
the model learns to flag. A Siamese U-Net (filters 8/16) trains for
``--steps`` steps (Adam 1e-3, weighted BCE on logits with pos_weight 5),
each batch morphed jointly (pair and label: the generator's contract) by
one flip/rot90 drawn from an explicit ``torch.Generator``; then change
accuracy, mean IoU and F1 over 4 fresh batches, which must reach an
accuracy above 0.8. ``make_batch`` is a copy of the JAX script's, drawn
from the same ``np.random.default_rng(0)`` stream. The model computes in
float32, as the JAX script's does.

Usage: python -m satellite_computervision_tpu_torch.change_detection [--steps N]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.models import SiameseUNet, losses, metrics
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.ops.augment import apply_morph, draw_morph_params
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

K, C = 32, 4


def make_batch(rng, b=8):
    before = rng.uniform(0.05, 0.3, (b, K, K, C)).astype(np.float32)
    after = before + rng.normal(0, 0.01, before.shape).astype(np.float32)
    label = np.zeros((b, K, K, 1), np.float32)
    for i in range(b):
        y, x = rng.integers(2, K - 10, 2)
        h, w = rng.integers(4, 8, 2)
        after[i, y : y + h, x : x + w] += 0.4
        label[i, y : y + h, x : x + w] = 1.0
    return before, after, label


def make_step():
    """``step(state, before, after, label, morph) -> {"loss", "cm"}``: the
    joint morph ``(flip_v, flip_h, n_rot90)`` of the pair and the label,
    then one train step of weighted BCE (pos_weight 5) on the logits."""
    train = make_train_step(
        lambda y, p: losses.weighted_bce(y, p, pos_weight=5.0, logits=True),
        pred_key="logits", num_classes=2)

    def step(state, before, after, label, morph):
        before, after, label = (apply_morph(t, *morph) for t in (before, after, label))
        return train(state, ((before, after), label))

    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = SiameseUNet(C, filters=(8, 16), factors=(2, 2))
    model = flax_init_(model, torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(0)
    make_batch(rng, 1)  # the JAX script draws its init pair here: the same stream follows
    state = create_train_state(model, 1e-3)
    step = make_step()
    gen = torch.Generator().manual_seed(1)

    def on_device(arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    t0 = time.time()
    for i in range(args.steps):
        out = step(state, *on_device(make_batch(rng)), draw_morph_params(gen))
        if i % 20 == 0:
            print(f"step {i}: loss={float(out['loss']):.4f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    # evaluate change IoU
    model.eval()
    cm = metrics.init_metric_state(2, device)
    for _ in range(4):
        before, after, label = on_device(make_batch(rng))
        with torch.no_grad():
            out = model(before, after)
        cm = metrics.update_metric_state(cm, label[..., 0] > 0.5, out["classes"][..., 0])
    final = {k: round(float(v), 4) for k, v in metrics.finalize_metrics(cm).items()}
    print("change-detection eval:", final)
    if not final["accuracy"] > 0.8:
        raise RuntimeError(f"change accuracy should exceed 0.8: {final}")
    print("OK")
    return final


if __name__ == "__main__":
    main()
