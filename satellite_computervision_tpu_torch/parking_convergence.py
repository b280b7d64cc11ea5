"""Parking-lot convergence in the port under the reference's full
optimization config.

The twin of ``examples/parking_convergence.py``: the parking notebook's
plain U-Net (filters 32…512, BN momentum 0.9, remat) or the README's
DeepLab v3+ on a ResNet-50 (``--model``), trained with weighted BCE
pos_weight 20, Adam 9e-4, batch 16, on the JAX script's procedural 512²
NAIP-like RGB chips: gray asphalt lots with white stall striping, road and
roof confusers that share the "paved gray rectangle" trait.
``_paved_rect`` and ``make_chip`` are copies of the JAX script's, so both
train on the same chips in the same order.

``--torch-weights`` warm-starts the DeepLab backbone from a
torchvision-layout ResNet ``state_dict`` (``models.deeplab.
load_torch_resnet_weights``); ``--export-backbone`` writes the trained
backbone in that layout (``export_torch_resnet_weights``), the pretrain
half of the warm-start rehearsal. Both refuse ``--model unet``. On CUDA
the forward runs in bfloat16 under autocast; on the CPU in float32. JSONL
goes to ``runs/torch/parking_convergence.jsonl`` by default.

Usage:
  python -m satellite_computervision_tpu_torch.parking_convergence \\
      --model deeplab --epochs 1 --export-backbone work/backbone.pth
  python -m satellite_computervision_tpu_torch.parking_convergence \\
      --model deeplab --epochs 5 --torch-weights work/backbone.pth
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
    run_convergence,
    smooth_field,
    stable_seed,
)
from satellite_computervision_tpu_torch.models import DeepLabV3Plus, UNet, losses
from satellite_computervision_tpu_torch.models.deeplab import (
    export_torch_resnet_weights,
    load_torch_resnet_weights,
)
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import (
    create_train_state,
    make_eval_step,
    make_train_step,
)

K = 512  # parking notebook kernel (cell 16)

# mean RGB reflectance (0-1) of the scene materials at NAIP 1 m/px
GRASS = np.array([0.25, 0.35, 0.18], np.float32)
SOIL = np.array([0.45, 0.40, 0.33], np.float32)
ASPHALT = np.array([0.34, 0.34, 0.35], np.float32)
ROOF = np.array([0.55, 0.52, 0.50], np.float32)
STRIPE = np.array([0.85, 0.85, 0.85], np.float32)


def _paved_rect(rng, max_side):
    h = int(rng.integers(30, max_side))
    w = int(rng.integers(40, max_side))
    y = int(rng.integers(2, K - h - 2))
    x = int(rng.integers(2, K - w - 2))
    return y, x, h, w


def make_chip(split: str, index: int):
    """Deterministic (chip (K,K,3) float16, label (K,K,1) uint8)."""
    rng = np.random.default_rng(stable_seed(split, index, stride=2_000_003))

    green = np.clip(0.5 + 0.5 * smooth_field(rng, K, scale=32), 0, 1)[..., None]
    chip = green * GRASS + (1 - green) * SOIL
    label = np.zeros((K, K), np.float32)

    # roads (60%): long thin asphalt strips WITHOUT stall striping
    for _ in range(rng.integers(0, 3)):
        w = int(rng.integers(6, 14))
        pos = int(rng.integers(0, K - w))
        tone = ASPHALT * rng.uniform(0.9, 1.1)
        if rng.random() < 0.5:
            chip[pos : pos + w, :] = tone
        else:
            chip[:, pos : pos + w] = tone

    # building roofs (50%): bright rectangles
    if rng.random() < 0.5:
        y, x, h, w = _paved_rect(rng, 120)
        chip[y : y + h, x : x + w] = ROOF * rng.uniform(0.9, 1.1)

    # parking lots (60%): asphalt rectangles WITH white stall stripes
    if rng.random() < 0.6:
        for _ in range(int(rng.integers(1, 3))):
            y, x, h, w = _paved_rect(rng, 180)
            lot = np.tile(ASPHALT * rng.uniform(0.92, 1.08), (h, w, 1))
            # stall striping: thin bright lines every ~6 px (stalls ~3 m)
            pitch = int(rng.integers(5, 8))
            stripes = (np.arange(w) % pitch == 0)[None, :, None]
            lot = np.where(stripes, STRIPE * rng.uniform(0.9, 1.0), lot)
            # lane gap through the middle
            lane = slice(h // 2 - 3, h // 2 + 3)
            lot[lane] = ASPHALT * rng.uniform(0.92, 1.08)
            chip[y : y + h, x : x + w] = lot
            label[y : y + h, x : x + w] = 1.0

    chip = chip + rng.normal(0, 0.01, chip.shape).astype(np.float32)
    return np.clip(chip, 0, 1).astype(np.float16), label[..., None].astype(np.uint8)


def build_model(name: str, seed: int):
    """The ``--model`` at full width, flax's default init from ``seed``."""
    if name == "deeplab":
        model = DeepLabV3Plus(3, n_classes=1, head="sigmoid")
    else:
        model = UNet(3, n_classes=1, filters=(32, 64, 128, 256, 512), factors=(2,) * 5,
                     head="sigmoid", bn_momentum=0.9, remat=True)
    return flax_init_(model, torch.Generator().manual_seed(seed))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", choices=["unet", "deeplab"], default="unet")
    ap.add_argument("--train-size", type=int, default=800)
    ap.add_argument("--eval-size", type=int, default=160)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=9e-4)
    ap.add_argument("--pos-weight", type=float, default=20.0)  # parking nb cell 39
    ap.add_argument("--out", default="runs/torch/parking_convergence.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--torch-weights",
                    help="deeplab only: warm-start the ResNet backbone from "
                    "a torchvision-layout state_dict .pth (the production "
                    "path is the train CLI's --torch-weights; this flag makes "
                    "the warm-vs-cold comparison reproducible in one harness)")
    ap.add_argument("--export-backbone",
                    help="deeplab only: after training, write the backbone "
                    "as a torchvision-layout .pth (models.deeplab."
                    "export_torch_resnet_weights) — the pretrain half of "
                    "the warm-start rehearsal")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else None

    model = build_model(args.model, args.seed)
    if args.torch_weights or args.export_backbone:
        if args.model != "deeplab":
            raise SystemExit("--torch-weights/--export-backbone apply to "
                             "--model deeplab (the ResNet backbone)")
    if args.torch_weights:
        load_torch_resnet_weights(model, args.torch_weights)
        print(f"warm-started ResNet backbone from {args.torch_weights}")
    model = model.to(device)
    state = create_train_state(model, args.lr)
    loss_fn = lambda y, p: losses.weighted_bce(y, p, pos_weight=args.pos_weight, logits=True)  # noqa: E731
    train_step = make_train_step(loss_fn, pred_key="logits", num_classes=2,
                                 compute_dtype=compute_dtype)
    eval_step = make_eval_step(loss_fn, pred_key="logits", num_classes=2,
                               compute_dtype=compute_dtype)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    log = open(args.out, "a")

    print(f"parking convergence ({args.model}): {args.train_size} chips x "
          f"{args.epochs} epochs, batch {args.batch_size}, pos_weight {args.pos_weight}, "
          f"device {device}")
    state, best = run_convergence(
        state, train_step, eval_step, make_chip, args, log,
        extra_record={"model": args.model,
                      "warm_start": bool(args.torch_weights)},
    )

    if args.export_backbone:
        export_torch_resnet_weights(state.model, args.export_backbone)
        print(f"exported backbone state_dict to {args.export_backbone}")

    summary = {"final": {k: round(float(v), 4) for k, v in best.items()},
               "config": vars(args)}
    print("SUMMARY " + json.dumps(summary))
    log.write(json.dumps(summary) + "\n")
    log.close()
    return summary


if __name__ == "__main__":
    main()
