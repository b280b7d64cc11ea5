"""Config-driven training CLI for TFRecord workloads (the unet family).

Port of ``scripts/train.py``'s TFRecord path::

  python -m satellite_computervision_tpu_torch.train --config solar \\
      --train 'data/train-*.tfrecord.gz' --eval 'data/eval-*.tfrecord.gz' \\
      --ckpt runs/solar_torch

EE-schema GZIP TFRecords are read and batched (``data.pipeline``), moved
to the device, preprocessed there (``make_preprocess_fn`` with the
config's axes: per-channel ``axes=(0, 1)`` runs the CUDA
``fused_preprocess``, the solar preset's per-pixel ``(2,)`` the plain
ops), and the U-Net trains on the config's loss with Adam, evaluating each
epoch and keeping the best-metric checkpoint in ``<ckpt>/best/model.pt``,
which the ``predict`` CLI serves. On CUDA the forward runs in bfloat16
under autocast (``--no-bf16`` for float32); on the CPU (``--device cpu``)
in float32.

Not ported yet: the npy-chip families, ``--model``, ``--orbax``,
``--torch-weights`` and ``--remat``.
"""

from __future__ import annotations

import argparse
import glob
import sys

import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.pipeline import (
    get_eval_dataset,
    get_training_dataset,
    make_preprocess_fn,
)
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state
from satellite_computervision_tpu_torch.train.zoo import get_family


def _globs(pattern):
    files = sorted(glob.glob(pattern))
    if not files:
        sys.exit(f"no files match {pattern!r}")
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--train", required=True, help="glob of training TFRecords")
    ap.add_argument("--eval", help="glob of eval TFRecords")
    ap.add_argument("--ckpt", default="runs/default", help="checkpoint root")
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--steps-per-epoch", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                    help="bfloat16 forward under autocast on CUDA (float32 parameters)")
    ap.add_argument("--stage-f16", action="store_true",
                    help="stage batches host->device as float16 (half the bytes; "
                    "the preprocess casts back to float32 on the device)")
    ap.add_argument("--s2d", action=argparse.BooleanOptionalAction, default=None,
                    help="space-to-depth stem (default: the config's)")
    ap.add_argument("--bn-momentum", type=float, default=0.9,
                    help="BatchNorm running-stat momentum (Keras convention); "
                    "0.99 needs thousands of steps before eval stabilizes")
    ap.add_argument("--resume", action="store_true",
                    help="restore <ckpt>/best and seed the best metric from an eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CONFIGS[args.config]
    family = get_family(cfg.family)
    batch = args.batch_size or cfg.train_batch or cfg.batch_size
    epochs = args.epochs or cfg.epochs
    lr = args.lr or cfg.learning_rate
    compute_dtype = torch.bfloat16 if args.bf16 and device.type == "cuda" else None

    # ---- model
    kw = {"bn_momentum": args.bn_momentum}
    if args.s2d is not None:
        kw["space_to_depth"] = args.s2d
    model = family.build(cfg, **kw)
    flax_init_(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device, memory_format=torch.channels_last)
    loss_fn, pred_key = family.loss(cfg)
    trainer = Trainer(
        create_train_state(model, lr), loss_fn, pred_key=pred_key,
        num_classes=max(cfg.num_classes, 2), monitor=cfg.monitor,
        mode="min" if cfg.monitor == "loss" else "max",
        checkpoint_manager=CheckpointManager(args.ckpt), compute_dtype=compute_dtype,
    )
    print(f"training {cfg.name} on {device}: batch {batch}, "
          f"{'bf16 autocast' if compute_dtype else 'float32'}, "
          f"space-to-depth {model.space_to_depth}")

    # ---- data
    bands = list(cfg.bands)
    names = bands + [cfg.response]
    train_files = _globs(args.train)
    eval_files = sorted(glob.glob(args.eval)) if args.eval else []
    train_it = get_training_dataset(
        train_files, names, kernel_size=cfg.kernel_size, batch_size=batch,
        shuffle_buffer=min(cfg.shuffle_buffer, 2048), seed=args.seed,
        stage_dtype="float16" if args.stage_f16 else None, device=device)
    preprocess = make_preprocess_fn(
        bands, cfg.response, axes=cfg.axes, splits=cfg.splits,
        response_depth=cfg.num_classes if cfg.num_classes > 1 else None, device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)

    def train_batches():
        for raw in train_it:
            yield preprocess(raw, gen, train=True)

    def eval_iter():
        for raw in get_eval_dataset(eval_files, names, kernel_size=cfg.kernel_size,
                                    batch_size=batch, device=device):
            yield preprocess(raw, train=False)

    steps = args.steps_per_epoch or max(1, len(train_files) * 2)
    eval_fn = eval_iter if eval_files else None

    if args.resume:
        _, meta = trainer.ckpt.restore(trainer.state, "best")
        if eval_fn is not None:
            seeded = trainer.seed_best_from_eval(eval_fn())
            print(f"resumed at step {trainer.state.step}, "
                  f"best {cfg.monitor}={trainer.best:.4f} ({seeded})")

    trainer.fit(train_batches(), epochs=epochs, steps_per_epoch=steps, eval_fn=eval_fn)
    print(f"done; best {cfg.monitor}={trainer.best}")
    return trainer


if __name__ == "__main__":
    main()
