"""Config-driven training CLI: TFRecord workloads (the unet and deeplab
families) and npy-chip change detection (the siamese family).

Port of ``scripts/train.py``::

  python -m satellite_computervision_tpu_torch.train --config solar \\
      --train 'data/train-*.tfrecord.gz' --eval 'data/eval-*.tfrecord.gz' \\
      --ckpt runs/solar_torch
  python -m satellite_computervision_tpu_torch.train --config parking \\
      --model deeplab --train 'naip/train-*.tfrecord.gz' \\
      --eval 'naip/eval-*.tfrecord.gz' --torch-weights resnet50.pth \\
      --ckpt runs/parking
  python -m satellite_computervision_tpu_torch.train --config change \\
      --before 'chips/before/*.npy' --after 'chips/after/*.npy' \\
      --labels 'chips/label/*.npy' --ckpt runs/change

EE-schema GZIP TFRecords are read and batched (``data.pipeline``), moved
to the device, preprocessed there (``make_preprocess_fn`` with the
config's axes: per-channel ``axes=(0, 1)`` runs the CUDA
``fused_preprocess``, the solar and parking presets' per-pixel ``(2,)`` the
plain ops), and the model trains on the config's loss with Adam,
evaluating each epoch and keeping the best-metric checkpoint in
``<ckpt>/best/model.pt``, which the ``predict`` CLI serves. ``--model
deeplab`` trains DeepLab v3+ on a ResNet-50; ``--torch-weights`` warm-starts
its backbone from a local torchvision-layout ResNet ``state_dict``
(``models.deeplab.load_torch_resnet_weights``: convs and BatchNorm
statistics) and exits for any other family. The siamese family reads
before/after/label ``.npy`` chips through
``data.chip_generators.SiameseChipDataset`` (centre-trimmed to the
config's training tile, colour and flip/rot90 augmented on the host),
trains on train metrics (no eval stream), one epoch being the dataset's
length unless ``--steps-per-epoch`` says otherwise, and keeps a
``model.pt`` with ``arch`` ``siamese``, which ``predict change`` serves.
``--bn-momentum`` and ``--s2d`` apply to the unet family only (the Siamese
and DeepLab models keep their own momenta). On CUDA the forward runs in
bfloat16 under autocast (``--no-bf16`` for float32); on the CPU
(``--device cpu``) in float32.

Not ported yet: the other npy-chip families (``convlstm``,
``lstm_autoencoder``, ``hybrid``, ``hierarchical``), ``acnn``, ``--orbax``
and ``--remat``.
"""

from __future__ import annotations

import argparse
import glob
import sys

import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.chip_generators import SiameseChipDataset
from satellite_computervision_tpu_torch.data.pipeline import (
    get_eval_dataset,
    get_training_dataset,
    make_preprocess_fn,
)
from satellite_computervision_tpu_torch.models.deeplab import load_torch_resnet_weights
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager, build_empty
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state
from satellite_computervision_tpu_torch.train.zoo import FAMILIES

# the JAX CLI's families; those missing from the port's zoo exit
TFRECORD_FAMILIES = ("unet", "deeplab", "acnn")
NPY_FAMILIES = ("siamese", "convlstm", "lstm_autoencoder", "hybrid", "hierarchical")


def _globs(pattern):
    files = sorted(glob.glob(pattern))
    if not files:
        sys.exit(f"no files match {pattern!r}")
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--model", choices=TFRECORD_FAMILIES + NPY_FAMILIES, default=None,
                    help="model family (default: the config's)")
    ap.add_argument("--train", help="glob of training TFRecords (unet, deeplab)")
    ap.add_argument("--eval", help="glob of eval TFRecords")
    ap.add_argument("--before", help="siamese: glob of before-chip npys")
    ap.add_argument("--after", help="siamese: glob of after-chip npys")
    ap.add_argument("--labels", help="siamese: glob of label npys")
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
                    help="unet: space-to-depth stem (default: the config's)")
    ap.add_argument("--bn-momentum", type=float, default=0.9,
                    help="unet: BatchNorm running-stat momentum (Keras convention); "
                    "0.99 needs thousands of steps before eval stabilizes")
    ap.add_argument("--torch-weights",
                    help="deeplab: warm-start the ResNet backbone from a local torchvision "
                    "state_dict .pth (convs and BatchNorm running statistics)")
    ap.add_argument("--resume", action="store_true",
                    help="restore <ckpt>/best and seed the best metric from an eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = CONFIGS[args.config]
    args.model = args.model or cfg.family
    if args.model not in FAMILIES:
        sys.exit(f"--model {args.model} is not ported yet")
    family = FAMILIES[args.model]
    if args.torch_weights and args.model != "deeplab":
        sys.exit("--torch-weights applies to --model deeplab (the torchvision ResNet backbone)")
    if args.model in TFRECORD_FAMILIES and not args.train:
        sys.exit(f"--train tfrecord glob is required for {args.model}")
    if args.model == "siamese" and not (args.before and args.after and args.labels):
        sys.exit("siamese needs --before/--after/--labels npy globs")
    device = resolve_device(args.device)
    batch = args.batch_size or cfg.train_batch or cfg.batch_size
    epochs = args.epochs or cfg.epochs
    lr = args.lr or cfg.learning_rate
    compute_dtype = torch.bfloat16 if args.bf16 and device.type == "cuda" else None

    # ---- model
    kw = {}
    if args.model == "unet":
        kw["bn_momentum"] = args.bn_momentum
        if args.s2d is not None:
            kw["space_to_depth"] = args.s2d
    # built on the meta device and allocated once: flax_init_ draws every
    # weight and statistic from the seed (a ResNet-50 DeepLab's 40 M draws
    # take seconds on the host; drawing them twice, once in the
    # constructor, doubled that)
    model = build_empty(family.build, cfg, **kw).to_empty(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(args.seed))
    if args.torch_weights:
        loaded = load_torch_resnet_weights(model, args.torch_weights)
        print(f"warm-started ResNet backbone from {args.torch_weights} "
              f"({len(loaded)} tensors)")
    model = model.to(device, memory_format=torch.channels_last)
    loss_fn, pred_key = family.loss(cfg)
    trainer = Trainer(
        create_train_state(model, lr), loss_fn, pred_key=pred_key,
        num_classes=max(cfg.num_classes, 2), monitor=cfg.monitor,
        mode="min" if cfg.monitor == "loss" else "max",
        checkpoint_manager=CheckpointManager(args.ckpt), compute_dtype=compute_dtype,
    )
    print(f"training {cfg.name} ({args.model}) on {device}: batch {batch}, "
          f"{'bf16 autocast' if compute_dtype else 'float32'}, "
          f"space-to-depth {getattr(model, 'space_to_depth', False)}")

    # ---- data
    if args.model == "siamese":
        train_batches, steps, eval_fn = _siamese_data(args, cfg, batch, device)
    else:
        train_batches, steps, eval_fn = _tfrecord_data(args, cfg, batch, device)

    if args.resume:
        _, meta = trainer.ckpt.restore(trainer.state, "best")
        if eval_fn is not None:
            seeded = trainer.seed_best_from_eval(eval_fn())
            print(f"resumed at step {trainer.state.step}, "
                  f"best {cfg.monitor}={trainer.best:.4f} ({seeded})")

    trainer.fit(train_batches(), epochs=epochs, steps_per_epoch=steps, eval_fn=eval_fn)
    print(f"done; best {cfg.monitor}={trainer.best}")
    return trainer


def _siamese_data(args, cfg, batch, device):
    """(train_batches, steps per epoch, eval_fn) of before/after/label npy
    chips: batches of ``([before, after], labels)`` on ``device``, the
    dataset cycled; no eval stream."""
    # generator-fed training crops chips at the config's training tile
    tile, _ = cfg.training_geometry
    ds = SiameseChipDataset(_globs(args.before), _globs(args.after), _globs(args.labels),
                            batch_size=batch, unet_dim=(tile, tile), seed=args.seed)
    if len(ds) == 0:
        sys.exit("not enough chips for one batch")

    def to_device(a):
        return torch.from_numpy(a).to(device)

    def train_batches():
        while True:
            for x, y in ds:
                yield [to_device(a) for a in x], to_device(y)

    return train_batches, args.steps_per_epoch or len(ds), None


def _tfrecord_data(args, cfg, batch, device):
    """(train_batches, steps per epoch, eval_fn) of EE-schema TFRecords,
    preprocessed on ``device``."""
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
    return train_batches, steps, eval_iter if eval_files else None


if __name__ == "__main__":
    main()
