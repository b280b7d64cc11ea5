"""Config-driven training CLI over the model zoo: TFRecord workloads (the
unet, deeplab, acnn, prithvi and satlas families) and npy-chip workloads
(siamese, convlstm, lstm_autoencoder, hybrid, hierarchical).

Port of ``scripts/train.py``::

  python -m satellite_computervision_tpu_torch.train --config solar \\
      --train 'data/train-*.tfrecord.gz' --eval 'data/eval-*.tfrecord.gz' \\
      --ckpt runs/solar_torch
  python -m satellite_computervision_tpu_torch.train --config parking \\
      --model deeplab --train 'naip/train-*.tfrecord.gz' \\
      --eval 'naip/eval-*.tfrecord.gz' --torch-weights resnet50.pth \\
      --ckpt runs/parking
  python -m satellite_computervision_tpu_torch.train --config landcover \\
      --model acnn --train 'lc/train-*.tfrecord.gz' --ckpt runs/acnn
  python -m satellite_computervision_tpu_torch.train --config change \\
      --before 'chips/before/*.npy' --after 'chips/after/*.npy' \\
      --labels 'chips/label/*.npy' --ckpt runs/change
  python -m satellite_computervision_tpu_torch.train --config timeseries \\
      --model convlstm --series 'chips/s2_series/*.npy' --ckpt runs/lstm
  python -m satellite_computervision_tpu_torch.train --config landcover \\
      --model hierarchical --unet-source naip='chips/naip/*.npy' \\
      --series 'chips/s2_series/*.npy' --labels 'chips/label/*.npy' \\
      --ckpt runs/landcover

EE-schema GZIP TFRecords are read and batched (``data.pipeline``), moved
to the device, preprocessed there (``make_preprocess_fn`` with the
config's axes: per-channel ``axes=(0, 1)`` runs the CUDA
``fused_preprocess``, the presets' per-pixel ``(2,)`` the plain ops), and
the model trains on the config's loss with Adam, evaluating each epoch
and keeping the best-metric checkpoint in ``<ckpt>/best/model.pt``, which
the ``predict`` and ``evaluate`` CLIs serve. ``--model deeplab`` trains
DeepLab v3+ on a ResNet-50; ``--torch-weights`` warm-starts its backbone
from a local torchvision-layout ResNet ``state_dict``
(``models.deeplab.load_torch_resnet_weights``) and exits for any other
family.

The npy-chip families read ``.npy`` chips through
``data.chip_generators`` on the host and train on train metrics (no eval
stream), one epoch being the dataset's length unless
``--steps-per-epoch`` says otherwise:

- ``siamese``: before/after/label chips (``SiameseChipDataset``,
  centre-trimmed to the config's training tile);
- ``convlstm`` / ``lstm_autoencoder``: ``--series`` (T, C, H, W) chips
  trimmed to ``--series-dim`` (``LSTMChipDataset`` /
  ``LSTMAutoencoderChipDataset``; the autoencoder's start month is the
  third ``_``-part of each file stem, and its sample weights are dropped);
- ``hybrid`` / ``hierarchical``: ``--unet-source name=glob`` (repeatable;
  the name picks the divisor, NaN mask and colour augmentation),
  ``--series`` (S2) and optionally ``--series-s1`` (divided by -50), and
  ``--labels`` (``HybridChipDataset``); the hierarchical model's
  auxiliary head trains on classes merged pairwise (``class // 2``) and
  needs ``num_classes >= 4``.

The model is first run on the family's example inputs on the meta device,
as the JAX CLI's ``init`` runs them: a model that cannot take its
preset's shapes (the hybrid at the landcover and wetland presets' 256²)
fails there, before any data is read. ``--bn-momentum``, ``--s2d`` and
``--remat`` (activation checkpointing per U-Net block) apply to the unet
family only. On CUDA the forward runs in bfloat16 under autocast
(``--no-bf16`` for float32); on the CPU (``--device cpu``) in float32.
``--orbax`` keeps the flag name of the JAX CLI; here it writes the
checkpoints in the ``torch.distributed.checkpoint`` format
(``CheckpointManager(backend="dcp")``: ``<ckpt>/best/`` holds the sharded
model and optimizer state and ``scv_meta.json``, no ``model.pt``, so the
``predict`` CLI does not serve it).
"""

from __future__ import annotations

import argparse
import glob
import sys

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.chip_generators import (
    ChipSource,
    HybridChipDataset,
    LSTMAutoencoderChipDataset,
    LSTMChipDataset,
    SiameseChipDataset,
)
from satellite_computervision_tpu_torch.data.pipeline import (
    get_eval_dataset,
    get_training_dataset,
    make_preprocess_fn,
)
from satellite_computervision_tpu_torch.models.deeplab import load_torch_resnet_weights
from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager, build_empty
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state
from satellite_computervision_tpu_torch.train.zoo import FAMILIES

TFRECORD_FAMILIES = ("unet", "deeplab", "acnn", "prithvi", "satlas")
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
    ap.add_argument("--train", help="glob of training TFRecords (tfrecord families)")
    ap.add_argument("--eval", help="glob of eval TFRecords")
    # npy-chip family inputs
    ap.add_argument("--before", help="siamese: glob of before-chip npys")
    ap.add_argument("--after", help="siamese: glob of after-chip npys")
    ap.add_argument("--labels", help="siamese/hybrid/hierarchical: glob of label npys")
    ap.add_argument("--series",
                    help="convlstm/lstm_autoencoder/hybrid/hierarchical: glob of (T,C,H,W) npys")
    ap.add_argument("--series-s1", help="hybrid/hierarchical: optional S1 series glob "
                    "(divisor -50)")
    ap.add_argument("--series-dim", type=int, default=32,
                    help="spatial side of timeseries chips")
    ap.add_argument("--unet-source", action="append",
                    help="hybrid/hierarchical: repeatable name=glob of unet-input chips")
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
    ap.add_argument("--remat", action="store_true",
                    help="unet: recompute each block's activations in backward "
                    "(torch.utils.checkpoint) to train larger batches or chips")
    ap.add_argument("--orbax", action="store_true",
                    help="checkpoint in the torch.distributed.checkpoint format "
                    "(sharded-state capable) instead of model.pt; the JAX CLI's flag name")
    ap.add_argument("--resume", action="store_true",
                    help="restore <ckpt>/best and seed the best metric from an eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = CONFIGS[args.config]
    args.model = args.model or cfg.family
    family = FAMILIES[args.model]
    if args.torch_weights and args.model != "deeplab":
        sys.exit("--torch-weights applies to --model deeplab (the torchvision ResNet backbone)")
    if args.model in TFRECORD_FAMILIES and not args.train:
        sys.exit(f"--train tfrecord glob is required for {args.model}")
    _check_npy_flags(args, cfg)
    device = resolve_device(args.device)
    batch = args.batch_size or cfg.train_batch or cfg.batch_size
    epochs = args.epochs or cfg.epochs
    lr = args.lr or cfg.learning_rate
    compute_dtype = torch.bfloat16 if args.bf16 and device.type == "cuda" else None

    # ---- model
    kw = {}
    if args.model == "unet":
        kw.update(bn_momentum=args.bn_momentum, remat=args.remat)
        if args.s2d is not None:
            kw["space_to_depth"] = args.s2d
    # built on the meta device and allocated once: the family's init draws
    # every weight and statistic from the seed (a ResNet-50 DeepLab's 40 M
    # draws take seconds on the host; drawing them twice, once in the
    # constructor, doubled that)
    model = build_empty(family.build, cfg, **kw)
    # the example inputs through the meta model, as the JAX CLI's init runs
    # them: a model that cannot take its preset's shapes fails here
    with torch.no_grad():
        model.eval()(*(torch.from_numpy(a).to("meta") for a in family.example_inputs(cfg)))
    model = model.to_empty(device="cpu")
    family.init(model, torch.Generator().manual_seed(args.seed))
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
        checkpoint_manager=CheckpointManager(args.ckpt, backend="dcp" if args.orbax else "pt"),
        compute_dtype=compute_dtype,
    )
    print(f"training {cfg.name} ({args.model}) on {device}: batch {batch}, "
          f"{'bf16 autocast' if compute_dtype else 'float32'}, "
          f"space-to-depth {getattr(model, 'space_to_depth', False)}, "
          f"remat {getattr(model, 'remat', False)}")

    # ---- data
    if args.model in NPY_FAMILIES:
        train_batches, steps, eval_fn = _npy_data(args, cfg, batch, device)
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


def _check_npy_flags(args, cfg):
    """Exit before any work when an npy family lacks its globs."""
    if args.model == "siamese" and not (args.before and args.after and args.labels):
        sys.exit("siamese needs --before/--after/--labels npy globs")
    if args.model in ("convlstm", "lstm_autoencoder") and not args.series:
        sys.exit(f"{args.model} needs --series npy glob of (T, C, H, W) chips")
    if args.model in ("hybrid", "hierarchical"):
        if not (args.unet_source and args.series and args.labels):
            sys.exit(f"{args.model} needs --unet-source name=glob, --series and --labels")
        for spec in args.unet_source:
            if not spec.partition("=")[2]:
                sys.exit(f"--unet-source wants name=glob, got {spec!r}")
    if args.model == "hierarchical" and cfg.num_classes < 4:
        # with num_classes <= 3 the pairwise merge maps every class to
        # sub-class 0: the auxiliary head would train on a constant label
        sys.exit("--model hierarchical needs num_classes >= 4 (the auxiliary head trains "
                 "on pairwise-merged classes; use --config landcover or another "
                 "multi-class config)")


def _npy_dataset(args, cfg, batch):
    """The family's chip dataset from the CLI's globs."""
    # generator-fed training crops chips at the config's training tile
    tile, _ = cfg.training_geometry
    k = (tile, tile)
    if args.model == "siamese":
        return SiameseChipDataset(_globs(args.before), _globs(args.after), _globs(args.labels),
                                  batch_size=batch, unet_dim=k, seed=args.seed)
    if args.model in ("convlstm", "lstm_autoencoder"):
        cls = LSTMChipDataset if args.model == "convlstm" else LSTMAutoencoderChipDataset
        return cls(_globs(args.series), batch_size=batch,
                   dim=(args.series_dim, args.series_dim), n_channels=len(cfg.bands),
                   n_timesteps=cfg.n_time, seed=args.seed)
    sources = {}
    for spec in args.unet_source:
        name, _, pattern = spec.partition("=")
        sources[name] = ChipSource.named(name, _globs(pattern))
    return HybridChipDataset(
        sources=sources, s2_series_files=_globs(args.series),
        s1_series_files=_globs(args.series_s1) if args.series_s1 else None,
        lstm_dim=(cfg.n_time, args.series_dim, args.series_dim, len(cfg.bands)),
        label_files=_globs(args.labels), batch_size=batch, unet_dim=k,
        n_classes=cfg.num_classes, seed=args.seed)


def _to_device(item, device):
    """numpy arrays, and lists or tuples of them, as tensors on ``device``."""
    if isinstance(item, (list, tuple)):
        return type(item)(_to_device(a, device) for a in item)
    return torch.from_numpy(np.ascontiguousarray(item)).to(device)


def _npy_data(args, cfg, batch, device):
    """(train_batches, steps per epoch, eval_fn) of the npy-chip families:
    the dataset's ``(x, y)`` items on ``device``, cycled; no eval stream."""
    ds = _npy_dataset(args, cfg, batch)
    if len(ds) == 0:
        sys.exit("not enough chips for one batch")
    wrap = None
    if args.model == "hierarchical":
        # the mid-depth auxiliary head trains on coarsened classes: adjacent
        # classes merged pairwise (sub = class // 2)
        sub = max(2, cfg.num_classes // 2)
        eye = np.eye(sub, dtype=np.float32)

        def wrap(x, y):
            return x, (y, eye[np.minimum(np.argmax(y, -1) // 2, sub - 1)])

    def train_batches():
        while True:
            for item in ds:
                # the LSTM autoencoder yields (x, y, weights); the step takes (x, y)
                x, y = item[:2]
                if wrap is not None:
                    x, y = wrap(x, y)
                yield _to_device(x, device), _to_device(y, device)

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
