"""Standalone evaluation: checkpoint + eval TFRecords -> confusion report.

Port of ``scripts/evaluate.py``'s ``--ckpt`` mode::

  python -m satellite_computervision_tpu_torch.evaluate --config parking \\
      --model deeplab --ckpt runs/parking --eval 'naip/eval-*.tfrecord.gz' \\
      [--out report.json]

Eval chips (EE-schema GZIP TFRecords) go through the config's preprocess
without augmentation and the model's ``classes`` head, on the device; the
confusion matrix accumulates there (``train.evaluate``). The report —
counts, row-normalized rates, per-class precision/recall/IoU/F1 and the
overall accuracy/mean IoU/F1 — is printed as JSON, as the JAX CLI prints
it. ``--ckpt`` holds ``best/model.pt`` (the port's format) or
``best/state.msgpack`` (the JAX package's). On CUDA the model serves in
bfloat16, as the JAX CLI serves it; on the CPU (``--device cpu``) in
float32.

``--model`` takes the single-input TFRecord families: ``unet``, ``deeplab``
and ``acnn`` (the ACNN of the landcover preset, 8 one-hot classes).

Published-weights mode (``--h5``): score a reference-trained Keras U-Net
directly against eval chips::

  python -m satellite_computervision_tpu_torch.evaluate --h5 solar_unet.h5 \
      --config solar --eval 'chips/eval-*.tfrecord' [--out report.json]

The U-Net's bands, filters, convs_per_block and classes are inferred from
the ``.h5`` kernel shapes (``train.keras_import.infer_unet_arch``; where
the bands differ from the config's, a note is printed and the file wins),
the weights are loaded into a ``UNet`` built on the meta device, BN is
folded unless ``--no-fold``, and the same report follows. ``--h5`` takes
a local path or a URL (``https://``, ``file://``); ``--family`` is
``unet``, the one family this mode serves (the others import through
``compat.get_blob_model``).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys

import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.pipeline import get_eval_dataset, make_preprocess_fn
from satellite_computervision_tpu_torch.models import UNet, fold_unet
from satellite_computervision_tpu_torch.predict import load_model, to_serving
from satellite_computervision_tpu_torch.train.checkpoint import build_empty
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.evaluate import evaluate_confusion
from satellite_computervision_tpu_torch.train.keras_import import (
    infer_unet_arch,
    keras_layers,
    load_keras_unet_h5,
)


def load_h5_model(h5, cfg, device, fold: bool = True) -> UNet:
    """A reference Keras U-Net ``.h5`` (a path or URL; or its layers in
    memory, ``train.keras_import.keras_layers``) as a ``UNet`` ready to
    serve on ``device``: the architecture inferred from the kernel shapes,
    the weights loaded, BN folded unless ``fold`` is False (numerically
    the same), bfloat16 on CUDA and float32 on the CPU."""
    layers = keras_layers(h5)
    arch = infer_unet_arch(layers)
    if arch["bands"] != len(cfg.bands):
        print(f"note: h5 expects {arch['bands']} bands; config "
              f"{cfg.name!r} lists {len(cfg.bands)} — the h5 wins")
    model = build_empty(UNet, arch["bands"], n_classes=arch["n_classes"],
                        filters=arch["filters"], factors=arch["factors"],
                        convs_per_block=arch["convs_per_block"],
                        head="sigmoid" if arch["n_classes"] == 1 else "softmax",
                        threshold=cfg.threshold)
    model = load_keras_unet_h5(layers, model)
    if fold:
        model = fold_unet(model)
    print(f"imported h5 U-Net: {arch['bands']} bands, filters "
          f"{arch['filters']}, convs_per_block {arch['convs_per_block']}, "
          f"{arch['n_classes']} classes, fold_bn={fold}")
    return to_serving(model, device)


def confusion_report(model, cfg, files, device, batch_size: int = 16, class_names=None):
    """The confusion report of ``model``'s ``classes`` over the eval
    TFRecords ``files``, through ``cfg``'s preprocess without augmentation,
    on ``device``."""
    bands = list(cfg.bands)
    preprocess = make_preprocess_fn(
        bands, cfg.response, axes=cfg.axes, splits=cfg.splits,
        response_depth=cfg.num_classes if cfg.num_classes > 1 else None, augment=False,
        device=device)
    it = get_eval_dataset(files, bands + [cfg.response], kernel_size=cfg.kernel_size,
                          batch_size=batch_size, device=device)

    def batches():
        for raw in it:
            yield preprocess(raw, train=False)

    def predict_classes(x):
        with torch.inference_mode():
            y_hat = model(x)["classes"]
        return y_hat[..., 0] if y_hat.ndim == 4 else y_hat

    return evaluate_confusion(predict_classes, batches(), max(cfg.num_classes, 2),
                              class_names=class_names)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--model", default="unet", choices=["unet", "deeplab", "acnn"],
                    help="single-input TFRecord families")
    ap.add_argument("--ckpt", help="checkpoint directory (reads <ckpt>/best), or --h5")
    ap.add_argument("--h5", help="reference Keras .h5 weights (path or URL): architecture "
                    "inferred, weights imported, BN folded, then evaluated")
    ap.add_argument("--family", default="unet", choices=["unet"],
                    help="--h5 model family (reference U-Nets)")
    ap.add_argument("--no-fold", action="store_true",
                    help="--h5: serve live eval-mode BN instead of the folded model")
    ap.add_argument("--eval", required=True, help="glob of eval TFRecords")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--class-names", nargs="*", default=None)
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = CONFIGS[args.config]
    files = sorted(glob.glob(args.eval))
    if not files:
        sys.exit(f"no files match {args.eval!r}")
    device = resolve_device(args.device)
    if args.h5:
        model = load_h5_model(args.h5, cfg, device, fold=not args.no_fold)
    elif args.ckpt:
        model = load_model(args.ckpt, device, cfg=cfg, arch=args.model)
    else:
        sys.exit("one of --ckpt / --h5 is required")

    report = confusion_report(model, cfg, files, device, args.batch_size, args.class_names)
    text = json.dumps(report, indent=2,
                      default=lambda o: o.tolist() if hasattr(o, "tolist") else float(o))
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()
