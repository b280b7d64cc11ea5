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

Not ported yet: ``--model acnn``, and the reference Keras ``.h5`` mode
(``--h5``, ``--family``, ``--no-fold``).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys

import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.pipeline import get_eval_dataset, make_preprocess_fn
from satellite_computervision_tpu_torch.predict import load_model
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.evaluate import evaluate_confusion


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--model", default="unet", choices=["unet", "deeplab", "acnn"],
                    help="single-input TFRecord families")
    ap.add_argument("--ckpt", help="checkpoint directory (reads <ckpt>/best)")
    ap.add_argument("--h5", help="reference Keras .h5 weights (not ported yet)")
    ap.add_argument("--family", default=None, help="--h5 model family (not ported yet)")
    ap.add_argument("--no-fold", action="store_true", help="--h5 option (not ported yet)")
    ap.add_argument("--eval", required=True, help="glob of eval TFRecords")
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--class-names", nargs="*", default=None)
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.model == "acnn":
        sys.exit("--model acnn is not ported yet")
    for flag, given in (("--h5", args.h5), ("--family", args.family),
                        ("--no-fold", args.no_fold)):
        if given:
            sys.exit(f"{flag} is not ported yet")
    if not args.ckpt:
        sys.exit("--ckpt is required")
    cfg = CONFIGS[args.config]
    files = sorted(glob.glob(args.eval))
    if not files:
        sys.exit(f"no files match {args.eval!r}")
    device = resolve_device(args.device)
    model = load_model(args.ckpt, device, cfg=cfg, arch=args.model)

    bands = list(cfg.bands)
    preprocess = make_preprocess_fn(
        bands, cfg.response, axes=cfg.axes, splits=cfg.splits,
        response_depth=cfg.num_classes if cfg.num_classes > 1 else None, augment=False,
        device=device)
    it = get_eval_dataset(files, bands + [cfg.response], kernel_size=cfg.kernel_size,
                          batch_size=args.batch_size, device=device)

    def batches():
        for raw in it:
            yield preprocess(raw, train=False)

    def predict_classes(x):
        with torch.inference_mode():
            y_hat = model(x)["classes"]
        return y_hat[..., 0] if y_hat.ndim == 4 else y_hat

    report = evaluate_confusion(predict_classes, batches(), max(cfg.num_classes, 2),
                                class_names=args.class_names)
    text = json.dumps(report, indent=2,
                      default=lambda o: o.tolist() if hasattr(o, "tolist") else float(o))
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return report


if __name__ == "__main__":
    main()
