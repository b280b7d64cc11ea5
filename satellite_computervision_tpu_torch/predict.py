"""Full-scene prediction CLI (scene mode) — the port of
``scripts/predict.py scene``.

A ``.npy`` (H, W, C) or GeoTIFF scene goes through the tiled engine (chips
mode, the config's serving geometry unless flags override it) and the
prediction is written as a GeoTIFF. On CUDA the model serves in bfloat16;
on the CPU (``--device cpu``) in float32.

Example::

  python -m satellite_computervision_tpu_torch.predict scene \\
      --input scene.npy --ckpt runs/solar --config solar --fold-bn \\
      --output pred.tif --crs EPSG:32617 --transform 10 0 500000 0 -10 4500000
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.geo import read_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import UNet, fold_unet
from satellite_computervision_tpu_torch.train.checkpoint import load_checkpoint
from satellite_computervision_tpu_torch.train.config import CONFIGS


def load_scene(path):
    """Scene input -> ((H, W, C) array, meta dict). ``.tif``/``.tiff``
    carries transform/crs/nodata from the file; ``.npy`` loads bare."""
    if path.endswith((".tif", ".tiff")):
        return read_geotiff(path)
    scene = np.load(path)
    return (scene[..., None] if scene.ndim == 2 else scene), {}


def load_model(ckpt_dir: str, device, s2d=None, fold_bn: bool = False) -> UNet:
    """Restore ``<ckpt>/best`` for serving on ``device``: folded first if
    asked (in float32), then bfloat16 and channels-last on CUDA, float32
    on the CPU. ``s2d`` overrides the checkpoint's stem (a mismatching
    weight layout raises)."""
    model, meta = load_checkpoint(
        ckpt_dir, **({} if s2d is None else {"space_to_depth": s2d}))
    print(f"restored checkpoint (meta: {json.dumps(meta)})")
    if fold_bn:
        model = fold_unet(model)
    if device.type == "cuda":
        return model.to(device=device, dtype=torch.bfloat16,
                        memory_format=torch.channels_last)
    return model.to(device)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=["scene"])
    ap.add_argument("--input", required=True, help="scene .npy or GeoTIFF")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory (reads <ckpt>/best)")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--output", default="prediction.tif", help="output .tif path")
    ap.add_argument("--kernel", type=int, default=None,
                    help="engine chip kernel (default: the config's serving kernel)")
    ap.add_argument("--buffer", type=int, default=None,
                    help="engine chip context buffer (default: the config's)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="chips per forward (default: the config's serving batch)")
    ap.add_argument("--blend", choices=["overwrite", "hann"], default="hann")
    ap.add_argument("--fold-bn", action="store_true",
                    help="serve the BN-folded model (no BN ops; same math as eval-mode BN)")
    ap.add_argument("--uint8", action="store_true", help="write probabilities x255 as uint8")
    ap.add_argument("--s2d", action=argparse.BooleanOptionalAction, default=None,
                    help="the checkpoint's stem (default: as saved in the checkpoint)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--crs", default="")
    ap.add_argument("--transform", type=float, nargs=6,
                    help="affine: xscale xshear xtrans yshear yscale ytrans")
    ap.add_argument("--compress", choices=["none", "deflate", "lzw"], default="deflate",
                    help="output compression (lzw is pure Python in this package: slow)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CONFIGS[args.config]
    model = load_model(args.ckpt, device, args.s2d, args.fold_bn)
    kernel, buffer, batch = cfg.serving_geometry
    kernel = args.kernel or kernel
    buffer = args.buffer if args.buffer is not None else buffer
    batch = args.batch_size or batch
    print(f"serving geometry: k{kernel}+b{buffer} batch {batch} on {device}")
    engine = TiledInferenceEngine(
        lambda chips: model(chips)["probs"], kernel=kernel, buffer=buffer,
        batch_size=batch, out_channels=model.kwargs["n_classes"],
        blend=args.blend, device=device,
        output_transform=(lambda p: (p * 255.0).to(torch.uint8)) if args.uint8 else None,
    )
    scene, meta = load_scene(args.input)
    t0 = time.perf_counter()
    engine.predict_scene_to_geotiff(
        scene, args.output,
        transform=tuple(args.transform) if args.transform else meta.get("transform"),
        crs=args.crs or meta.get("crs", ""), compress=args.compress)
    dt = time.perf_counter() - t0
    h, w = scene.shape[:2]
    print(f"wrote {args.output} shape={(h, w, engine.out_channels)} "
          f"({dt:.3f} s incl. write)")
    return args.output


if __name__ == "__main__":
    main()
