"""Export a trained U-Net checkpoint as a reference-layout Keras ``.h5``.

Port of ``scripts/export.py``::

  python -m satellite_computervision_tpu_torch.export --config solar \\
      --ckpt runs/solar --out solar.h5

The reference ecosystem's model-artifact channel is Keras ``save_weights``
HDF5 (shared over Azure blob storage, utils/model_tools.py:1178-1269).
This CLI restores ``<ckpt>/best`` — ``model.pt`` (the port's format) or
``state.msgpack`` (the JAX package's) through ``predict.load_model``, in
float32 — and writes the weights in the layout the reference's builders
produce (``train.keras_export``), so colleagues on the TF/Keras stack can
``model.load_weights()`` the file and ``evaluate --h5`` reads it back.

Only the plain-stem U-Net maps onto the reference architecture
(utils/model_tools.py:321-531): space-to-depth and folded-BN checkpoints
are refused with a ``ValueError``. The model is loaded on ``--device``
(default cuda; without CUDA it raises unless ``--device cpu``). For a blob
upload use ``train.keras_export.export_keras_unet_h5_bytes`` with
``cloud.blob``.
"""

from __future__ import annotations

import argparse
import os

import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.predict import load_model
from satellite_computervision_tpu_torch.train.config import CONFIGS
from satellite_computervision_tpu_torch.train.keras_export import export_keras_unet_h5
from satellite_computervision_tpu_torch.train.keras_import import infer_unet_arch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="solar")
    ap.add_argument("--ckpt", required=True, help="checkpoint dir (restores <ckpt>/best)")
    ap.add_argument("--out", required=True, help="output .h5 path")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    model = load_model(args.ckpt, resolve_device(args.device), cfg=CONFIGS[args.config],
                       dtype=torch.float32)
    export_keras_unet_h5(model, args.out)
    arch = infer_unet_arch(args.out)
    print(
        f"wrote {args.out}: {arch['bands']} bands, filters {arch['filters']},"
        f" convs_per_block {arch['convs_per_block']}, "
        f"{arch['n_classes']} classes "
        f"({os.path.getsize(args.out) / 1e6:.1f} MB)"
    )
    return arch


if __name__ == "__main__":
    main()
