"""End-to-end demo of the port: the solar-array workflow on synthetic data.

The twin of ``examples/solar_end_to_end.py`` at its sizes: synthesize
EE-schema TFRecord chips, train the binary U-Net with weighted BCE on
batches preprocessed on the device (``axes=(0, 1)``: the CUDA
``fused_preprocess`` on the GPU), evaluate IoU, run tiled scene inference
and export a georeferenced GeoTIFF. Runs on the GPU by default; pass
``--device cpu`` for the CPU.

Usage: python -m satellite_computervision_tpu_torch.solar_end_to_end [--steps N]
           [--outdir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.pipeline import (
    get_training_dataset,
    make_preprocess_fn,
)
from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.geo import read_geotiff, write_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import UNet, losses, metrics
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state

BANDS = ["B2", "B3", "B4", "B8"]
KERNEL = 64  # small demo chips; the real config uses 256 (SOLAR_CONFIG)


def synthesize_chips(path, n=64, seed=0, bands=BANDS, kernel=KERNEL):
    """Fake Sentinel-2 chips: bright square 'solar arrays' on noise."""
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n):
        chip = {b: rng.uniform(0.05, 0.3, (kernel, kernel)).astype(np.float32) for b in bands}
        label = np.zeros((kernel, kernel), np.float32)
        for _ in range(rng.integers(1, 4)):
            y, x = rng.integers(4, kernel - 20, 2)
            h, w = rng.integers(8, 16, 2)
            label[y : y + h, x : x + w] = 1.0
            for b in bands:
                chip[b][y : y + h, x : x + w] += 0.5
        ex = {k: v.reshape(-1) for k, v in chip.items()}
        ex["landcover"] = label.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(path, examples)
    return examples


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="scv_torch_demo_")
    os.makedirs(outdir, exist_ok=True)
    print(f"torch {torch.__version__}, device: {device}")

    # 1. data: EE-schema TFRecords -> device batches, preprocessed there
    tfr = os.path.join(outdir, "train.tfrecord")
    synthesize_chips(tfr, n=64)
    ds = get_training_dataset([tfr], BANDS + ["landcover"], kernel_size=KERNEL,
                              batch_size=8, shuffle_buffer=64, device=device)
    preprocess = make_preprocess_fn(BANDS, "landcover", axes=(0, 1), device=device)

    # 2. model + train state (binary U-Net, weighted BCE: the solar config)
    model = UNet(len(BANDS), n_classes=1, filters=(8, 16), factors=(2, 2), head="sigmoid",
                 threshold=0.9)
    model = flax_init_(model, torch.Generator().manual_seed(0)).to(device)
    loss_fn = lambda y, p: losses.weighted_bce(y, p, pos_weight=4.0, logits=True)  # noqa: E731
    trainer = Trainer(create_train_state(model, 1e-3), loss_fn, pred_key="logits",
                      num_classes=2)

    # 3. train
    gen = torch.Generator().manual_seed(1)
    it = iter(ds)
    t0 = time.time()
    for step in range(args.steps):
        out = trainer.train_step(trainer.state, preprocess(next(it), gen, train=True))
        if step % 10 == 0:
            print(f"step {step}: loss={float(out['loss']):.4f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    # 4. eval on fresh batches
    cm = metrics.init_metric_state(2, device)
    for _ in range(4):
        cm = cm + trainer.eval_step(trainer.state, preprocess(next(it), train=False))["cm"]
    final = {k: float(v) for k, v in metrics.finalize_metrics(cm).items()}
    print("eval:", json.dumps(final))

    # 5. tiled full-scene inference -> GeoTIFF
    rng = np.random.default_rng(7)
    scene = rng.uniform(0.05, 0.3, (5 * KERNEL, 5 * KERNEL, len(BANDS))).astype(np.float32)
    scene[100:140, 100:150] += 0.5  # a "solar farm"
    engine = TiledInferenceEngine.from_model(
        model, kernel=KERNEL, buffer=KERNEL // 2, batch_size=8, out_channels=1, device=device)
    t0 = time.time()
    pred = engine.predict_scene(scene).cpu().numpy()
    dt = time.time() - t0
    mpix = scene.shape[0] * scene.shape[1] / 1e6
    print(f"scene inference: {scene.shape} in {dt:.2f}s ({mpix / dt:.2f} MPix/s)")

    tif = os.path.join(outdir, "solar_pred.tif")
    write_geotiff(tif, pred, transform=(10.0, 0, 500000.0, 0, -10.0, 4500000.0),
                  crs="EPSG:32617", nodata=255)
    back, meta = read_geotiff(tif)
    print(f"geotiff: {tif} shape={back.shape} crs={meta.get('crs')} "
          f"mean_prob_in_farm={pred[100:140, 100:150, 0].mean():.3f} "
          f"mean_prob_bg={pred[200:, 200:, 0].mean():.3f}")
    if back.shape != pred.shape:
        raise RuntimeError(f"GeoTIFF round trip changed the shape: {back.shape}")
    print("OK")
    return final


if __name__ == "__main__":
    main()
