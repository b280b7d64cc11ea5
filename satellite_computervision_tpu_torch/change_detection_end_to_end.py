"""Change detection end to end in the port: the run_local workflow without
the cloud.

The twin of ``examples/change_detection_end_to_end.py`` at its sizes
(reference: utils/pc_tools.py:620-668 + utils/model_tools.py:576-663):
before/after Sentinel-2 item sets -> NaN-median composites -> per-pixel
normalization -> 8-band concat (``cloud.compositing.change_pair_composite``
on the device) -> a short Siamese U-Net fit (the ``Trainer``'s train step)
-> full-scene tiled change probabilities -> GeoTIFF, read back. Synthetic
items stand in for STAC assets (no egress). Runs on the GPU by default;
pass ``--device cpu`` for the CPU.

Usage: python -m satellite_computervision_tpu_torch.change_detection_end_to_end
           [--scene 192] [--steps 40] [--kernel 64] [--buffer 32]
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
from satellite_computervision_tpu_torch.cloud.compositing import change_pair_composite
from satellite_computervision_tpu_torch.geo import read_geotiff, write_geotiff
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.models import SiameseUNet, losses
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state

BANDS = ("B02", "B03", "B04", "B08")


def synth_items(rng, h, w, n_items, date, farms):
    """Item set for one period; ``farms`` = [(y, x, side)] built-up areas."""
    items = []
    for _ in range(n_items):
        bands = {}
        veg = rng.uniform(0.4, 0.6)
        base = {
            "B02": 400 * veg + 900 * (1 - veg),
            "B03": 600 * veg + 1100 * (1 - veg),
            "B04": 400 * veg + 1400 * (1 - veg),
            "B08": 3200 * veg + 2400 * (1 - veg),
        }
        for b in BANDS:
            arr = np.full((h, w), base[b], np.float32)
            arr += rng.normal(0, 60, (h, w)).astype(np.float32)
            bands[b] = arr
        for (fy, fx, side) in farms:
            # built-up: bright visible, low NIR
            sig = {"B02": 1600.0, "B03": 1700.0, "B04": 1900.0, "B08": 1500.0}
            for b in BANDS:
                bands[b][fy : fy + side, fx : fx + side] = sig[b] + rng.normal(
                    0, 40, (side, side)
                )
        # random cloud-masked (nodata) patch per item
        cy, cx = rng.integers(0, h - 24), rng.integers(0, w - 24)
        for b in BANDS:
            bands[b][cy : cy + 24, cx : cx + 24] = 0.0
        items.append({"datetime": date, "bands": bands})
    return items


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", type=int, default=192)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--kernel", type=int, default=64)
    ap.add_argument("--buffer", type=int, default=32)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="scv_torch_change_")
    os.makedirs(outdir, exist_ok=True)

    rng = np.random.default_rng(0)
    h = w = args.scene

    # --- training chips: pairs with/without change --------------------------
    model = SiameseUNet(len(BANDS), filters=(8, 16), factors=(2, 2), threshold=0.5)
    model = flax_init_(model, torch.Generator().manual_seed(0)).to(device)
    k = args.kernel + args.buffer
    loss_fn = lambda y, p: losses.weighted_bce(y, p, pos_weight=3.0, logits=True)  # noqa: E731
    trainer = Trainer(create_train_state(model, 1e-3), loss_fn, pred_key="logits",
                      num_classes=2)

    def training_batch(batch=8):
        xs_b, xs_a, ys = [], [], []
        for _ in range(batch):
            farms_before = []
            farms_after = []
            label = np.zeros((k, k, 1), np.float32)
            if rng.random() < 0.7:  # new construction = change
                fy, fx, side = rng.integers(8, k - 40), rng.integers(8, k - 40), 24
                farms_after.append((fy, fx, side))
                label[fy : fy + side, fx : fx + side] = 1.0
            if rng.random() < 0.4:  # pre-existing structure = no change
                fy, fx = rng.integers(8, k - 40, 2)
                farms_before.append((fy, fx, 16))
                farms_after.append((fy, fx, 16))
            before = synth_items(rng, k, k, 3, "2021-06-01", farms_before)
            after = synth_items(rng, k, k, 3, "2022-06-01", farms_after)
            pair = change_pair_composite(before, after, BANDS, device=device)
            xs_b.append(pair[..., : len(BANDS)])
            xs_a.append(pair[..., len(BANDS) :])
            ys.append(label)
        return (torch.stack(xs_b), torch.stack(xs_a)), torch.from_numpy(np.stack(ys)).to(device)

    t0 = time.time()
    for i in range(args.steps):
        out = trainer.train_step(trainer.state, training_batch())
        if i % 10 == 0:
            print(f"step {i}: loss={float(out['loss']):.4f}")
    print(f"trained {args.steps} steps in {time.time() - t0:.1f}s")

    # --- full-scene pass: composite -> tiled siamese inference --------------
    farms_after = [(h // 3, w // 3, 28)]
    before_items = synth_items(rng, h, w, 4, "2021-06-01", [])
    after_items = synth_items(rng, h, w, 4, "2022-06-01", farms_after)
    scene = change_pair_composite(before_items, after_items, BANDS, device=device)

    model.eval()
    nb = len(BANDS)
    engine = TiledInferenceEngine(
        lambda chips: model(chips[..., :nb], chips[..., nb:])["probs"],
        kernel=args.kernel, buffer=args.buffer, batch_size=8, out_channels=1, device=device,
    )
    pred = engine.predict_scene(scene).cpu().numpy()

    fy, fx = h // 3, w // 3
    mask = np.zeros((h, w), bool)
    mask[fy : fy + 28, fx : fx + 28] = True
    inside = float(pred[..., 0][mask].mean())
    outside = float(pred[..., 0][~mask].mean())
    report = {"mean_prob_change": round(inside, 3), "mean_prob_background": round(outside, 3)}
    print(json.dumps(report))

    out_tif = os.path.join(outdir, "change.tif")
    write_geotiff(out_tif, pred, transform=(10.0, 0.0, 500000.0, 0.0, -10.0, 3900000.0),
                  crs="EPSG:32617")
    back, meta = read_geotiff(out_tif)
    print(f"geotiff: {out_tif} shape={back.shape} crs={meta['crs']}")
    if back.shape != pred.shape:
        raise RuntimeError(f"GeoTIFF round trip changed the shape: {back.shape}")
    if not inside > outside:
        raise RuntimeError(f"change probability should peak on new construction: {report}")
    print("OK")
    return report


if __name__ == "__main__":
    main()
