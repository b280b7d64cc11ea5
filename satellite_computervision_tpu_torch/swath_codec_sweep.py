"""Swath-scale codec -> engine -> codec sweep in the port: the measured
disk-to-disk loop.

The twin of ``examples/swath_codec_sweep.py`` (the reference serves state
sweeps by reading LZW COGs through GDAL, predicting chip by chip and
writing whole scenes: utils/raster_tools.py:367-461,
utils/prediction_tools.py:447-536):

1. synthesize N LZW + predictor-2 COG scenes (default 8192 x 8192 x 4
   uint16, 512 MB raw apiece) through the streaming COG writer
   (``geo.GeoTiffCogStreamWriter``), so synthesis is O(band) memory;
2. calibrate per band from a COG overview page (percentile clamp+scale)
   — O(overview) host cost; one collection calibration for the sweep,
   applied as the engine's ``preprocess_fn`` on the device;
3. serve each scene through the banded tiled engine (``max_rows``:
   full-width bands, hann blend — one ``hann_stitch`` per band — the
   BN-folded U-Net at ``--filters``, bfloat16 on CUDA);
4. stream the predictions into a tiled uint8 COG with overview pyramids
   (``predict_scene_to_geotiff(cog=True)``).

Host memory stays O(band) end to end. Records, appended to ``--log``
(default ``runs/torch/swath_codec_sweep.jsonl``), carry the JAX script's
keys — one per scene (``mpix_per_s``, ``peak_rss_mb``, ``rss_now_mb``, ...)
and a summary (``synth_mb_per_s``, ``sweep_mpix_per_s``, ``rss_growth_mb``,
``band_mb``, ...) — with ``platform`` the device's name, plus the
``hann_stitch`` launches per scene and in all. ``rss_growth_mb`` is, as
in JAX, the resident set at the end less the one before synthesis;
``rss_model_mb`` is the resident set once the model is on the device (the
CUDA context and the pinned staging buffers count there), and
``rss_growth_after_model_mb`` the growth from it, which is the serving
loop's own.

Usage: python -m satellite_computervision_tpu_torch.swath_codec_sweep
           [--scenes 2] [--height 8192] [--width 8192] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import tempfile
import time

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.geo import GeoTiffCogStreamWriter, GeoTiffScene
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.kernels import stitch
from satellite_computervision_tpu_torch.models import UNet, fold_unet
from satellite_computervision_tpu_torch.models.unet import flax_init_
from satellite_computervision_tpu_torch.predict import to_serving

TRANSFORM = (10.0, 0.0, 500000.0, 0.0, -10.0, 4500000.0)


def _rss_mb() -> float:
    """Lifetime peak RSS (ru_maxrss) — never decreases, so a transient of
    the first scene stays in it."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _rss_now_mb() -> float:
    """Current resident set (VmRSS): the O(band) steady-state measure."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return _rss_mb()


def synthesize_scene(path, height, width, bands, seed, band_rows=1024,
                     tile_size=256):
    """Stream a smooth-field uint16 scene into an LZW+predictor-2 COG.

    Spatially correlated content (low-res normals, bilinearly upsampled
    per row-block) so LZW+differencing compresses, as real reflectance
    rasters do — white noise would expand under LZW."""
    rng = np.random.default_rng(seed)
    cell = 64
    low = rng.normal(0.45, 0.18, (height // cell + 2, width // cell + 2,
                                  bands)).astype(np.float32)
    with GeoTiffCogStreamWriter(
        path, height, width, bands, np.uint16, transform=TRANSFORM,
        crs="EPSG:32617", compress="lzw", predictor=2, tile_size=tile_size,
    ) as wr:
        xs = np.arange(width, dtype=np.float32) / cell
        x0 = xs.astype(np.int32)
        fx = (xs - x0)[None, :, None]
        for y in range(0, height, band_rows):
            n = min(band_rows, height - y)
            ys = (y + np.arange(n, dtype=np.float32)) / cell
            y0 = ys.astype(np.int32)
            fy = (ys - y0)[:, None, None]
            a = low[y0][:, x0] * (1 - fy) * (1 - fx) + low[y0 + 1][:, x0] * fy * (1 - fx)
            b = low[y0][:, x0 + 1] * (1 - fy) * fx + low[y0 + 1][:, x0 + 1] * fy * fx
            block = np.clip((a + b) * 3000.0, 0, 10000)
            block += rng.normal(0, 12.0, block.shape)
            wr.write_rows(np.clip(block, 0, 65535).astype(np.uint16))
    return os.path.getsize(path)


def overview_calibration(path, percentiles=(1, 99)):
    """Per-band clamp+scale bounds from the COG's coarsest overview (up to
    1024 on a side) — the O(overview) stand-in for the full-scene
    percentiles of ``cloud.calibration.clamp_and_scale``."""
    page = 0
    while True:
        try:
            sc = GeoTiffScene(path, page + 1)
        except Exception:
            break
        page += 1
        if max(sc.shape[:2]) <= 1024:
            break
    ov = np.asarray(GeoTiffScene(path, page), np.float32)
    lo = np.percentile(ov, percentiles[0], axis=(0, 1))
    hi = np.percentile(ov, percentiles[1], axis=(0, 1))
    return lo.astype(np.float32), hi.astype(np.float32), page


def serving_model(args, device):
    """The served model: a U-Net at ``--filters`` with flax's default init
    from ``--seed``, BN folded, bfloat16 on CUDA (float32 on the CPU)."""
    model = UNet(args.bands, n_classes=1, filters=tuple(args.filters),
                 factors=(2,) * len(args.filters), head="sigmoid")
    model = flax_init_(model, torch.Generator().manual_seed(args.seed)).eval()
    return to_serving(fold_unet(model), device)


def build_engine(served, args, lo, hi, device, max_rows):
    """``served`` behind the banded hann engine, with the collection
    calibration ``lo``/``hi`` as its device preprocess and a uint8
    output."""
    lo_d = torch.from_numpy(lo).to(device)
    scale_d = torch.clamp(torch.from_numpy(hi).to(device) - lo_d, min=1e-6)

    def preprocess(s):
        return torch.clamp((s.float() - lo_d) / scale_d, 0, 1)

    def predict(chips):
        return served(chips)["probs"]

    return TiledInferenceEngine(
        predict, kernel=args.kernel, buffer=args.buffer, batch_size=args.batch,
        out_channels=1, blend="hann", index_mode="grid", max_rows=max_rows,
        preprocess_fn=preprocess,
        output_transform=lambda pr: (pr * 255.0).to(torch.uint8), device=device)


def platform_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenes", type=int, default=2)
    ap.add_argument("--height", type=int, default=8192)
    ap.add_argument("--width", type=int, default=8192)
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--kernel", type=int, default=512)
    ap.add_argument("--buffer", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-rows", type=int, default=None,
                    help="band height for the streaming engine (default: "
                    "2 chip rows + buffer)")
    ap.add_argument("--filters", type=int, nargs="*",
                    default=[32, 64, 128, 256, 512])
    ap.add_argument("--dir", default=None,
                    help="scene/output directory (default: temp dir)")
    ap.add_argument("--log", default="runs/torch/swath_codec_sweep.jsonl")
    ap.add_argument("--keep", action="store_true",
                    help="keep the synthesized/predicted GeoTIFFs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    max_rows = args.max_rows or (2 * args.kernel + args.buffer)
    workdir = args.dir or tempfile.mkdtemp(prefix="scv_torch_swath_")
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    raw_mb = args.height * args.width * args.bands * 2 / 1e6
    mpix = args.height * args.width / 1e6
    rss_start = _rss_now_mb()  # current RSS: same metric as rss_growth's end
    records = []

    # ---- 1. synthesize the LZW+predictor COG inputs ----------------------
    paths = []
    t0 = time.perf_counter()
    for i in range(args.scenes):
        p = os.path.join(workdir, f"scene_{i}.tif")
        size = synthesize_scene(p, args.height, args.width, args.bands,
                                args.seed + i)
        paths.append(p)
        print(f"synthesized {p}: {args.height}x{args.width}x{args.bands} "
              f"uint16, lzw+p2 = {size / 1e6:.0f} MB "
              f"({size / (raw_mb * 1e6):.2f} of raw)", flush=True)
    t_synth = time.perf_counter() - t0

    # ---- 2. collection calibration from the overview pages, model + engine
    # (one clamp+scale for the whole sweep, as cloud/calibration's
    # equalize_collection normalizes a collection to a shared target)
    los, his = [], []
    for p in paths:
        lo, hi, page = overview_calibration(p)
        los.append(lo)
        his.append(hi)
    lo, hi = np.median(los, axis=0), np.median(his, axis=0)
    print(f"collection calibration from overview page {page}: "
          f"lo={np.round(lo, 1).tolist()} hi={np.round(hi, 1).tolist()}", flush=True)
    engine = build_engine(serving_model(args, device), args, lo.astype(np.float32),
                          hi.astype(np.float32), device, max_rows)
    rss_model = _rss_now_mb()

    # ---- 3./4. serve each scene disk to disk ------------------------------
    launches_total = 0
    for i, p in enumerate(paths):
        scene = GeoTiffScene(p)  # lazy: bands decode on demand
        out = os.path.join(workdir, f"pred_{i}.tif")
        before = stitch.hann_stitch.launches
        t0 = time.perf_counter()
        engine.predict_scene_to_geotiff(scene, out, transform=TRANSFORM,
                                        crs="EPSG:32617", cog=True)
        dt = time.perf_counter() - t0
        launches = stitch.hann_stitch.launches - before
        launches_total += launches
        rec = {
            "platform": platform_name(device),
            "scene": i, "height": args.height, "width": args.width,
            "bands": args.bands, "raw_mb": round(raw_mb, 1),
            "in_mb": round(os.path.getsize(p) / 1e6, 1),
            "out_mb": round(os.path.getsize(out) / 1e6, 1),
            "calib_page": page,
            "kernel": args.kernel, "buffer": args.buffer,
            "max_rows": max_rows, "secs": round(dt, 2),
            "mpix_per_s": round(mpix / dt, 2),
            "peak_rss_mb": round(_rss_mb(), 1),
            "rss_now_mb": round(_rss_now_mb(), 1),
            "hann_stitch_launches": launches,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if not args.keep:
            os.remove(out)

    steady = records[1:] or records  # the first scene pays the warm-up
    rss_end = _rss_now_mb()
    summary = {
        "platform": platform_name(device),
        "swath_scenes": args.scenes,
        "scene_mpix": round(mpix, 1),
        "raw_mb_per_scene": round(raw_mb, 1),
        "synth_secs": round(t_synth, 1),
        "synth_mb_per_s": round(args.scenes * raw_mb / t_synth, 1),
        "sweep_mpix_per_s": round(
            sum(r["mpix_per_s"] for r in steady) / len(steady), 2),
        "peak_rss_mb": round(_rss_mb(), 1),
        "rss_now_mb": round(rss_end, 1),
        "rss_start_mb": round(rss_start, 1),
        # O(band) proof: steady-state resident memory stays a small
        # multiple of one band, nowhere near N x raw scene size
        "rss_growth_mb": round(rss_end - rss_start, 1),
        "rss_model_mb": round(rss_model, 1),
        "rss_growth_after_model_mb": round(rss_end - rss_model, 1),
        "band_mb": round(max_rows * args.width * args.bands * 2 / 1e6, 1),
        "hann_stitch_launches": launches_total,
        "config": {"kernel": args.kernel, "buffer": args.buffer,
                   "batch": args.batch, "max_rows": max_rows},
    }
    with open(args.log, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.write(json.dumps({"summary": summary}) + "\n")
    if not args.keep:
        for p in paths:
            os.remove(p)
    print("SWATH " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
