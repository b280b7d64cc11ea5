#!/usr/bin/env python3
"""The convergence twins' full runs on one NVIDIA GPU, and the
measurements around them.

    python3 convergence_runs.py RUN [RUN ...] [--outdir build/convergence_out]

Each RUN drives a twin of ``satellite_computervision_tpu_torch`` through
its ``main(argv)`` at the JAX record's configuration, or measures:

- ``solar``, ``solar_s2d``, ``solar_full``: ``solar_convergence`` at
  1540/330 chips x 20 epochs (batch 16, ``--scene-eval``), the same with
  ``--space-to-depth``, and at 7700/3300 x 6 epochs;
- ``fold_check`` (after ``solar``): the trained checkpoint's 330 eval
  chips through the BN-folded and the unfolded U-Net, both bfloat16 on the
  card: the pixels whose class differs between the two ("moved"), the
  pixels whose float32 probability lies within 1e-2 of the threshold
  ("near"), and the moved pixels outside that band (must be 0);
- ``swath``: ``swath_codec_sweep`` at its defaults (2 x 8192² x 4 uint16,
  k512 + b128, batch 16); ``swath_stages``: one such scene's stages timed
  apart — decode of the engine's band reads (each band re-reads its halo
  chip rows) and of the whole scene once, the overview calibration, the
  engine on the decoded scene in memory (its device busy share from
  ``torch.profiler``), the uint8 COG encode — beside the end-to-end serve;
- ``change``: ``change_convergence --scene-eval`` at its defaults;
- ``parking``: ``parking_convergence --model deeplab --epochs 1
  --export-backbone``, then ``--epochs 5 --torch-weights`` from that file;
  ``parking_unet``: ``--model unet`` at its defaults;
- ``step_rates``: each twin's warm train step on a batch already on the
  card (bfloat16 autocast), so the device's chips/s stands beside the
  host's chip synthesis in the epoch records.

JSONL records and checkpoints are written under ``build/convergence/``;
the JSONL files, a log per run and ``results.json`` (one entry per run:
seconds, the summary, the card) are copied to ``--outdir``. Any run that
fails is reported and the script exits 1 after the others.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "convergence")


def _jsonl(name):
    return os.path.join(WORK, f"{name}.jsonl")


def solar_flags(extra, out):
    return ["--batch-size", "16", "--scene-eval", "--out", _jsonl(out)] + extra


def timed(fn):
    """``fn()``: its result and the seconds it took."""
    t0 = time.perf_counter()
    result = fn()
    return result, time.perf_counter() - t0


def run_main(module, argv):
    """``module.main(argv)``: its result and the seconds it took."""
    return timed(lambda: module.main(argv))


def fold_check(torch, ckpt, eval_size=330, batch=16, device="cuda"):
    """Folded against unfolded serving of ``ckpt``'s U-Net (bfloat16 on
    CUDA) on the solar eval chips, with the float32 model as the judge of
    "near"."""
    from satellite_computervision_tpu_torch import predict
    from satellite_computervision_tpu_torch.solar_convergence import make_chip

    dev = torch.device(device)
    # the float32 judge without TF32 (cuDNN's default for float32 convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    unfolded = predict.load_model(ckpt, dev)
    folded = predict.load_model(ckpt, dev, fold_bn=True)
    f32 = predict.load_model(ckpt, dev, dtype=torch.float32)
    thr = f32.threshold
    totals = dict(pixels=0, near=0, moved=0, moved_outside_near=0, positive_f32=0,
                  positive_unfolded=0, positive_folded=0)
    with torch.inference_mode():
        for i in range(0, eval_size, batch):
            x = torch.from_numpy(np.stack([make_chip("eval", j)[0]
                                           for j in range(i, min(i + batch, eval_size))]))
            x = x.to(dev)
            pu = unfolded(x)["probs"].float()
            pf = folded(x)["probs"].float()
            p32 = f32(x)["probs"]
            cu, cf = pu > thr, pf > thr
            moved = cu != cf
            near = (p32 - thr).abs() < 1e-2
            totals["pixels"] += p32.numel()
            totals["near"] += int(near.sum())
            totals["moved"] += int(moved.sum())
            totals["moved_outside_near"] += int((moved & ~near).sum())
            totals["positive_f32"] += int((p32 > thr).sum())
            totals["positive_unfolded"] += int(cu.sum())
            totals["positive_folded"] += int(cf.sum())
    totals.update(near_share=totals["near"] / totals["pixels"],
                  moved_share=totals["moved"] / totals["pixels"], threshold=thr)
    if totals["moved_outside_near"]:
        raise RuntimeError(f"folded serving moved pixels far from the threshold: {totals}")
    return totals


def swath_stages(torch, seed=0, device="cuda", **sizes):
    """One 8192² x 4 uint16 scene's serving (the sweep's defaults, which
    ``sizes`` may override) split into its stages."""
    import chip_smoke
    from satellite_computervision_tpu_torch import swath_codec_sweep as sweep
    from satellite_computervision_tpu_torch.geo import GeoTiffCogStreamWriter, GeoTiffScene

    args = argparse.Namespace(**{**dict(scenes=1, height=8192, width=8192, bands=4, kernel=512,
                                        buffer=128, batch=16, filters=[32, 64, 128, 256, 512]),
                                 **sizes, "seed": seed})
    dev = torch.device(device)
    max_rows = 2 * args.kernel + args.buffer
    os.makedirs(os.path.join(WORK, "swath"), exist_ok=True)
    path = os.path.join(WORK, "swath", "stages.tif")
    out = {}
    t0 = time.perf_counter()
    sweep.synthesize_scene(path, args.height, args.width, args.bands, seed)
    out["synthesize_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lo, hi, page = sweep.overview_calibration(path)
    out["calibration_s"] = time.perf_counter() - t0

    scene = GeoTiffScene(path)
    reads = chip_smoke.band_chip_rows(-(-args.height // args.kernel), max_rows, args.kernel,
                                      args.buffer)
    half = args.buffer // 2
    t0 = time.perf_counter()
    for lo_row, hi_row in reads:  # the engine's band reads: halo chip rows and context
        np.asarray(scene[max(0, lo_row * args.kernel - half):
                         min(args.height, hi_row * args.kernel + half)])
    out["decode_banded_s"] = time.perf_counter() - t0
    out["decoded_rows_banded"] = sum(min(args.height, b * args.kernel + half)
                                     - max(0, a * args.kernel - half) for a, b in reads)
    t0 = time.perf_counter()
    decoded = np.asarray(GeoTiffScene(path))
    out["decode_whole_s"] = time.perf_counter() - t0

    engine = sweep.build_engine(sweep.serving_model(args, dev), args, lo, hi, dev, max_rows)
    blocks = []

    def serve_memory():
        blocks.clear()
        engine._predict_banded(decoded, sink=blocks.append)

    serve_memory()  # warm
    chip_smoke.sync(device)
    t0 = time.perf_counter()
    serve_memory()
    chip_smoke.sync(device)
    out["engine_in_memory_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        prof = chip_smoke.device_profile(torch, serve_memory)
        out["engine_profile"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "device_busy_share", "device_launches", "top", "host_top")}
    pred = np.concatenate(blocks)

    enc = os.path.join(WORK, "swath", "stages_out.tif")
    t0 = time.perf_counter()
    with GeoTiffCogStreamWriter(enc, args.height, args.width, 1, np.uint8,
                                transform=sweep.TRANSFORM, crs="EPSG:32617") as wr:
        for y in range(0, args.height, args.kernel):
            wr.write_rows(pred[y: y + args.kernel])
    out["encode_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine.predict_scene_to_geotiff(GeoTiffScene(path), enc, transform=sweep.TRANSFORM,
                                    crs="EPSG:32617", cog=True)
    out["end_to_end_s"] = time.perf_counter() - t0
    out["mpix"] = args.height * args.width / 1e6
    for p in (path, enc):
        os.remove(p)
    return out


def step_rates(torch):
    """Warm train step ms and chips/s of each twin's model and batch on a
    batch already on the card (bfloat16 autocast, the twins' losses)."""
    import chip_smoke
    from satellite_computervision_tpu_torch import (
        change_convergence,
        parking_convergence,
        solar_convergence,
    )
    from satellite_computervision_tpu_torch.models import UNet, losses
    from satellite_computervision_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    dev = torch.device("cuda")

    def solar(s2d):
        return UNet(6, n_classes=1, head="sigmoid", threshold=0.9, bn_momentum=0.9,
                    space_to_depth=s2d)

    cases = [
        ("solar", lambda: solar(False), solar_convergence.make_chip, 16, 2.0),
        ("solar_s2d", lambda: solar(True), solar_convergence.make_chip, 16, 2.0),
        ("change", lambda: change_convergence.StackedSiamese(0.5),
         change_convergence.make_chip, 8, 4.0),
        ("parking_deeplab", lambda: parking_convergence.build_model("deeplab", 0),
         parking_convergence.make_chip, 16, 20.0),
        ("parking_unet", lambda: parking_convergence.build_model("unet", 0),
         parking_convergence.make_chip, 16, 20.0),
    ]
    out = {}
    for name, build, make_chip, batch, pw in cases:
        model = build().to(dev)
        xs, ys = zip(*(make_chip("train", i) for i in range(batch)))
        x, y = torch.from_numpy(np.stack(xs)).to(dev), torch.from_numpy(np.stack(ys)).to(dev)
        step = make_train_step(lambda t, p, pw=pw: losses.weighted_bce(t, p, pw, logits=True),
                               compute_dtype=torch.bfloat16)
        state = create_train_state(model, 9e-4)
        t0 = time.perf_counter()
        synth = [make_chip("train", i) for i in range(batch)]
        synth_s = (time.perf_counter() - t0) / batch
        del synth
        ms = chip_smoke.wall_ms(lambda: step(state, (x, y)), iters=10)
        med = chip_smoke.median(ms)
        out[name] = dict(batch=batch, step_ms=ms, step_ms_median=med,
                         device_chips_per_s=batch / (med / 1e3),
                         host_chip_ms_one_thread=synth_s * 1e3,
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        del model, state, x, y
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def runs(torch):
    from satellite_computervision_tpu_torch import (
        change_convergence,
        parking_convergence,
        solar_convergence,
        swath_codec_sweep,
    )

    bb = os.path.join(WORK, "backbone.pth")
    return {
        "solar": lambda: run_main(solar_convergence, solar_flags(
            ["--train-size", "1540", "--eval-size", "330", "--epochs", "20"],
            "solar_convergence")),
        "solar_s2d": lambda: run_main(solar_convergence, solar_flags(
            ["--train-size", "1540", "--eval-size", "330", "--epochs", "20",
             "--space-to-depth"], "solar_convergence_s2d")),
        "solar_full": lambda: run_main(solar_convergence, solar_flags(
            ["--train-size", "7700", "--eval-size", "3300", "--epochs", "6"],
            "solar_convergence_full")),
        "fold_check": lambda: timed(lambda: fold_check(
            torch, os.path.join(WORK, "solar_convergence_ckpt"))),
        "swath": lambda: run_main(swath_codec_sweep, [
            "--dir", os.path.join(WORK, "swath"), "--log", _jsonl("swath_codec_sweep")]),
        "swath_stages": lambda: timed(lambda: swath_stages(torch)),
        "change": lambda: run_main(change_convergence, [
            "--scene-eval", "--out", _jsonl("change_convergence")]),
        "parking": lambda: (run_main(parking_convergence, [
            "--model", "deeplab", "--epochs", "1", "--export-backbone", bb,
            "--out", _jsonl("parking_convergence_pretrain")]), run_main(parking_convergence, [
                "--model", "deeplab", "--epochs", "5", "--torch-weights", bb,
                "--out", _jsonl("parking_convergence")])),
        "parking_unet": lambda: run_main(parking_convergence, [
            "--model", "unet", "--out", _jsonl("parking_convergence_unet")]),
        "step_rates": lambda: timed(lambda: step_rates(torch)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("runs", nargs="+")
    ap.add_argument("--outdir", default="build/convergence_out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("convergence_runs: CUDA is not available", file=sys.stderr)
        return 1
    table = runs(torch)
    unknown = [r for r in args.runs if r not in table]
    if unknown:
        ap.error(f"unknown runs {unknown}; choose from {sorted(table)}")
    os.makedirs(WORK, exist_ok=True)
    os.makedirs(args.outdir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    results_path = os.path.join(args.outdir, "results.json")
    results = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    failed = []
    for name in args.runs:
        log = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                result = table[name]()
            entry = dict(ok=True, result=result)
        except Exception:
            entry = dict(ok=False, error=traceback.format_exc())
            failed.append(name)
        entry.update(seconds=time.perf_counter() - t0, card=smi,
                     device=torch.cuda.get_device_name(0))
        results[name] = entry
        with open(os.path.join(args.outdir, f"{name}.log"), "w") as f:
            f.write(log.getvalue())
        print(json.dumps({"run": name, "ok": entry["ok"], "seconds": entry["seconds"]}),
              flush=True)
        if not entry["ok"]:
            print(entry["error"], file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1, default=str)
        for p in os.listdir(WORK):
            if p.endswith(".jsonl"):
                shutil.copy(os.path.join(WORK, p), args.outdir)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
