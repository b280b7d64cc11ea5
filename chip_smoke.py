#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one JSON line each; any failure exits nonzero before the last
line):

1. ``env``: the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``: nvcc builds every kernel in ``csrc/`` (all at once), and
   g++ the host TFRecord codec (``native/fastrecord.cc``).
3. ``kernels``: each kernel against its plain PyTorch version on the card,
   at a small shape and at the shape its path gives it (``hann_stitch`` on
   the engine's route, raw predictions with the window applied in the
   kernel, bit-equal, and on pre-weighted chips, at the solar, the change
   and the parking serving grids; ``fused_preprocess`` also
   with a NaN plane, negative and zero contrast and every flip/rotation,
   and at the parking preset's 16 x 512² x 4 chips, whose rows do not fit
   in shared memory: the kernel's streamed route; ``hann_stitch`` also at
   the swath's band shapes, the culled chips' predictions zero). ``ms``,
   ``plain_ms``
   and ``library_ms`` are on one clock: CUDA events around back-to-back
   calls, host overhead included. ``device_ms`` beside them is the
   kernel's own device time (``torch.profiler``). Then the card's bound.
4. ``slice``: the solar serving path at full ``SOLAR_CONFIG`` width — the
   ``predict`` CLI (k512 + b128, batch 16, hann, grid mode, bf16,
   space-to-depth stem, folded BN) on a 1920 x 1920 x 6 scene with seeded
   random weights, GeoTIFF out and read back — with every kernel's launch
   count taken over that run; then one chip's float32 forward on the card
   (TF32 off) against the CPU, and the warm scene time.
5. ``swath``: a 10980 x 2560 x 6 float32 GeoTIFF (a Sentinel-2 tile's
   height, 5 chips wide) with a nodata tag of 0 and a nodata edge (top
   2700 rows, left 640 columns) through the ``predict`` CLI read lazily,
   banded (``--max-rows 2688``), culled, written as a uint8 COG with
   predictor 2; ``hann_stitch`` launches against the bands holding a kept
   chip (from ``chip_validity``); the output's dtype, shape,
   georeferencing, no nodata tag (the JAX CLI writes none), overview and
   culled zeros; then the engine API banded + culled against one
   unbanded, unculled run on the valid pixels, with forwards counted and
   peak device memory.
6. ``sweep``: four 1920² x 6 ``.npy`` scenes (one half nodata) through
   ``predict sweep --prefetch 2 --nodata 0``, every output against
   ``engine.predict_scene``; the engine's pipelined ``predict_scenes``
   (readback) beside a serial ``predict_scene`` loop from host memory.
   ``whole``: ``--tile-mode whole`` on the slice's scene, its time and peak
   memory. ``patches``: an EE-style export (GZIP TFRecord patches +
   ``mixer.json``) through ``predict patches``.
7. ``train``: the solar training path at full ``SOLAR_CONFIG`` width —
   synthetic EE-schema GZIP TFRecords (6 bands, 256², bright squares on
   noise) -> ``get_training_dataset`` -> ``make_preprocess_fn(axes=(0,
   1))`` (the CUDA ``fused_preprocess``) -> ``Trainer`` (batch 64, S2D,
   bf16 autocast, weighted BCE on logits, Adam 9e-4, BN momentum 0.9)
   with eval and a best-metric ``CheckpointManager``, launch counts taken
   over that run; one float32 train step on the card (TF32 off) against
   the CPU from the same init and batch; warm step, preprocess and fed
   (host pipeline included) times; then the trained ``best`` checkpoint
   served through the ``predict`` CLI.
8. ``change_train``: the change-detection training path at full
   ``CHANGE_CONFIG`` width (the Siamese U-Net, filters 32/64/128, ASPP of
   256 per tower) — 64 before/after/label ``.npy`` chip triples from the
   seed through ``python -m satellite_computervision_tpu_torch.train
   --config change`` (``SiameseChipDataset``, batch 8, 256², bf16
   autocast, weighted BCE with pos_weight 4, Adam 9e-4, BN momentum
   0.99); the loss finite and ``best/model.pt`` of ``arch`` siamese; the
   warm step, chips/s and peak memory.
9. ``change``: a 2048 x 2048 x 4 float32 before/after pair (nodata in the
   left 512 columns of both, a changed block in the after scene) through
   ``predict change --nodata 0 --cog --uint8 --predictor 2`` on the
   trained checkpoint (k256 + b128, batch 8, hann, bf16), and again with
   ``--max-rows 1024``; ``hann_stitch`` launches against the count from
   the engine's grid and ``chip_validity``; the uint8 output's shape and
   culled zeros; one chip pair's float32 forward on the card against the
   CPU; the engine API banded + culled against one unbanded, unculled run
   on the valid pixels (float32 and bf16); CLI seconds, MPix/s of scene
   pairs and the forward's time per 8-chip batch.
10. ``parking_train``: the parking training path at full
   ``PARKING_CONFIG`` width (DeepLab v3+, ResNet-50 stages 3/4/6/3, ASPP
   of 256 at rates 6/12/18 with image pooling, R/G/B, one sigmoid class)
   through ``python -m satellite_computervision_tpu_torch.train --config
   parking --model deeplab`` on seeded EE-schema GZIP TFRecords of 512²
   chips (bright "lots" on noise): batch 16, bf16 autocast, weighted BCE
   with pos_weight 20, Adam 9e-4, 6 steps and 2 evals, the backbone
   warm-started by ``--torch-weights`` from a torchvision-layout ``.pth``
   written by ``export_torch_resnet_weights``; the loss finite,
   ``best/model.pt`` of ``arch`` deeplab; one step on the card against
   the CPU (the loss in float32, the gradients in float64); the warm step,
   chips/s and peak memory.
11. ``parking``: that checkpoint served over a 4096² x 3 float32 GeoTIFF
   through ``predict scene --config parking --model deeplab --cog --uint8
   --predictor 2`` (k512 + b256, batch 16, hann, bf16, BN unfolded):
   ``hann_stitch`` launched once, the output's shape, dtype,
   georeferencing and absent nodata tag, one chip's float32 forward on the
   card against the CPU, the forward per 16-chip batch; then ``--tune``
   (the table written with the card's name, read back by a serve without
   flags, which takes the winner) and ``python -m
   satellite_computervision_tpu_torch.evaluate`` on the eval TFRecords.
12. ``profile``: one warm scene, three warm train steps, five warm
   ``make_preprocess_fn`` calls, three warm change train steps, one warm
   change pair, one warm parking scene and three warm DeepLab train steps
   under ``torch.profiler``: device time by kernel, host time by op and
   the device's busy share.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result. Writes scratch files under ``build/chip_smoke/``.
"""

import copy
import glob
import gzip
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
SCENE = (1920, 1920, 6)
# a Sentinel-2 tile's full height at 10 m, a strip 5 chips wide; nodata
# (0) in the top rows and left columns, as at a swath edge
SWATH, SWATH_EDGE, SWATH_MAX_ROWS = (10980, 2560, 6), (2700, 640), 2688
SWEEP_SCENES = 4
TRAIN_STEPS, TRAIN_EPOCHS = 3, 2  # steps per epoch; an eval ends each epoch
# change detection: chip triples and steps of the training run; the
# served pair (nodata in the left columns of both) and its band height
CHANGE_CHIPS, CHANGE_STEPS = 64, 6
CHANGE_SCENE, CHANGE_EDGE, CHANGE_MAX_ROWS = (2048, 2048, 4), 512, 1024
# parking: TFRecord files x chips (512²) of the training run, plus one
# eval file of as many; steps per epoch and epochs (an eval ends each);
# the served scene (4096² x 3: a large part of a NAIP quarter-quad at 0.6 m)
PARKING_FILES, PARKING_CHIPS, PARKING_STEPS, PARKING_EPOCHS = 2, 16, 3, 2
PARKING_SCENE = (4096, 4096, 3)
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): bytes over the memory rate against float32
    operations over the peak float32 rate, whichever is larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def cuda_ms(fn, iters=200, warmup=20):
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls
    (CUDA events; warm, L2 not flushed). The long warm-up matters for a
    ~20 us kernel: the first calls' host time exceeds the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, name=None, calls=50):
    """Mean device milliseconds per call of ``fn`` under torch.profiler:
    of the kernels whose name holds ``name``, or of every device event
    (kernels, copies, memsets) when ``name`` is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and (name is None or name in e.key)]
    total = sum(e.device_time_total for e in events) / 1e3
    return total / calls if events else "not measured"


def sync(device="cuda"):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def wall_ms(fn, iters=10, device="cuda"):
    """Sorted host-clock milliseconds of ``iters`` warm calls, each ended
    by a device synchronize."""
    fn()
    sync(device)
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def fold_blend(preds, k, rows, cols, window, inv_w):
    """Library yardstick for hann_stitch on the engine's route: the window
    multiply, ``F.fold`` to overlap-add the chips, then the constant
    normalizer. Timed only; the port never calls it."""
    import torch.nn.functional as F

    weighted = preds * window[..., None]
    n, side, _, c = weighted.shape
    h, w = (rows - 1) * k + side, (cols - 1) * k + side
    folded = F.fold(weighted.permute(3, 1, 2, 0).reshape(1, c * side * side, n),
                    output_size=(h, w), kernel_size=side, stride=k)
    canvas = F.pad(folded, (0, (cols + 1) * k - w, 0, (rows + 1) * k - h))
    return canvas[0].permute(1, 2, 0) * inv_w[..., None]


def stitch_case(torch, stitch, k, buf, rows, cols, c_out, gen, timed, culled_rows=0):
    """hann_stitch on the card against its plain version: the engine's
    route (raw predictions, ``apply_window=True``: bit-equal) and the TPU
    kernel's (pre-weighted chips); the engine's route timed. The chips of
    the first ``culled_rows`` grid rows are zero, as culled chips reach the
    stitch."""
    side = k + buf
    preds = torch.rand((rows * cols, side, side, c_out), generator=gen)
    preds[: culled_rows * cols] = 0.0
    preds = preds.cuda()
    window = stitch.hann_window_2d(side, "cuda")
    weighted = (preds * window[..., None]).contiguous()
    got = stitch.hann_stitch(preds, k, rows, cols, apply_window=True)
    want = stitch.hann_stitch_reference(preds, k, rows, cols, apply_window=True)
    got_w = stitch.hann_stitch(weighted, k, rows, cols)
    want_w = stitch.hann_stitch_reference(weighted, k, rows, cols)
    torch.cuda.synchronize()
    out = dict(shape=[rows * cols, side, side, c_out], kernel=k, canvas=list(got.shape),
               max_abs_err=(got - want).abs().max().item(),
               weighted_max_abs_err=(got_w - want_w).abs().max().item())
    if timed:
        inv_w = torch.from_numpy(stitch.hann_inverse_weights(rows, cols, k, side)).cuda()
        lib = fold_blend(preds, k, rows, cols, window, inv_w)
        out["library_max_abs_err"] = (lib - want).abs().max().item()

        def kernel():
            stitch.hann_stitch(preds, k, rows, cols, apply_window=True)

        def library():
            fold_blend(preds, k, rows, cols, window, inv_w)

        out["ms"] = cuda_ms(kernel)
        out["device_ms"] = device_ms(kernel, "hann_stitch_kernel")
        out["plain_ms"] = cuda_ms(lambda: stitch.hann_stitch_reference(
            preds, k, rows, cols, apply_window=True), iters=10, warmup=2)
        out["library_ms"] = cuda_ms(library)
        out["library_device_ms"] = device_ms(library)
        # predictions, w1, wy, wx read once; the canvas written once
        n_in = preds.numel() + side + (rows + 1) * k + (cols + 1) * k
        n_out = got.numel()
        # per chip pixel the window (w1*w1, p*w) and its add; per output
        # wy*wx, max, the reciprocal and the scale
        out["bound_ms"], out["bound_by"] = bound((n_in + n_out) * 4,
                                                 3 * preds.numel() + 4 * n_out)
    return out


def nan_aware_err(torch, got, want):
    """Max |got - want| over the finite pairs; inf if the NaNs differ."""
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        return float("inf")
    both = ~torch.isnan(want)
    return (got[both] - want[both]).abs().max().item()


def preprocess_case(torch, pre, shape, n_color, augment, gen, timed, hard=False):
    """fused_preprocess on the card against its plain version on the same
    inputs (bands in [0, 0.8], as reflectances are). ``hard`` adds a NaN
    plane, a chip with negative contrast and one with zero contrast, and
    runs every rotation and flip over the chips."""
    b, k, _, c = shape
    bands = (torch.rand(shape, generator=gen) * 0.8).cuda()
    draws = (tuple(d.cuda() for d in pre.draw_augment_params(gen, b, n_color))
             if augment else (None, None, None))
    if hard:
        contra, bright, morph = draws
        bands[1, :, :, 2] = float("nan")
        contra[2] = -contra[2]
        contra[3, 0] = 0.0
        idx = torch.arange(b, device="cuda")
        draws = (contra, bright,
                 torch.stack([idx % 2, idx // 2 % 2, idx // 4 % 4], 1).to(torch.int32))
    got = pre.fused_preprocess(bands, n_color, *draws, augment=augment)
    want = pre.fused_preprocess_reference(bands, n_color, *draws, augment=augment)
    torch.cuda.synchronize()
    out = dict(shape=list(shape), n_color=n_color, augment=augment, hard=hard,
               max_abs_err=nan_aware_err(torch, got, want))
    if timed:
        def kernel():
            pre.fused_preprocess(bands, n_color, *draws, augment=augment)

        out["ms"] = cuda_ms(kernel)
        out["device_ms"] = device_ms(kernel, "fused_preprocess_kernel")
        out["plain_ms"] = cuda_ms(lambda: pre.fused_preprocess_reference(
            bands, n_color, *draws, augment=augment), iters=10, warmup=2)
        # each input read once, each output written once; the draws
        n_bytes = 2 * bands.numel() * 4 + (b * (2 * n_color + 3) * 4 if augment else 0)
        # per color element: the sum, the recolor's sub/mul/mul/add, min,
        # max, then the rescale's sub and div (without augment: the last 4)
        n_ops = b * k * k * n_color * (9 if augment else 4)
        out["bound_ms"], out["bound_by"] = bound(n_bytes, n_ops)
        out["library_ms"] = None
        out["library_note"] = ("no single PyTorch call computes recolor + per-channel "
                               "min/max rescale + per-chip flip/rot90")
    return out


def randomize_(model, gen):
    """Seeded He-normal conv weights and non-trivial BatchNorm state."""
    import torch

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if isinstance(mod, torch.nn.Conv2d) else \
                    w.shape[0] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.01)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                n = mod.num_features
                mod.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def synthesize_chips(path, n, bands, response, kernel, seed):
    """EE-schema GZIP TFRecord of ``n`` chips: bright squares ("solar
    arrays", label 1) on uniform noise, as examples/solar_end_to_end.py
    makes them, scaled to ``kernel``. gzip level 1 keeps the write short;
    readers see an ordinary GZIP stream."""
    from satellite_computervision_tpu_torch.data.tfrecord import TFRecordWriter, build_example

    rng = np.random.default_rng(seed)
    s = kernel // 64
    with gzip.open(path, "wb", compresslevel=1) as f, TFRecordWriter(f, None) as writer:
        for _ in range(n):
            chip = rng.uniform(0.05, 0.3, (len(bands), kernel, kernel)).astype(np.float32)
            label = np.zeros((kernel, kernel), np.float32)
            for _ in range(rng.integers(1, 4)):
                y, x = rng.integers(4 * s, kernel - 20 * s, 2)
                h, w = rng.integers(8 * s, 16 * s, 2)
                label[y:y + h, x:x + w] = 1.0
                chip[:, y:y + h, x:x + w] += 0.5
            ex = {b: chip[i].reshape(-1) for i, b in enumerate(bands)}
            ex[response] = label.reshape(-1)
            writer.write(build_example(ex))


def serve_through_cli(torch, predict, stitch, read_geotiff, ckpt, scene_path, out_path):
    """The ``predict`` CLI on the scene, with the kernels' launch counts
    set to 0 just before and read just after; checks the GeoTIFF."""
    stitch.hann_stitch.launches = 0
    t0 = time.perf_counter()
    predict.main(["scene", "--input", scene_path, "--ckpt", ckpt, "--config", "solar",
                  "--fold-bn", "--device", "cuda", "--output", out_path,
                  "--crs", "EPSG:32617", "--transform", "10", "0", "500000", "0", "-10",
                  "4500000"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {"hann_stitch": stitch.hann_stitch.launches}
    check(all(launches.values()), f"a kernel of the serving path never launched: {launches}")
    pred, meta = read_geotiff(out_path)
    check(pred.shape == SCENE[:2] + (1,), f"output shape {pred.shape}")
    check(np.isfinite(pred).all(), "non-finite output")
    check(pred.min() >= 0.0 and pred.max() <= 1.0, "probabilities outside [0, 1]")
    check(meta.get("crs") == "EPSG:32617", f"crs lost: {meta}")
    return pred, launches, cli_s


def run_cli(cli, argv):
    """``cli.main(argv)`` (the ``predict`` or ``train`` CLI), its standard
    output captured and echoed to standard error; returns (result, output
    text, seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = cli.main(argv)
    seconds = time.perf_counter() - t0
    print(buf.getvalue(), file=sys.stderr, end="", flush=True)
    return result, buf.getvalue(), seconds


def band_chip_rows(rows_total, max_rows, kernel, buffer):
    """Chip-row ranges [lo, hi) of the hann bands of a grid ``rows_total``
    chip rows tall: ``max_rows`` holds (max_rows - buffer) // kernel chip
    rows, one halo chip row on each interior side (the JAX engine's
    geometry, ``inference/tiles.py:803-808``)."""
    band_rows = (max_rows - buffer) // kernel
    step = max(1, band_rows - 2)
    out, r0 = [], 0
    while r0 < rows_total:
        rb = min(step, rows_total - r0)
        out.append((r0 - min(1, r0), r0 + rb + min(1, rows_total - r0 - rb)))
        r0 += rb
    return out


class CountingForward:
    """A predict_fn that counts the chips (batch rows) it is given."""

    def __init__(self, fn):
        self.fn, self.chips = fn, 0

    def __call__(self, chips):
        self.chips += chips.shape[0]
        return self.fn(chips)


def swath_phase(torch, predict, stitch, ckpt, work, shape, edge_rows, edge_cols, max_rows,
                geometry, extra_flags=(), seed=SEED, device="cuda"):
    """The swath path: a tall float32 GeoTIFF with a nodata tag of 0 and a
    nodata swath edge (top ``edge_rows`` rows, left ``edge_cols`` columns),
    served through the ``predict`` CLI banded, culled, as a uint8 COG, read
    lazily; then the engine API banded + culled against one unbanded,
    unculled run on the valid pixels, with peak device memory and forward
    counts. Returns (phase fields, hann_stitch launches of the CLI run)."""
    from satellite_computervision_tpu_torch.geo import GeoTiffScene, GeoTiffStreamWriter
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

    kernel, buffer, batch = geometry
    h, w, c = shape
    rng = np.random.default_rng(seed + 20)
    scene = rng.random(shape, dtype=np.float32) * np.float32(0.4)
    scene[:edge_rows] = 0.0
    scene[:, :edge_cols] = 0.0
    src = os.path.join(work, "swath.tif")
    tf = (10.0, 0.0, 600000.0, 0.0, -10.0, 4500000.0)
    t0 = time.perf_counter()
    with GeoTiffStreamWriter(src, h, w, c, np.float32, transform=tf, crs="EPSG:32617",
                             nodata=0.0, compress="none") as wr:
        for y in range(0, h, 2048):
            wr.write_rows(scene[y : y + 2048])
    write_s = time.perf_counter() - t0

    # what the run must do, from the whole-scene chip grid and its validity
    probe = TiledInferenceEngine(lambda x: x, kernel=kernel, buffer=buffer, nodata=0.0,
                                 device="cpu")
    valid = probe.chip_validity(scene)
    rows, cols = -(-h // kernel), -(-w // kernel)
    grid = valid.reshape(rows, cols)
    bands = band_chip_rows(rows, max_rows, kernel, buffer)
    kept_bands = sum(bool(grid[lo:hi].any()) for lo, hi in bands)

    out = os.path.join(work, "swath_pred.tif")
    stitch.hann_stitch.launches = 0
    stitch._device_axis_weights.cache_clear()
    _, text, cli_s = run_cli(predict, [
        "scene", "--input", src, "--ckpt", ckpt, "--config", "solar", "--fold-bn",
        "--output", out, "--max-rows", str(max_rows), "--nodata", "0", "--cog", "--uint8",
        "--predictor", "2", *extra_flags])
    if device == "cuda":
        torch.cuda.synchronize()
    launches = stitch.hann_stitch.launches
    weights_cache = stitch._device_axis_weights.cache_info()
    check(launches == kept_bands,
          f"hann_stitch launched {launches} times for {kept_bands} bands with a kept chip")
    check("streamed banded, cog" in text, "the swath was not streamed banded")

    res = GeoTiffScene(out)
    pred = np.asarray(res)
    check(res.dtype == np.uint8 and pred.shape == (h, w, 1), f"output {res.dtype} {pred.shape}")
    check("32617" in res.meta.get("crs", "") and tuple(res.meta["transform"]) == tf,
          f"georeferencing lost: {res.meta}")
    check(res.nodata is None, f"a nodata tag the JAX CLI does not write: {res.nodata}")
    over = GeoTiffScene(out, page=1)
    check(over.shape[:2] == (h // 2, w // 2), f"overview page {over.shape}")
    # pixels that only culled chips reach stay 0: above the first kept
    # chip row's window and left of the first kept column's
    half = buffer // 2
    r_min = int(np.flatnonzero(grid.any(1))[0])
    c_min = int(np.flatnonzero(grid.any(0))[0])
    zero_rows, zero_cols = max(0, r_min * kernel - half), max(0, c_min * kernel - half)
    check(not pred[:zero_rows].any() and not pred[:, :zero_cols].any(),
          "nonzero output where only culled chips reach")
    check(pred[zero_rows:, zero_cols:].any(), "no prediction on the valid part")

    # ---- the engine API: banded + culled against unbanded, unculled, with
    # the model served in bfloat16 (as the CLI serves it) and in float32
    # (TF32 off): a chip's bf16 prediction can change with its position in
    # a batch (measured below), which banding and culling change; float32
    # shows what banding and culling themselves do
    models = {"bfloat16": predict.load_model(ckpt, torch.device(device), fold_bn=True),
              "float32": predict.load_model(ckpt, torch.device("cpu"), fold_bn=True).to(device)}
    ok = torch.from_numpy((scene != 0).any(-1))
    runs, errs = {}, {}
    for dtype, served in models.items():
        for name, kw in (("unbanded", {}), ("banded", {"max_rows": max_rows}),
                         ("banded_culled", {"max_rows": max_rows, "nodata": 0.0})):
            fwd = CountingForward(lambda x, served=served: served(x)["probs"])
            engine = TiledInferenceEngine(fwd, kernel=kernel, buffer=buffer, batch_size=batch,
                                          blend="hann", device=device, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            prob = engine.predict_scene(scene).cpu()
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
            runs[dtype, name] = dict(prob=prob, chips=fwd.chips, seconds=seconds, peak_gib=peak)
        for name in ("banded", "banded_culled"):
            errs[dtype, name] = (runs[dtype, name]["prob"][ok]
                                 - runs[dtype, "unbanded"]["prob"][ok]).abs().max().item()
    # the same 16 chips in two orders: a chip's change with its batch slot
    rng_chips = np.random.default_rng(seed + 21)
    corners = [(int(y), int(x)) for y, x in zip(
        rng_chips.integers(edge_rows, h - kernel - buffer, batch),
        rng_chips.integers(edge_cols, w - kernel - buffer, batch))]
    chips = torch.stack([torch.from_numpy(scene[y : y + kernel + buffer, x : x + kernel + buffer])
                         for y, x in corners]).to(device)
    slot_err = {}
    with torch.inference_mode():
        for dtype, served in models.items():
            a = served(chips)["probs"].float()
            b = served(chips.roll(1, 0))["probs"].float().roll(-1, 0)
            slot_err[dtype] = (a - b).abs().max().item()
    check(errs["float32", "banded_culled"] <= 1e-3,
          "banded + culled disagrees with unbanded on valid pixels (float32): "
          f"{errs['float32', 'banded_culled']}")
    # bf16 carries 8 bits of mantissa (eps 7.8e-3)
    check(errs["bfloat16", "banded_culled"] <= 1e-2,
          "banded + culled disagrees with unbanded on valid pixels (bfloat16): "
          f"{errs['bfloat16', 'banded_culled']}")
    if device == "cuda":
        check(runs["bfloat16", "banded_culled"]["peak_gib"]
              < runs["bfloat16", "unbanded"]["peak_gib"],
              "banding did not lower the peak device memory")
    mpix = h * w / 1e6
    fields = dict(
        scene=list(shape), nodata_rows=edge_rows, nodata_cols=edge_cols, max_rows=max_rows,
        geometry=list(geometry), bands=len(bands), band_chip_rows=bands,
        bands_with_kept_chip=kept_bands, kept_chips=int(valid.sum()), total_chips=valid.size,
        launches=launches, axis_weight_cache=weights_cache._asdict(),
        input_write_seconds=write_s, cli_seconds=cli_s, cli_mpix_per_s=mpix / cli_s,
        output_dtype=str(res.dtype), output_shape=list(pred.shape), output_max=int(pred.max()),
        zero_rows=zero_rows, zero_cols=zero_cols,
        max_abs_err_vs_unbanded_on_valid={f"{d}/{n}": e for (d, n), e in errs.items()},
        batch_slot_max_abs_err=slot_err,
        api={f"{d}/{n}": {k: v for k, v in r.items() if k != "prob"}
             for (d, n), r in runs.items()},
        halo_forward_overhead=(runs["bfloat16", "banded"]["chips"]
                               / runs["bfloat16", "unbanded"]["chips"]))
    return fields, launches


def sweep_phase(torch, predict, stitch, ckpt, work, shape, n_scenes, geometry,
                extra_flags=(), seed=SEED, device="cuda"):
    """The sweep path: ``n_scenes`` .npy scenes (the second one half
    nodata) through ``predict sweep --prefetch 2 --nodata 0``; every output
    against ``engine.predict_scene`` of the same scene; then the engine's
    pipelined ``predict_scenes(readback=True)`` beside a serial loop of
    ``predict_scene`` from host memory. Returns (fields, launches)."""
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

    kernel, buffer, batch = geometry
    rng = np.random.default_rng(seed + 30)
    indir = os.path.join(work, "sweep_in")
    os.makedirs(indir, exist_ok=True)
    scenes = []
    for i in range(n_scenes):
        scene = rng.random(shape, dtype=np.float32) * np.float32(0.4)
        if i == 1:
            scene[:, : shape[1] // 2] = 0.0
        scenes.append(scene)
        np.save(os.path.join(indir, f"scene{i}.npy"), scene)
    outdir = os.path.join(work, "sweep_out")
    stitch.hann_stitch.launches = 0
    written, text, cli_s = run_cli(predict, [
        "sweep", "--input", indir, "--ckpt", ckpt, "--config", "solar", "--fold-bn",
        "--outdir", outdir, "--prefetch", "2", "--nodata", "0", *extra_flags])
    launches = stitch.hann_stitch.launches
    check(launches == n_scenes, f"hann_stitch launched {launches} times for {n_scenes} scenes")
    cli_mpix_s = float(text.rsplit("(", 1)[1].split(" MPix/s")[0])

    served = predict.load_model(ckpt, torch.device(device), fold_bn=True)
    engine = TiledInferenceEngine(lambda x: served(x)["probs"], kernel=kernel, buffer=buffer,
                                  batch_size=batch, blend="hann", nodata=0.0, device=device)
    errs = []
    for path, scene in zip(written, scenes):
        got, _ = read_geotiff(path)
        want = engine.predict_scene(scene).cpu().numpy()
        check(got.shape == want.shape and np.isfinite(got).all(), f"sweep output {path}")
        errs.append(float(np.abs(got - want).max()))
    check(max(errs) <= 1e-6, f"sweep output disagrees with predict_scene: {errs}")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def pipelined():
        return list(engine.predict_scenes(iter(scenes), prefetch=2, readback=True))

    def serial():
        return [engine.predict_scene(s).cpu().numpy() for s in scenes]

    times = {}
    for name, fn in (("pipelined", pipelined), ("serial", serial)):
        fn()  # warm
        sync()
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            sync()
            samples.append(time.perf_counter() - t0)
        times[name] = sorted(samples)
    mpix = n_scenes * shape[0] * shape[1] / 1e6
    fields = dict(scenes=n_scenes, scene=list(shape), half_nodata_scene=1, prefetch=2,
                  launches=launches, cli_seconds=cli_s, cli_mpix_per_s=cli_mpix_s,
                  max_abs_err_vs_predict_scene=errs,
                  pipelined_seconds=times["pipelined"], serial_seconds=times["serial"],
                  pipelined_mpix_per_s=mpix / median(times["pipelined"]),
                  serial_mpix_per_s=mpix / median(times["serial"]))
    return fields, launches


def whole_phase(torch, predict, ckpt, work, scene_path, geometry, extra_flags=(),
                device="cuda"):
    """``--tile-mode whole`` on the slice's scene through the CLI, then the
    engine's warm whole-scene time and peak device memory."""
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine

    out = os.path.join(work, "pred_whole.tif")
    _, text, cli_s = run_cli(predict, [
        "scene", "--input", scene_path, "--ckpt", ckpt, "--config", "solar", "--fold-bn",
        "--tile-mode", "whole", "--output", out, *extra_flags])
    pred, _ = read_geotiff(out)
    check(np.isfinite(pred).all() and pred.min() >= 0.0 and pred.max() <= 1.0,
          "whole-mode output not finite in [0, 1]")
    served = predict.load_model(ckpt, torch.device(device), fold_bn=True)
    engine = TiledInferenceEngine(lambda x: served(x)["probs"], kernel=geometry[0],
                                  buffer=geometry[1], tile_mode="whole", whole_multiple=64,
                                  device=device)
    scene = np.load(scene_path)
    peak = None
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: engine.predict_scene(scene), iters=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
    else:
        t0 = time.perf_counter()
        engine.predict_scene(scene)
        ms = [(time.perf_counter() - t0) * 1e3]
    h, w = scene.shape[:2]
    pad = [h + geometry[1] + (-(h + geometry[1])) % 64, w + geometry[1] + (-(w + geometry[1])) % 64]
    return dict(scene=list(scene.shape), padded_to=pad, cli_seconds=cli_s,
                output_min=float(pred.min()), output_max=float(pred.max()),
                scene_ms_host_input=ms, scene_ms=median(ms), peak_mem_gib=peak)


def patches_phase(torch, predict, ckpt, work, n_files, per_file, extra_flags=(), seed=SEED):
    """An EE-style export (GZIP TFRecord patches of kernel + buffer, plus
    mixer.json) through ``predict patches``; checks the count and shape of
    the prediction records."""
    from satellite_computervision_tpu_torch.data.tfrecord import read_tfrecord_file
    from satellite_computervision_tpu_torch.inference.mixer import MixerInfo, write_mixer
    from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG as cfg

    export = os.path.join(work, "export")
    os.makedirs(export, exist_ok=True)
    side = cfg.kernel_size + cfg.kernel_buffer
    t0 = time.perf_counter()
    for i in range(n_files):
        synthesize_chips(os.path.join(export, f"solar-{i:05d}.tfrecord.gz"), per_file,
                         list(cfg.bands), cfg.response, side, seed + 40 + i)
    n = n_files * per_file
    write_mixer(os.path.join(export, "mixer.json"),
                MixerInfo(n, n_files, (cfg.kernel_size, cfg.kernel_size),
                          (10.0, 0.0, 600000.0, 0.0, -10.0, 4500000.0), "EPSG:32617"))
    synth_s = time.perf_counter() - t0
    written, text, cli_s = run_cli(predict, [
        "patches", "--input", export, "--ckpt", ckpt, "--config", "solar", "--fold-bn",
        "--outdir", os.path.join(work, "patch_preds"), "--base", "solar", *extra_flags])
    check(len(written) == 1, f"expected one prediction file, got {written}")
    records = read_tfrecord_file(written[0], compression=None)
    check(len(records) == n, f"{len(records)} prediction records for {n} patches")
    vals = np.concatenate([np.asarray(r["b1"]) for r in records])
    check(all(set(r) == {"b1"} and len(r["b1"]) == cfg.kernel_size ** 2 for r in records),
          "prediction records of the wrong shape")
    check(np.isfinite(vals).all() and vals.min() >= 0.0 and vals.max() <= 1.0,
          "patch predictions not finite in [0, 1]")
    return dict(files=n_files, patches=n, patch_side=side, synth_seconds=synth_s,
                cli_seconds=cli_s, records=len(records),
                record_len=cfg.kernel_size ** 2, mixer=f"mixer: {n} patches" in text)


def device_profile(torch, fn, calls=1):
    """(wall ms, device ms, busy share, top kernels, top host ops) of
    ``calls`` calls of ``fn`` under torch.profiler; device-side events only
    for the device (kernels, copies, memsets; not the ranges that annotate
    them, such as the optimizer step's). One stream does the work, so their
    sum over the wall time is the device's busy share. Host ops are ranked
    by their own (self) CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    dev.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    return dict(wall_ms=wall, device_ms=busy if dev else "not measured",
                device_busy_share=busy / wall if dev else "not measured",
                top=[{"name": n[:90], "ms": ms, "count": c} for n, ms, c in dev[:12]],
                host_top=[{"name": n[:90], "self_ms": ms, "count": c}
                          for n, ms, c in host[:12]])


def train_phase(torch, work, gen):
    """The solar training path at full width, then its checkpoint served.
    Returns (phase fields, launches, warm train step callable)."""
    from satellite_computervision_tpu_torch import predict
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        get_training_dataset,
        make_preprocess_fn,
    )
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.kernels import preprocess as pre
    from satellite_computervision_tpu_torch.kernels import stitch
    from satellite_computervision_tpu_torch.models import unet_solar
    from satellite_computervision_tpu_torch.models.unet import flax_init_
    from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager
    from satellite_computervision_tpu_torch.train.config import SOLAR_CONFIG as cfg
    from satellite_computervision_tpu_torch.train.trainer import (
        Trainer,
        create_train_state,
        make_train_step,
    )
    from satellite_computervision_tpu_torch.train.zoo import get_family

    k, batch, bands = cfg.kernel_size, cfg.train_batch, list(cfg.bands)
    names = bands + [cfg.response]
    data = os.path.join(work, "tfrecords")
    os.makedirs(data, exist_ok=True)
    t0 = time.perf_counter()
    train_files = [os.path.join(data, f"train-{i}.tfrecord.gz") for i in range(2)]
    eval_files = [os.path.join(data, "eval-0.tfrecord.gz")]
    for i, path in enumerate(train_files + eval_files):
        synthesize_chips(path, batch, bands, cfg.response, k, SEED + 10 + i)
    synth_s = time.perf_counter() - t0

    model_kw = dict(in_channels=len(bands), space_to_depth=True, bn_momentum=0.9)
    model = flax_init_(unet_solar(**model_kw), torch.Generator().manual_seed(SEED))
    init_state = copy.deepcopy(model.state_dict())
    model = model.to("cuda", memory_format=torch.channels_last)
    loss_fn, pred_key = get_family(cfg.family).loss(cfg)  # weighted BCE on logits
    ckpt = os.path.join(work, "train_ckpt")
    trainer = Trainer(create_train_state(model, cfg.learning_rate), loss_fn, pred_key=pred_key,
                      num_classes=2, monitor=cfg.monitor,
                      checkpoint_manager=CheckpointManager(ckpt), compute_dtype=torch.bfloat16)
    train_it = get_training_dataset(train_files, names, kernel_size=k, batch_size=batch,
                                    shuffle_buffer=batch, seed=SEED, device="cuda")
    preprocess = make_preprocess_fn(bands, cfg.response, axes=(0, 1), device="cuda")
    check(preprocess.fused, "axes=(0, 1) must take the fused_preprocess route")
    draw_gen = torch.Generator().manual_seed(SEED + 1)

    def train_batches():
        for raw in train_it:
            yield preprocess(raw, draw_gen, train=True)

    def eval_batches():
        for raw in get_eval_dataset(eval_files, names, kernel_size=k, batch_size=batch,
                                    device="cuda"):
            yield preprocess(raw, train=False)

    # ---- warm device-side times on one batch already on the card, taken
    # while no decode thread runs (the eval file is one batch, its reader
    # ends after it)
    torch.cuda.reset_peak_memory_stats()
    raw = next(iter(get_eval_dataset(eval_files, names, kernel_size=k, batch_size=batch,
                                     device="cuda")))
    x, y = preprocess(raw, draw_gen, train=True)
    step_ms = wall_ms(lambda: trainer.train_step(trainer.state, (x, y)))
    pre_ms = wall_ms(lambda: preprocess(raw, draw_gen, train=True))
    med_step, med_pre = median(step_ms), median(pre_ms)
    chips_per_s = batch / ((med_step + med_pre) / 1e3)

    # ---- the path, with the launch counts taken over it
    batches = train_batches()
    pre.fused_preprocess.launches = 0
    t0 = time.perf_counter()
    history = trainer.fit(batches, epochs=TRAIN_EPOCHS, steps_per_epoch=TRAIN_STEPS,
                          eval_fn=eval_batches, log_fn=lambda r: None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"fused_preprocess": pre.fused_preprocess.launches}
    check(all(launches.values()), f"a kernel of the training path never launched: {launches}")
    losses = [r[part]["loss"] for r in history for part in ("train", "val")]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(any(r.get("checkpointed") for r in history), "no best checkpoint was kept")
    check(os.path.exists(os.path.join(ckpt, "best", "model.pt")), "best/model.pt missing")

    # ---- fed throughput: decode + H2D + preprocess + step, warm
    n_fed = 6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_fed):
        out = trainer.train_step(trainer.state, next(batches))
    float(out["loss"])
    fed_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # ---- one float32 step on the card (TF32 off) against the CPU: same
    # init, the first 4 chips of a preprocessed batch
    x4, y4 = x[:4].float().cpu(), y[:4].float().cpu()
    f32_step = make_train_step(loss_fn, pred_key)
    results = []
    for device in ("cpu", "cuda"):
        ref = unet_solar(**model_kw)
        ref.load_state_dict(init_state)
        state = create_train_state(ref.to(device), cfg.learning_rate)
        loss = float(f32_step(state, (x4.to(device), y4.to(device)))["loss"])
        results.append((loss, {n: p.grad.detach().cpu() for n, p in ref.named_parameters()}))
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = results
    g_scale = max(g.abs().max().item() for g in cpu_g.values())
    grad_err = max((gpu_g[n] - g).abs().max().item() for n, g in cpu_g.items()) / g_scale
    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    # float32 on two devices with other conv algorithms, ~40 layers deep,
    # train-mode BN over 4 chips
    check(loss_rel <= 1e-4, f"f32 card train loss disagrees with the CPU: {loss_rel}")
    check(grad_err <= 1e-3, f"f32 card gradients disagree with the CPU: {grad_err}")

    # ---- serve the trained checkpoint through the predict CLI
    scene_path = os.path.join(work, "scene.npy")
    _, serve_launches, serve_s = serve_through_cli(
        torch, predict, stitch, read_geotiff, ckpt, scene_path,
        os.path.join(work, "pred_trained.tif"))

    fields = dict(
        config="solar", chips=[batch, k, k, len(bands)], steps_total=trainer.state.step,
        fit_steps=TRAIN_EPOCHS * TRAIN_STEPS, evals=TRAIN_EPOCHS, dtype="bfloat16 autocast",
        space_to_depth=True, bn_momentum=0.9, lr=cfg.learning_rate,
        pos_weight=cfg.loss_kwargs.get("pos_weight", 1.0), launches=launches,
        history=history, synth_seconds=synth_s, fit_seconds=fit_s,
        f32_card_vs_cpu_loss=[gpu_loss, cpu_loss], f32_loss_rel_err=loss_rel,
        f32_grad_max_abs_err_over_max_grad=grad_err,
        step_ms=step_ms, step_ms_median=med_step,
        preprocess_ms=pre_ms, preprocess_ms_median=med_pre,
        preprocess_share=med_pre / (med_pre + med_step),
        chips_per_s=chips_per_s, mpix_per_s=chips_per_s * k * k / 1e6,
        fed_chips_per_s=n_fed * batch / fed_s,
        fed_mpix_per_s=n_fed * batch * k * k / 1e6 / fed_s,
        peak_mem_gib=peak_gib, serve_launches=serve_launches, serve_cli_seconds=serve_s)
    return (fields, launches, lambda: trainer.train_step(trainer.state, (x, y)),
            lambda: preprocess(raw, draw_gen, train=True))


def synthesize_change_chips(root, n, bands, side, seed):
    """``n`` before/after/label ``.npy`` chip triples under ``root``
    (``before/``, ``after/``, ``label/``): bands x side² float32
    reflectances in [0, 10000] (a per-band level plus noise), labels
    1 x side² uint8 in {0, 1, 2}; the after chip carries a changed block
    (bright, re-drawn) where the label is 2. Returns the three globs."""
    rng = np.random.default_rng(seed)
    dirs = {name: os.path.join(root, name) for name in ("before", "after", "label")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n):
        level = rng.uniform(500.0, 3000.0, (bands, 1, 1))
        before = np.clip(level + rng.normal(0.0, 300.0, (bands, side, side)), 0, 10000)
        after = np.clip(before + rng.normal(0.0, 100.0, before.shape), 0, 10000)
        label = np.zeros((1, side, side), np.uint8)
        y, x = rng.integers(0, side // 2, 2)
        label[:, y : y + side // 8, x : x + side // 8] = 1  # an unchanged class
        y, x = rng.integers(0, side // 2, 2)
        hh, ww = rng.integers(side // 8, side // 3, 2)
        label[:, y : y + hh, x : x + ww] = 2
        after[:, y : y + hh, x : x + ww] = rng.uniform(6000.0, 10000.0, (bands, hh, ww))
        for name, arr in (("before", before.astype(np.float32)),
                          ("after", after.astype(np.float32)), ("label", label)):
            np.save(os.path.join(dirs[name], f"{name}_{i:03d}.npy"), arr)
    return [os.path.join(d, "*.npy") for d in dirs.values()]


def change_train_phase(torch, work, n_chips, side, batch, steps, extra_flags=(), seed=SEED,
                       device="cuda"):
    """The change-detection training path through the train CLI
    (``--config change``, ``batch`` chips a step) on ``n_chips`` synthetic
    chip triples of ``side``², then the warm train step on one batch of the
    same dataset. Returns (phase fields, checkpoint directory, a warm train
    step)."""
    from satellite_computervision_tpu_torch.data.chip_generators import SiameseChipDataset
    from satellite_computervision_tpu_torch.train import __main__ as train_cli

    cfg = train_cli.CONFIGS["change"]
    t0 = time.perf_counter()
    globs = synthesize_change_chips(os.path.join(work, "change_chips"), n_chips,
                                    len(cfg.bands), side, seed + 60)
    synth_s = time.perf_counter() - t0
    ckpt = os.path.join(work, "change_ckpt")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer, _, cli_s = run_cli(train_cli, [
        "--config", "change", "--before", globs[0], "--after", globs[1], "--labels", globs[2],
        "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", str(steps),
        "--batch-size", str(batch), *extra_flags])
    sync(device)
    losses = [r["train"]["loss"] for r in trainer.history]
    check(trainer.state.step == steps, f"{trainer.state.step} steps for {steps}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    blob = torch.load(os.path.join(ckpt, "best", "model.pt"), map_location="cpu",
                      weights_only=True)
    check(blob.get("arch") == "siamese", f"best/model.pt arch {blob.get('arch')!r}")

    # the warm step on one batch of the dataset, already on the device
    tile, _ = cfg.training_geometry
    ds = SiameseChipDataset(*(sorted(glob.glob(g)) for g in globs), batch_size=batch,
                            unet_dim=(tile, tile), seed=seed)
    (xb, xa), y = ds[0]
    x = [torch.from_numpy(xb).to(device), torch.from_numpy(xa).to(device)]
    y = torch.from_numpy(y).to(device)

    def step():
        trainer.train_step(trainer.state, (x, y))

    step_ms = wall_ms(step, device=device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    med = median(step_ms)
    fields = dict(
        config="change", chips=n_chips, batch=[batch, tile, tile, len(cfg.bands)], steps=steps,
        dtype="bfloat16 autocast" if device == "cuda" and "--no-bf16" not in extra_flags
        else "float32", arch=blob["arch"], model_kwargs=blob["model_kwargs"],
        pos_weight=cfg.loss_kwargs.get("pos_weight", 1.0), lr=cfg.learning_rate,
        history=trainer.history, synth_seconds=synth_s, cli_seconds=cli_s,
        step_ms=step_ms, step_ms_median=med, chips_per_s=batch / (med / 1e3),
        mpix_per_s=batch * tile * tile / 1e6 / (med / 1e3),
        cli_chips_per_s=steps * batch / cli_s, peak_mem_gib=peak)
    return fields, ckpt, step


def change_phase(torch, predict, stitch, ckpt, work, shape, edge_cols, max_rows, geometry,
                 extra_flags=(), seed=SEED, device="cuda"):
    """The change path: a before/after pair (nodata in the left
    ``edge_cols`` columns of both, a changed block in the after scene)
    through ``predict change`` as a uint8 COG, unbanded and with
    ``--max-rows``; launches against the counts from the engine's grid and
    ``chip_validity``; one chip pair's float32 forward on the card against
    the CPU; the engine API banded + culled against unbanded, unculled on
    the valid pixels. Returns (fields, launches by path, a warm call of the
    served engine)."""
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.train.config import CONFIGS

    cfg = CONFIGS["change"]
    kernel, buffer, batch = geometry
    h, w, c = shape
    rng = np.random.default_rng(seed + 70)
    before = (rng.uniform(0.05, 0.3, (1, 1, c))
              + rng.normal(0.0, 0.03, shape)).astype(np.float32)
    after = before + rng.normal(0.0, 0.01, shape).astype(np.float32)
    after[h // 4 : h // 2, w // 2 : 3 * w // 4] = 0.8  # the change
    before[:, :edge_cols] = 0.0
    after[:, :edge_cols] = 0.0
    paths = [os.path.join(work, f"change_{n}.npy") for n in ("before", "after")]
    np.save(paths[0], before)
    np.save(paths[1], after)
    stack = np.concatenate([before, after], axis=-1)

    # what the runs must launch, from the chip grid and its validity
    probe = TiledInferenceEngine(lambda x: x, kernel=kernel, buffer=buffer, nodata=0.0,
                                 device="cpu")
    valid = probe.chip_validity(stack)
    rows, cols = -(-h // kernel), -(-w // kernel)
    grid = valid.reshape(rows, cols)
    bands = band_chip_rows(rows, max_rows, kernel, buffer)
    expected = {"change": int(grid.any()),
                "change_banded": sum(bool(grid[lo:hi].any()) for lo, hi in bands)}

    outs, launches, cli_s = {}, {}, {}
    for name, flags in (("change", []), ("change_banded", ["--max-rows", str(max_rows)])):
        outs[name] = os.path.join(work, f"{name}.tif")
        stitch.hann_stitch.launches = 0
        _, text, cli_s[name] = run_cli(predict, [
            "change", "--config", "change", "--input-before", paths[0], "--input-after",
            paths[1], "--ckpt", ckpt, "--nodata", "0", "--cog", "--uint8", "--predictor", "2",
            "--output", outs[name], *flags, *extra_flags])
        sync(device)
        launches[name] = stitch.hann_stitch.launches
        check(launches[name] == expected[name],
              f"{name}: hann_stitch launched {launches[name]} times, expected {expected[name]}")
    pred, meta = read_geotiff(outs["change"])
    banded_pred, _ = read_geotiff(outs["change_banded"])
    check(pred.dtype == np.uint8 and pred.shape == (h, w, 1), f"output {pred.dtype} {pred.shape}")
    half = buffer // 2
    c_min = int(np.flatnonzero(grid.any(0))[0])
    zero_cols = max(0, c_min * kernel - half)
    check(not pred[:, :zero_cols].any(), "nonzero output where only culled chips reach")
    check(pred[:, zero_cols:].any(), "no prediction on the valid part")
    ok = (stack != 0).any(-1)
    # bf16 probabilities within 1e-2 move a uint8 (x255, truncated) by <= 3
    uint8_err = int(np.abs(pred[ok].astype(int) - banded_pred[ok].astype(int)).max())
    check(uint8_err <= 3, f"banded CLI output disagrees with unbanded: {uint8_err}")

    # ---- the engine API: banded + culled against unbanded, unculled, in
    # the served bf16 and in float32 (TF32 off)
    load = dict(cfg=cfg, arch="siamese")
    models = {"bfloat16": predict.load_model(ckpt, torch.device(device), **load),
              "float32": predict.load_model(ckpt, torch.device("cpu"), **load).to(device)}
    nb = c
    runs, errs = {}, {}
    for dtype, served in models.items():
        def fwd(chips, served=served):
            return served(chips[..., :nb], chips[..., nb:])["probs"]

        for name, kw in (("unbanded", {}), ("banded_culled", {"max_rows": max_rows,
                                                               "nodata": 0.0})):
            engine = TiledInferenceEngine(fwd, kernel=kernel, buffer=buffer, batch_size=batch,
                                          blend="hann", device=device, **kw)
            sync(device)
            t0 = time.perf_counter()
            prob = engine.predict_scene(stack).cpu()
            runs[dtype, name] = dict(prob=prob, seconds=time.perf_counter() - t0)
        errs[dtype] = (runs[dtype, "banded_culled"]["prob"][torch.from_numpy(ok)]
                       - runs[dtype, "unbanded"]["prob"][torch.from_numpy(ok)]).abs().max().item()
    check(errs["float32"] <= 1e-3,
          f"banded + culled disagrees with unbanded on valid pixels (float32): {errs['float32']}")
    check(errs["bfloat16"] <= 1e-2,
          f"banded + culled disagrees with unbanded on valid pixels (bfloat16): {errs['bfloat16']}")

    # ---- one chip pair, float32, card (TF32 off) against the CPU
    side = kernel + buffer
    x0 = min(w - side, edge_cols)
    pair = [torch.from_numpy(np.ascontiguousarray(a[:side, x0 : x0 + side]))[None]
            for a in (before, after)]
    cpu_model = predict.load_model(ckpt, torch.device("cpu"), **load)
    with torch.inference_mode():
        cpu_logits = cpu_model(*pair)["logits"]
        dev_logits = models["float32"](*(t.to(device) for t in pair))["logits"].cpu()
    logit_err = (dev_logits - cpu_logits).abs().max().item()
    logit_scale = cpu_logits.abs().max().item()
    check(logit_err <= 1e-4 * max(logit_scale, 1.0),
          f"f32 card forward disagrees with the CPU: {logit_err} (scale {logit_scale})")

    # ---- warm times: one forward of a full chip batch, one served scene
    served = models["bfloat16"]
    gen = torch.Generator().manual_seed(seed + 71)
    chips = [(torch.rand((batch, side, side, c), generator=gen) * 0.3).to(device)
             for _ in range(2)]
    engine = TiledInferenceEngine(lambda x: served(x[..., :nb], x[..., nb:])["probs"],
                                  kernel=kernel, buffer=buffer, batch_size=batch, blend="hann",
                                  nodata=0.0, device=device)
    stack_dev = torch.from_numpy(stack).to(device)

    def run_scene():
        engine.predict_scene(stack_dev, valid_chips=valid)

    with torch.inference_mode():
        fwd_ms = wall_ms(lambda: served(*chips), iters=10, device=device)
    scene_ms = wall_ms(run_scene, iters=5, device=device)
    mpix = h * w / 1e6
    fields = dict(
        config="change", scene=list(shape), pair_bands=2 * c, nodata_cols=edge_cols,
        geometry=list(geometry), grid=[rows, cols], kept_chips=int(valid.sum()),
        total_chips=valid.size, max_rows=max_rows, band_chip_rows=bands,
        launches=launches, expected_launches=expected,
        cli_seconds=cli_s, cli_mpix_per_s={k: mpix / v for k, v in cli_s.items()},
        output_dtype=str(pred.dtype), output_shape=list(pred.shape),
        output_max=int(pred.max()), zero_cols=zero_cols, crs=meta.get("crs", ""),
        banded_cli_max_uint8_err_on_valid=uint8_err,
        max_abs_err_banded_culled_vs_unbanded_on_valid=errs,
        api_seconds={f"{d}/{n}": r["seconds"] for (d, n), r in runs.items()},
        f32_card_vs_cpu_max_abs_logit_err=logit_err, f32_logit_scale=logit_scale,
        forward_ms_per_batch=fwd_ms, forward_ms_per_batch_median=median(fwd_ms),
        scene_ms_device_input=scene_ms, scene_ms=median(scene_ms),
        mpix_per_s_device_input=mpix / (median(scene_ms) / 1e3))
    return fields, launches, run_scene


def parking_train_phase(torch, work, n_files, per_file, batch, steps, epochs, extra_flags=(),
                        seed=SEED, device="cuda"):
    """The parking training path through the train CLI (``--config
    parking --model deeplab``) on synthetic EE-schema TFRecords of
    ``n_files`` x ``per_file`` chips plus one eval file of ``per_file``,
    warm-started by ``--torch-weights`` from a torchvision-layout ``.pth``
    that ``export_torch_resnet_weights`` wrote from a seeded model; one
    step on ``device`` (TF32 off) against the CPU from the same weights
    and batch, in float32 (the loss) and float64 (the gradients); the warm
    step. Returns (fields, checkpoint, eval
    glob, a warm train step)."""
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        make_preprocess_fn,
    )
    from satellite_computervision_tpu_torch.models.deeplab import (
        export_torch_resnet_weights,
        torchvision_keys,
    )
    from satellite_computervision_tpu_torch.models.unet import flax_init_
    from satellite_computervision_tpu_torch.train import __main__ as train_cli
    from satellite_computervision_tpu_torch.train.checkpoint import build_empty
    from satellite_computervision_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )
    from satellite_computervision_tpu_torch.train.zoo import get_family

    cfg = train_cli.CONFIGS["parking"]
    k, bands = cfg.kernel_size, list(cfg.bands)
    names = bands + [cfg.response]
    data = os.path.join(work, "parking_tfrecords")
    os.makedirs(data, exist_ok=True)
    t0 = time.perf_counter()
    train_files = [os.path.join(data, f"train-{i}.tfrecord.gz") for i in range(n_files)]
    eval_file = os.path.join(data, "eval-0.tfrecord.gz")
    for i, path in enumerate(train_files + [eval_file]):
        synthesize_chips(path, per_file, bands, cfg.response, k, seed + 80 + i)
    synth_s = time.perf_counter() - t0

    # a "pretrained" backbone: a seeded model's, written as torchvision writes it
    family = get_family("deeplab")
    donor = flax_init_(family.build(cfg), torch.Generator().manual_seed(seed + 90))
    pth = os.path.join(work, "resnet_backbone.pth")
    exported = export_torch_resnet_weights(donor, pth)
    n_backbone = len(torchvision_keys(donor))

    ckpt = os.path.join(work, "parking_ckpt")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    lr = cfg.learning_rate
    trainer, text, cli_s = run_cli(train_cli, [
        "--config", "parking", "--model", "deeplab", "--train", os.path.join(data, "train-*"),
        "--eval", eval_file, "--ckpt", ckpt, "--epochs", str(epochs), "--steps-per-epoch",
        str(steps), "--batch-size", str(batch), "--torch-weights", pth, *extra_flags])
    sync(device)
    check(f"({n_backbone} tensors)" in text,
          f"--torch-weights did not load the {n_backbone} backbone tensors")
    check(trainer.state.step == steps * epochs, f"{trainer.state.step} steps")
    losses = [r[part]["loss"] for r in trainer.history for part in ("train", "val")]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    blob = torch.load(os.path.join(ckpt, "best", "model.pt"), map_location="cpu",
                      weights_only=True)
    check(blob.get("arch") == "deeplab", f"best/model.pt arch {blob.get('arch')!r}")
    model = trainer.state.model
    # Adam moves a weight by at most a few lr a step: the trained stem is
    # the exported one plus the run's updates
    stem_moved = (model.backbone.stem_conv.weight.detach().float().cpu()
                  - exported["conv1.weight"]).abs().max().item()
    check(stem_moved <= 4 * lr * steps * epochs,
          f"the stem moved {stem_moved} from the warm-start weights")

    # ---- one step on the device (TF32 off) against the CPU: the trained
    # weights, the top-left 256² of the eval file's first 2 chips. In
    # float32 the loss is held; the gradients are held in float64, because
    # in float32 they stray by up to ~1e-2 x max|grad| on either device:
    # a ReLU input within rounding of 0 passes or stops a gradient term,
    # and the image-pooling BN normalizes 2 values per channel
    preprocess = make_preprocess_fn(bands, cfg.response, axes=cfg.axes, splits=cfg.splits,
                                    device=device)
    raw = next(iter(get_eval_dataset([eval_file], names, kernel_size=k, batch_size=batch,
                                     device=device)))
    x, y = preprocess(raw, train=False)
    side = min(k, 256)
    x2, y2 = x[:2, :side, :side].float().cpu(), y[:2, :side, :side].float().cpu()
    state = {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}
    loss_fn, pred_key = family.loss(cfg)
    step_fn = make_train_step(loss_fn, pred_key)
    compared = {}
    for dtype in (torch.float32, torch.float64):
        results = []
        for dev in ("cpu", device):
            ref = build_empty(family.build, cfg)
            ref.load_state_dict({n: t.clone() for n, t in state.items()}, assign=True)
            ref = ref.to(dev, dtype)
            loss = float(step_fn(create_train_state(ref, lr),
                                 (x2.to(dev, dtype), y2.to(dev, dtype)))["loss"])
            results.append((loss, {n: p.grad.detach().cpu() for n, p in ref.named_parameters()}))
        (cpu_loss, cpu_g), (dev_loss, dev_g) = results
        g_scale = max(g.abs().max().item() for g in cpu_g.values())
        compared[str(dtype).split(".")[1]] = dict(
            loss=[dev_loss, cpu_loss], loss_rel_err=abs(dev_loss - cpu_loss) / abs(cpu_loss),
            grad_max_abs_err_over_max_grad=max(
                (dev_g[n] - g).abs().max().item() for n, g in cpu_g.items()) / g_scale)
    loss_rel = compared["float32"]["loss_rel_err"]
    grad_err = compared["float64"]["grad_max_abs_err_over_max_grad"]
    # float32 on two devices with other conv algorithms, ~60 layers deep
    check(loss_rel <= 1e-4, f"f32 train loss disagrees with the CPU: {loss_rel}")
    check(grad_err <= 1e-6, f"f64 gradients disagree with the CPU: {grad_err}")

    # ---- the warm step on a full batch already on the device
    def step():
        trainer.train_step(trainer.state, (x, y))

    step_ms = wall_ms(step, iters=10 if device == "cuda" else 1, device=device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    med = median(step_ms)
    n_chips = steps * epochs * batch
    fields = dict(
        config="parking", arch=blob["arch"], model_kwargs=blob["model_kwargs"],
        parameters=sum(p.numel() for p in model.parameters()),
        chips=[batch, k, k, len(bands)], train_chips=n_files * per_file, eval_chips=per_file,
        steps=steps * epochs, evals=epochs,
        dtype="bfloat16 autocast" if device == "cuda" and "--no-bf16" not in extra_flags
        else "float32", pos_weight=cfg.loss_kwargs.get("pos_weight", 1.0), lr=lr,
        torch_weights_tensors=n_backbone, stem_moved_from_warm_start=stem_moved,
        history=trainer.history, synth_seconds=synth_s, cli_seconds=cli_s,
        cli_chips_per_s=n_chips / cli_s,
        step_vs_cpu=compared, f32_loss_rel_err=loss_rel,
        f64_grad_max_abs_err_over_max_grad=grad_err,
        step_ms=step_ms, step_ms_median=med, chips_per_s=batch / (med / 1e3),
        mpix_per_s=batch * k * k / 1e6 / (med / 1e3), peak_mem_gib=peak)
    return fields, ckpt, eval_file, step


def parking_phase(torch, predict, evaluate_cli, stitch, ckpt, work, shape, eval_glob,
                  eval_chips, extra_flags=(), seed=SEED, device="cuda"):
    """The parking serving path: a (h, w, 3) float32 GeoTIFF (NAIP at
    0.6 m) through ``predict scene --config parking --model deeplab --cog
    --uint8 --predictor 2`` on the trained checkpoint (the preset's
    geometry, hann, BN unfolded), ``hann_stitch`` launches counted; the
    output's dtype, shape, georeferencing and absent nodata tag; one chip's
    float32 forward on ``device`` against the CPU; the forward per chip
    batch. Then ``--tune`` on the same scene (the table written with the
    device's name, read back by a serve without flags), and the evaluate
    CLI on the eval TFRecords (``eval_chips`` chips). Returns (fields,
    launches by path, a warm scene on the device)."""
    from satellite_computervision_tpu_torch.geo import GeoTiffScene, GeoTiffStreamWriter
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.inference.tune import device_name, load_tune_table

    cfg = predict.CONFIGS["parking"]
    kernel, buffer, batch = cfg.serving_geometry
    h, w, c = shape
    rng = np.random.default_rng(seed + 100)
    scene = rng.uniform(0.05, 0.3, shape).astype(np.float32)
    for _ in range(max(1, h * w // 2**18)):  # "lots": bright rectangles
        y, x = rng.integers(0, [h - 32, w - 32])
        hh, ww = rng.integers(16, 160, 2)
        scene[y : y + hh, x : x + ww] += 0.5
    src = os.path.join(work, "naip.tif")
    tf = (0.6, 0.0, 380000.0, 0.0, -0.6, 4300000.0)
    with GeoTiffStreamWriter(src, h, w, c, np.float32, transform=tf, crs="EPSG:26918",
                             compress="none") as wr:
        for y in range(0, h, 1024):
            wr.write_rows(scene[y : y + 1024])
    rows, cols = -(-h // kernel), -(-w // kernel)
    load = dict(cfg=cfg, arch="deeplab")

    out = os.path.join(work, "lots.tif")
    serve = ["scene", "--config", "parking", "--model", "deeplab", "--input", src, "--ckpt",
             ckpt, "--cog", "--uint8", "--predictor", "2", "--output", out, *extra_flags]
    stitch.hann_stitch.launches = 0
    _, text, cli_s = run_cli(predict, serve)
    sync(device)
    launches = {"parking": stitch.hann_stitch.launches}
    check(launches["parking"] == 1, f"hann_stitch launched {launches['parking']} times for "
          "one unbanded scene")
    res = GeoTiffScene(out)
    pred = np.asarray(res)
    check(res.dtype == np.uint8 and pred.shape == (h, w, 1), f"output {res.dtype} {pred.shape}")
    check("26918" in res.meta.get("crs", "") and tuple(res.meta["transform"]) == tf,
          f"georeferencing lost: {res.meta}")
    check(res.nodata is None, f"a nodata tag the JAX CLI does not write: {res.nodata}")
    check(pred.any(), "an all-zero parking map")

    # ---- one chip, float32, the device (TF32 off) against the CPU
    side = kernel + buffer
    chip = torch.from_numpy(np.ascontiguousarray(scene[:side, :side]))[None]
    cpu_model = predict.load_model(ckpt, torch.device("cpu"), **load)
    f32_model = copy.deepcopy(cpu_model).to(device)
    with torch.inference_mode():
        cpu_logits = cpu_model(chip)["logits"]
        dev_logits = f32_model(chip.to(device))["logits"].cpu()
    logit_err = (dev_logits - cpu_logits).abs().max().item()
    logit_scale = cpu_logits.abs().max().item()
    check(logit_err <= 1e-4 * max(logit_scale, 1.0),
          f"f32 forward disagrees with the CPU: {logit_err} (scale {logit_scale})")
    del f32_model

    # ---- warm times: one forward of a full chip batch, one scene on the device
    served = predict.load_model(ckpt, torch.device(device), **load)
    gen = torch.Generator().manual_seed(seed + 101)
    chips = (torch.rand((batch, side, side, c), generator=gen) * 0.3).to(device)
    reps = 5 if device == "cuda" else 1
    with torch.inference_mode():
        fwd_ms = wall_ms(lambda: served(chips), iters=reps, device=device)
    engine = TiledInferenceEngine(lambda x: served(x)["probs"], kernel=kernel, buffer=buffer,
                                  batch_size=batch, blend="hann", device=device)
    scene_dev = torch.from_numpy(scene).to(device)

    def run_scene():
        engine.predict_scene(scene_dev)

    scene_ms = wall_ms(run_scene, iters=reps, device=device)
    del chips

    # ---- --tune: the table is written with this device's name; a serve
    # without geometry flags reads it back
    _, _, tune_s = run_cli(predict, serve + ["--tune"])
    table = os.path.join(ckpt, predict.TUNE_TABLE)
    tuned = load_tune_table(table)
    here = device_name(torch.device(device))
    check(tuned and all(r.device == here for r in tuned), f"tune rows not of {here}: {tuned}")
    best = tuned[0]
    stitch.hann_stitch.launches = 0
    _, tuned_text, tuned_s = run_cli(predict, serve)
    sync(device)
    launches["parking_tuned"] = stitch.hann_stitch.launches
    check("(tune table" in tuned_text, "the serve after --tune did not read the table")
    want = ("tile_mode=whole" if best.tile_mode == "whole"
            else f"serving geometry: k{best.kernel}+b{best.buffer} ")
    check(want in tuned_text, f"the tuned serve did not take {best.label()}")
    check(launches["parking_tuned"] == (best.tile_mode == "chips"),
          f"hann_stitch launched {launches['parking_tuned']} times in the tuned serve")

    # ---- the evaluate CLI on the eval TFRecords
    report, _, eval_s = run_cli(evaluate_cli, [
        "--config", "parking", "--model", "deeplab", "--ckpt", ckpt, "--eval", eval_glob,
        *extra_flags])
    counts = np.asarray(report["counts"])
    eval_pixels = eval_chips * cfg.kernel_size ** 2
    check(counts.sum() == eval_pixels, f"confusion counts sum to {counts.sum()}, "
          f"not the {eval_pixels} eval pixels")
    check(np.isfinite(report["rates"]).all() and all(
        math.isfinite(v) for v in report["overall"].values()), f"non-finite rates: {report}")

    mpix = h * w / 1e6
    fields = dict(
        config="parking", scene=list(shape), geometry=[kernel, buffer, batch],
        grid=[rows, cols], launches=launches, cli_seconds=cli_s, cli_mpix_per_s=mpix / cli_s,
        output_dtype=str(res.dtype), output_shape=list(pred.shape), output_max=int(pred.max()),
        crs=res.meta.get("crs", ""), nodata_tag=res.nodata,
        f32_vs_cpu_max_abs_logit_err=logit_err, f32_logit_scale=logit_scale,
        forward_ms_per_batch=fwd_ms, forward_ms_per_batch_median=median(fwd_ms),
        scene_ms_device_input=scene_ms, scene_ms=median(scene_ms),
        mpix_per_s_device_input=mpix / (median(scene_ms) / 1e3),
        tune_cli_seconds=tune_s, tune_rows=[dict(r.__dict__) for r in tuned],
        tuned_cli_seconds=tuned_s, tuned_geometry=best.label(),
        eval_chips=eval_chips, eval_seconds=eval_s, eval_pixels=int(counts.sum()),
        eval_counts=counts.tolist(), eval_overall=report["overall"])
    return fields, launches, run_scene


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from satellite_computervision_tpu_torch import evaluate as evaluate_cli
    from satellite_computervision_tpu_torch import native, predict
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.kernels import _build, stitch
    from satellite_computervision_tpu_torch.kernels import preprocess as pre
    from satellite_computervision_tpu_torch.models import unet_solar
    from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
    from satellite_computervision_tpu_torch.train.config import (
        CHANGE_CONFIG,
        PARKING_CONFIG,
        SOLAR_CONFIG,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), python=sys.version.split()[0])

    t0 = time.perf_counter()
    libs = _build.build(_build.all_kernels())
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codec = native.build()
    check(codec is not None, "g++ could not build native/fastrecord.cc")
    emit("build", seconds=nvcc_s, libraries=[str(p.name) for p in libs],
         native_seconds=time.perf_counter() - t0, native=codec.name)

    gen = torch.Generator().manual_seed(SEED)
    kernel, buffer, batch = SOLAR_CONFIG.serving_geometry
    rows, cols = -(-SCENE[0] // kernel), -(-SCENE[1] // kernel)
    small = stitch_case(torch, stitch, 16, 8, 3, 4, 2, gen, timed=False)
    main_shape = stitch_case(torch, stitch, kernel, buffer, rows, cols, 1, gen, timed=True)
    # the swath's bands (5 chip rows; the last 2), their first rows culled
    band_cases = [stitch_case(torch, stitch, kernel, buffer, r, SWATH[1] // kernel, 1, gen,
                              timed=False, culled_rows=z) for r, z in ((5, 2), (2, 0))]
    # the change path's grid (k256 + b128: side 1.5 k) and its bands of
    # --max-rows 1024 (3 chip rows; 2 at the ends)
    ck, cb, _ = CHANGE_CONFIG.serving_geometry
    c_rows, c_cols = -(-CHANGE_SCENE[0] // ck), -(-CHANGE_SCENE[1] // ck)
    change_shape = stitch_case(torch, stitch, ck, cb, c_rows, c_cols, 1, gen, timed=True)
    change_bands = [stitch_case(torch, stitch, ck, cb, r, c_cols, 1, gen, timed=False)
                    for r in (2, 3)]
    # the parking path's grid: k512 + b256 over a 4096² scene, 64 chips of
    # 768² into a 4608² canvas
    pk, pb, _ = PARKING_CONFIG.serving_geometry
    p_rows, p_cols = -(-PARKING_SCENE[0] // pk), -(-PARKING_SCENE[1] // pk)
    parking_shape = stitch_case(torch, stitch, pk, pb, p_rows, p_cols, 1, gen, timed=True)
    emit("kernels", name="hann_stitch", small=small, main_path=main_shape, bands=band_cases,
         change=change_shape, change_bands=change_bands, parking=parking_shape)
    # the engine's route: the same products and adds in the same order, so
    # bit-equal; pre-weighted chips: within 1e-6
    tol = 1e-6
    cases = [small, main_shape, change_shape, parking_shape] + band_cases + change_bands
    check(all(c["max_abs_err"] == 0.0 for c in cases),
          "hann_stitch(apply_window=True) is not bit-equal to its plain version")
    check(all(c["weighted_max_abs_err"] <= tol for c in cases),
          f"hann_stitch disagrees with its plain version beyond {tol}")

    # fused_preprocess at the training path's shape: a batch of 64 chips,
    # 256², the 6 bands + the label channel, 6 recolored
    n_color = len(SOLAR_CONFIG.bands)
    path_shape = (SOLAR_CONFIG.train_batch, SOLAR_CONFIG.kernel_size,
                  SOLAR_CONFIG.kernel_size, n_color + 1)
    pre_small = [preprocess_case(torch, pre, (3, 16, 16, 4), n, aug, gen, timed=False)
                 for n in (4, 3, 0) for aug in (True, False)]
    pre_path = {("augment" if aug else "eval"): preprocess_case(
        torch, pre, path_shape, n_color, aug, gen, timed=True) for aug in (True, False)}
    # a NaN plane, negative and zero contrast, every rotation and flip
    pre_hard = preprocess_case(torch, pre, path_shape, n_color, True, gen, timed=False,
                               hard=True)
    # the parking preset's chips (R, G, B + the label at 512²): a CTA's rows
    # do not fit in shared memory, so the kernel takes its streamed route
    streamed_shape = (PARKING_CONFIG.batch_size, PARKING_CONFIG.kernel_size,
                      PARKING_CONFIG.kernel_size, len(PARKING_CONFIG.bands) + 1)
    pre_streamed = preprocess_case(torch, pre, streamed_shape, len(PARKING_CONFIG.bands),
                                   True, gen, timed=True)
    emit("kernels", name="fused_preprocess", small=pre_small, main_path=pre_path,
         hard=pre_hard, streamed=pre_streamed)
    tol = 1e-5  # min/max exact, the mean summed in another order; outputs in [0, 1]
    pre_err = max(c["max_abs_err"]
                  for c in pre_small + list(pre_path.values()) + [pre_hard, pre_streamed])
    check(pre_err <= tol, f"fused_preprocess disagrees with its plain version: {pre_err}")

    # ---- the solar serving slice, through the CLI a user runs
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    model = unet_solar(in_channels=len(SOLAR_CONFIG.bands), space_to_depth=True).eval()
    randomize_(model, gen)
    ckpt = os.path.join(work, "ckpt")
    save_checkpoint(ckpt, model, {"seed": SEED})
    scene = (torch.rand(SCENE, generator=gen) * 0.4).numpy()
    scene_path = os.path.join(work, "scene.npy")
    np.save(scene_path, scene)
    pred, launches, cli_s = serve_through_cli(torch, predict, stitch, read_geotiff, ckpt,
                                              scene_path, os.path.join(work, "pred.tif"))

    # one chip, float32, card (TF32 off) vs CPU: the same folded model
    served = predict.load_model(ckpt, torch.device("cpu"), fold_bn=True)
    chip = torch.from_numpy(scene[: kernel + buffer, : kernel + buffer])[None]
    with torch.inference_mode():
        cpu_out = served(chip)
        gpu_out = served.to("cuda")(chip.cuda())
    logit_err = (gpu_out["logits"].cpu() - cpu_out["logits"]).abs().max().item()
    logit_scale = cpu_out["logits"].abs().max().item()
    prob_err = (gpu_out["probs"].cpu() - cpu_out["probs"]).abs().max().item()
    # float32 on two devices with other conv algorithms, ~30 layers deep
    check(logit_err <= 1e-4 * max(logit_scale, 1.0),
          f"f32 card forward disagrees with the CPU: {logit_err} (scale {logit_scale})")

    # bf16 served output against the f32 forward of the same chip
    served_bf16 = predict.load_model(ckpt, torch.device("cuda"), fold_bn=True)
    with torch.inference_mode():
        bf16_probs = served_bf16(chip.cuda())["probs"].float().cpu()
    bf16_vs_f32 = (bf16_probs - cpu_out["probs"]).abs()

    engine = TiledInferenceEngine(lambda c: served_bf16(c)["probs"], kernel=kernel,
                                  buffer=buffer, batch_size=batch, blend="hann",
                                  device="cuda")
    scene_dev = torch.from_numpy(scene).cuda()
    torch.cuda.reset_peak_memory_stats()

    def run_host():
        engine.predict_scene(scene)

    def run_dev():
        engine.predict_scene(scene_dev)

    host_ms = wall_ms(run_host)
    dev_ms = wall_ms(run_dev)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    chips = (torch.rand((batch, kernel + buffer, kernel + buffer, SCENE[2]),
                        generator=gen) * 0.4).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: served_bf16(chips), iters=10, warmup=2)
    mpix = SCENE[0] * SCENE[1] / 1e6
    med_host, med_dev = median(host_ms), median(dev_ms)
    emit("slice", config="solar", scene=list(SCENE), geometry=[kernel, buffer, batch],
         blend="hann", dtype="bfloat16", space_to_depth=True, fold_bn=True,
         chips=rows * cols, launches=launches, cli_seconds=cli_s,
         output_shape=list(pred.shape), output_min=float(pred.min()),
         output_max=float(pred.max()),
         f32_card_vs_cpu_max_abs_logit_err=logit_err, f32_logit_scale=logit_scale,
         f32_card_vs_cpu_max_abs_prob_err=prob_err,
         bf16_vs_f32_prob_err_max=bf16_vs_f32.max().item(),
         bf16_vs_f32_prob_err_mean=bf16_vs_f32.mean().item(),
         scene_ms_host_input=host_ms, scene_ms_device_input=dev_ms,
         scene_ms=med_host, mpix_per_s=mpix / (med_host / 1e3),
         mpix_per_s_device_input=mpix / (med_dev / 1e3),
         forward_ms_per_batch=fwd_ms, peak_mem_gib=peak_gib)

    # ---- the swath: banded, culled, lazy input, COG out
    swath, swath_launches = swath_phase(torch, predict, stitch, ckpt, work, SWATH, *SWATH_EDGE,
                                        SWATH_MAX_ROWS, (kernel, buffer, batch))
    emit("swath", **swath)
    # ---- the multi-scene sweep, pipelined
    sweep, sweep_launches = sweep_phase(torch, predict, stitch, ckpt, work, SCENE,
                                        SWEEP_SCENES, (kernel, buffer, batch))
    emit("sweep", **sweep)
    emit("whole", **whole_phase(torch, predict, ckpt, work, scene_path, (kernel, buffer)))
    emit("patches", **patches_phase(torch, predict, ckpt, work, 2, 8))
    serving_launches = {"slice": launches["hann_stitch"], "swath": swath_launches,
                        "sweep": sweep_launches}

    # ---- the solar training slice, then its checkpoint served
    train_fields, train_launches, train_step, train_preprocess = train_phase(torch, work, gen)
    emit("train", **train_fields)

    # ---- change detection: the Siamese U-Net trained on npy chips, then
    # its checkpoint served over a scene pair
    change_train, change_ckpt, change_step = change_train_phase(
        torch, work, CHANGE_CHIPS, CHANGE_CONFIG.kernel_size, CHANGE_CONFIG.batch_size,
        CHANGE_STEPS)
    emit("change_train", **change_train)
    change, change_launches, change_scene = change_phase(
        torch, predict, stitch, change_ckpt, work, CHANGE_SCENE, CHANGE_EDGE, CHANGE_MAX_ROWS,
        CHANGE_CONFIG.serving_geometry)
    emit("change", **change)
    serving_launches.update(change_launches)

    # ---- parking lots: DeepLab v3+ (ResNet-50) trained on TFRecords from a
    # warm-start backbone, then served, tuned and evaluated
    parking_train, parking_ckpt, parking_eval, parking_step = parking_train_phase(
        torch, work, PARKING_FILES, PARKING_CHIPS, PARKING_CONFIG.batch_size, PARKING_STEPS,
        PARKING_EPOCHS)
    emit("parking_train", **parking_train)
    parking, parking_launches, parking_scene = parking_phase(
        torch, predict, evaluate_cli, stitch, parking_ckpt, work, PARKING_SCENE, parking_eval,
        PARKING_CHIPS)
    emit("parking", **parking)
    serving_launches.update(parking_launches)

    # ---- where a warm scene's and a warm train step's device time goes
    emit("profile", what="scene", **device_profile(torch, run_dev))
    emit("profile", what="train_step", calls=3, **device_profile(torch, train_step, calls=3))
    emit("profile", what="preprocess", calls=5,
         **device_profile(torch, train_preprocess, calls=5))
    emit("profile", what="change_train_step", calls=3,
         **device_profile(torch, change_step, calls=3))
    emit("profile", what="change_scene", **device_profile(torch, change_scene))
    emit("profile", what="parking_scene", **device_profile(torch, parking_scene))
    emit("profile", what="parking_train_step", calls=3,
         **device_profile(torch, parking_step, calls=3))

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "hann_stitch", "route": "cuda",
         "source": "satellite_computervision_tpu_torch/csrc/hann_stitch.cu",
         "replaces": "satellite_computervision_tpu/pallas/stitch.py:130",
         "launches": sum(serving_launches.values()), "launches_by_path": serving_launches,
         "max_abs_err": main_shape["max_abs_err"],
         "ms": main_shape["ms"], "device_ms": main_shape["device_ms"],
         "plain_ms": main_shape["plain_ms"],
         "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
         "library_ms": main_shape["library_ms"],
         "change_shape": {k: change_shape[k] for k in (
             "shape", "canvas", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")},
         "parking_shape": {k: parking_shape[k] for k in (
             "shape", "canvas", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")}},
        {"name": "fused_preprocess", "route": "cuda",
         "source": "satellite_computervision_tpu_torch/csrc/fused_preprocess.cu",
         "replaces": "satellite_computervision_tpu/pallas/preprocess.py:135",
         "launches": train_launches["fused_preprocess"],
         "max_abs_err": max(c["max_abs_err"] for c in pre_path.values()),
         "ms": pre_path["augment"]["ms"], "device_ms": pre_path["augment"]["device_ms"],
         "plain_ms": pre_path["augment"]["plain_ms"],
         "bound_ms": pre_path["augment"]["bound_ms"],
         "bound_by": pre_path["augment"]["bound_by"], "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
