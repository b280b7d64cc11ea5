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
   kernel, bit-equal, and on pre-weighted chips, at the solar, the change,
   the parking and the acquire serving grids; ``fused_preprocess`` also
   with a NaN plane, negative and zero contrast and every flip/rotation,
   and at the parking preset's 16 x 512² x 4 chips, whose rows do not fit
   in shared memory: the kernel's streamed route; ``hann_stitch`` also at
   the swath's band shapes, the culled chips' predictions zero, and at
   ``parallel.spatial``'s band over the slice scene: 24 x 640² with a
   phantom chip row each side and the whole grid's row weights, timed).
   ``ms``,
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
12. ``timeseries_train``: the timeseries path at full ``TIMESERIES_CONFIG``
   width — 32 seeded (7, 4, 72, 72) Sentinel-2-scaled series
   ``s2_x_<month>_*.npy`` through ``python -m
   satellite_computervision_tpu_torch.train --config timeseries --model
   convlstm --series-dim 64`` (``LSTMModel``: 64 features, 4 outputs, 5
   input steps) and then ``--model lstm_autoencoder`` (16 features, a
   32-feature decoder over 6 steps), 6 steps of 16 each, bf16 autocast;
   the kernels' launch counts over both runs (neither kernel is on this
   path); per model the outputs finite and of their shape, the warm step,
   chips/s, the profiler's busy share and device launches per step, peak
   memory, and one float32 step on the card (TF32 off) against the CPU
   from the same weights and batch.
13. ``landcover_train``: the landcover path at full ``LANDCOVER_CONFIG``
   width (8 classes, 256², batch 8) — the ACNN (16 blocks of 16) through
   ``train --config landcover --model acnn`` on GZIP EE-schema TFRecords
   (R/G/B/N and an 8-class ``lc``; 6 steps, 2 evals) and then ``python -m
   satellite_computervision_tpu_torch.evaluate --model acnn`` on its
   checkpoint (the counts sum to the eval pixels); the hierarchical model
   through ``--model hierarchical`` on 16 npy chip sets (NAIP 256² x 4, a
   6 x 32² x 4 series, labels); the hybrid at the preset's 256² through
   the CLI, which must fail with the pool-factor error before writing
   anything, as the JAX CLI fails; the full-width hybrid (U-Net 32…256,
   pools 3/2/2/2, LSTM 64) at 240² through ``HybridChipDataset`` and
   ``Trainer``. Per model the same figures and step check as
   ``timeseries_train``.
14. ``acquire``: imagery in, map out (the reference's run_local
   change-detection workflow) — 6 "before" (2021-06) and 6 "after"
   (2022-06, +1000 offset) raw Sentinel-2 L1C items of 4096² (B1, B2, B3,
   B4, B8, B10, B11, B12 and QA60) made on the card from a seeded
   ``torch.Generator`` (vegetated land whose raw cloud scores are below 0,
   bright cloud patches, QA60 bits 10/11 on a share of pixels, a dark
   vegetated block, a stripe with B3 = B11 = 0) -> ``pc.harmonize_to_old``
   -> ``combined_mask & basic_qa_mask`` -> ``apply_mask`` -> NaN-median
   composites, per-pixel z-normalized, NaN filled with 0 -> the (4096,
   4096, 8) change pair -> ``cloud.pc.predict_scene`` (k256 + b128, batch
   8, hann) with the ``change_train`` checkpoint -> ``numpy_to_raster(cog=
   True)`` with an EPSG:32617 mixer, read back -> ``get_img_bounds`` in
   EPSG:4326; seconds per stage, MPix/s, peak memory, the masked share and
   ``hann_stitch`` launches (1). Then the top-left 512² of every item and
   composite on the card against the same code on the CPU (masks and uint8
   scores bit-equal, with raw scores below 0 and NaN indices present; the
   median bit-equal with even and odd valid counts and all-masked pixels
   NaN; the normalized composite within 1e-6 relative), and the served
   stitch bit-equal to its plain version on the path's own predictions.
15. ``calibrate``: the multi-state sweep — six 1920² x 6 scenes with the
   example's per-state biases through ``equalize_collection`` on the host,
   then served with the ``train`` checkpoint by ``predict_scene_batch``
   (k512 + b128, batch 16, hann, uint8 out; one ``hann_stitch`` per scene)
   and a confusion report per state; host seconds of calibration against
   the seconds of serving.
16. ``parallel``: parallel training and serving in a one-rank process
   group (NCCL; the card is one GPU), opened at the start of the phase and
   destroyed at its end. ``dp_train``: the full-width solar U-Net (batch
   64 x 256², bf16 autocast) on the ``train`` phase's TFRecords through the
   CUDA ``fused_preprocess`` and 6 steps of ``make_parallel_train_step``
   (DDP, global-batch BatchNorm), and 6 of the plain ``make_train_step``
   from the same weights on the same batches; one float32 step of each
   held against the other (loss within 1e-4 relative, gradients within
   1e-3 x max|grad|); warm step times, busy shares, peak memory.
   ``remat``: ``train --config parking --model unet --remat --orbax``
   through the CLI on the ``parking_train`` phase's NAIP TFRecords (512² x
   3, batch 16, bf16), its ``torch.distributed.checkpoint`` restored into
   a fresh model bit-equal; then 2 steps with remat and 2 without from the
   same weights (losses within 1e-4 relative, BatchNorm buffers within
   1e-6; cuDNN deterministic), peak memory and step time of each.
   ``retrain``: ``train/retrain.py`` from the ``train`` checkpoint with
   ``freeze_to="head"``, the best metric seeded from an eval, 3 steps: the
   head moves, every other parameter bit-unchanged. ``spatial``:
   ``make_spatial_inference(blend="hann")`` with the ``train`` checkpoint
   (folded BN, bf16, k512 + b128, batch 16) on the slice scene and, with
   ``max_rows=2688``, on the swath, against the engine's ``predict_scene``
   within 1e-2, and a float32 case within 1e-3; one ``hann_stitch`` launch
   per band, and the first band's stitch with its row weights bit-equal to
   the plain version. ``sharded_engine``: ``cloud.pc.predict_scene(mesh=
   ...)`` on the slice scene, bit-equal to the unsharded engine.
17. ``h5``: the Keras ``.h5`` bridge at full width — a reference-layout
   solar U-Net (6 bands, filters 32…512, no space-to-depth stem, one conv
   per block, seeded weights) saved with ``save_checkpoint``, exported to
   the reference's Keras layout by ``python -m
   satellite_computervision_tpu_torch.export``, its architecture inferred
   back and its weights re-imported bit-equal; ``evaluate --ckpt``,
   ``evaluate --h5 --no-fold`` (equal counts) and ``evaluate --h5``
   folded (bf16: only pixels whose float32 probability lies within 1e-2
   of the threshold may change class) on the ``train`` phase's eval
   records, the head's bias set so that a fifth of them score positive; the weights through ``compat.get_blob_model``
   (``file://``) served over the slice scene by the hann engine (one
   ``hann_stitch`` launch, held bit-equal against its plain version) and
   by ``compat.predict_chips`` (held against the ``ops.chips`` per-chip
   loop); the Siamese U-Net, ConvLSTM, LSTM autoencoder and hybrid (240²)
   at their presets' widths out and back, each forward on the card before
   and after (bit-equal; the ConvLSTM families within 1e-5 x max|out|:
   Keras stores the forget bias + 1, which costs a rounding). Where the
   card host has no ``h5py`` (the line says ``h5py: absent``) the same
   exporters, loaders and ``evaluate.load_h5_model`` take the layers in
   memory, which is what the file would hold; the file layer is held by
   the CPU tests.
18. ``convergence``: the four convergence twins through their ``main``
   at full model width, cut to a rehearsal — ``solar_convergence`` (32
   train and 16 eval chips, batch 16, ``--scene-eval``: chips, hann and
   whole modes), ``change_convergence`` (16 and 8 pairs, batch 8,
   ``--scene-eval``: hann and whole through ``change_pair_composite``),
   ``parking_convergence --model deeplab`` (32 and 16 chips of 512²,
   ``--export-backbone``, then 16 chips ``--torch-weights`` from it) and
   ``swath_codec_sweep`` (one 1536 x 8192 x 4 uint16 LZW COG, k512 +
   b128, batch 16, three bands); their records against the JAX scripts'
   keys, losses finite, the kernels' launches per run (``hann_stitch``
   once per scene eval and once per swath band, ``fused_preprocess``
   never) and every stitch of the runs bit-equal to its plain version.
19. ``profile``: one warm scene, three warm train steps, five warm
   ``make_preprocess_fn`` calls, three warm change train steps, one warm
   change pair, one warm parking scene and three warm DeepLab train steps
   under ``torch.profiler``: device time by kernel, host time by op and
   the device's busy share.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result. Writes scratch files under ``build/chip_smoke/``.
"""

import contextlib
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
# timeseries: (7, 4, 72, 72) series files, trimmed to the preset's 64²,
# and steps of each of the two families' runs (batch 16, the preset's)
TIMESERIES_FILES, TIMESERIES_SIDE, TIMESERIES_STEPS = 32, 72, 6
# landcover: npy chip sets (NAIP 256² x 4, a 6 x 32² x 4 series, labels);
# steps per epoch and epochs of each run (batch 8, the preset's); the
# hybrid's U-Net side (256 does not round-trip its pools; 240 = 10 x 24)
LANDCOVER_CHIPS, LANDCOVER_STEPS, LANDCOVER_EPOCHS = 16, 3, 2
LANDCOVER_SERIES_SIDE, LANDCOVER_HYBRID_SIDE = 32, 240
# acquire: raw Sentinel-2 items per period (4096² L1C tiles), and the
# top-left square of every item and composite held against the CPU
ACQUIRE_ITEMS, ACQUIRE_SIDE, ACQUIRE_CROP = 6, 4096, 512
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


def stitch_case(torch, stitch, k, buf, rows, cols, c_out, gen, timed, culled_rows=0,
                culled_last_rows=0, row_weights=None):
    """hann_stitch on the card against its plain version: the engine's
    route (raw predictions, ``apply_window=True``: bit-equal) and the TPU
    kernel's (pre-weighted chips); the engine's route timed. The chips of
    the first ``culled_rows`` and the last ``culled_last_rows`` grid rows
    are zero, as culled chips and a spatial band's phantom rows reach the
    stitch. ``row_weights`` (numpy, ((rows+1)*k,)) replaces the grid's row
    sums in the normalizer, as ``parallel/spatial.py`` passes them."""
    side = k + buf
    preds = torch.rand((rows * cols, side, side, c_out), generator=gen)
    preds[: culled_rows * cols] = 0.0
    if culled_last_rows:
        preds[-culled_last_rows * cols:] = 0.0
    preds = preds.cuda()
    rw = None if row_weights is None else torch.from_numpy(row_weights).cuda()
    window = stitch.hann_window_2d(side, "cuda")
    weighted = (preds * window[..., None]).contiguous()
    got = stitch.hann_stitch(preds, k, rows, cols, apply_window=True, row_weights=rw)
    want = stitch.hann_stitch_reference(preds, k, rows, cols, apply_window=True, row_weights=rw)
    got_w = stitch.hann_stitch(weighted, k, rows, cols, row_weights=rw)
    want_w = stitch.hann_stitch_reference(weighted, k, rows, cols, row_weights=rw)
    torch.cuda.synchronize()
    out = dict(shape=[rows * cols, side, side, c_out], kernel=k, canvas=list(got.shape),
               max_abs_err=(got - want).abs().max().item(),
               weighted_max_abs_err=(got_w - want_w).abs().max().item())
    if timed:
        if row_weights is None:
            inv_w = stitch.hann_inverse_weights(rows, cols, k, side)
        else:
            wx = stitch._axis_weight_sum(cols, k, side)
            inv_w = 1.0 / np.maximum(row_weights[:, None] * wx[None, :], 1e-8)
        inv_w = torch.from_numpy(inv_w).cuda()
        lib = fold_blend(preds, k, rows, cols, window, inv_w)
        out["library_max_abs_err"] = (lib - want).abs().max().item()

        def kernel():
            stitch.hann_stitch(preds, k, rows, cols, apply_window=True, row_weights=rw)

        def library():
            fold_blend(preds, k, rows, cols, window, inv_w)

        out["ms"] = cuda_ms(kernel)
        out["device_ms"] = device_ms(kernel, "hann_stitch_kernel")
        out["plain_ms"] = cuda_ms(lambda: stitch.hann_stitch_reference(
            preds, k, rows, cols, apply_window=True, row_weights=rw), iters=10, warmup=2)
        out["library_ms"] = cuda_ms(library)
        out["library_device_ms"] = device_ms(library)
        # predictions, w1, wy (or the row weights), wx read once; the canvas
        # written once
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
                if mod.bias is not None:  # a ConvLSTM's recurrent conv has none
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
                device_launches=sum(r[2] for r in dev) if dev else "not measured",
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


def _to(item, device, dtype=None):
    """numpy arrays or tensors, and lists or tuples of them, as tensors on
    ``device`` (floating ones cast to ``dtype`` when given)."""
    import torch

    if isinstance(item, (list, tuple)):
        return type(item)(_to(a, device, dtype) for a in item)
    t = item if isinstance(item, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(item))
    return t.to(device, dtype) if dtype is not None and t.is_floating_point() else t.to(device)


def _first(item, n):
    """The first ``n`` chips of every array in ``item``."""
    if isinstance(item, (list, tuple)):
        return type(item)(_first(a, n) for a in item)
    return item[:n]


def step_vs_cpu(torch, build, state, loss_fn, pred_key, x, y, lr, device):
    """One float32 train step (TF32 off) on ``device`` against the CPU from
    the same weights (``state``, a CPU state_dict) and batch: (fields, loss
    relative error, gradient error over the largest gradient)."""
    from satellite_computervision_tpu_torch.train.checkpoint import build_empty
    from satellite_computervision_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    step_fn = make_train_step(loss_fn, pred_key)
    results = []
    for dev in ("cpu", device):
        ref = build_empty(build)
        ref.load_state_dict({n: t.clone() for n, t in state.items()}, assign=True)
        ref = ref.to(dev, torch.float32)
        loss = float(step_fn(create_train_state(ref, lr),
                             (_to(x, dev, torch.float32), _to(y, dev, torch.float32)))["loss"])
        results.append((loss, {n: p.grad.detach().cpu() for n, p in ref.named_parameters()
                               if p.grad is not None}))
    (cpu_loss, cpu_g), (dev_loss, dev_g) = results
    g_scale = max(g.abs().max().item() for g in cpu_g.values())
    grad_err = max((dev_g[n] - g).abs().max().item() for n, g in cpu_g.items()) / g_scale
    loss_rel = abs(dev_loss - cpu_loss) / abs(cpu_loss)
    return dict(loss=[dev_loss, cpu_loss], loss_rel_err=loss_rel,
                grad_max_abs_err_over_max_grad=grad_err), loss_rel, grad_err


def warm_step_fields(torch, trainer, x, y, batch, side, device):
    """The warm train step on a batch already on ``device``: times, chips/s,
    and (on CUDA) the profiler's busy share and device launches per step."""
    def step():
        trainer.train_step(trainer.state, (x, y))

    step_ms = wall_ms(step, iters=10 if device == "cuda" else 1, device=device)
    med = median(step_ms)
    fields = dict(step_ms=step_ms, step_ms_median=med, chips_per_s=batch / (med / 1e3),
                  mpix_per_s=batch * side * side / 1e6 / (med / 1e3))
    if device == "cuda":
        prof = device_profile(torch, step, calls=3)
        fields.update(busy_share=prof["device_busy_share"],
                      device_launches_per_step=prof["device_launches"] / 3,
                      profile_top=prof["top"][:6])
    return fields, step


def kernel_counts(pre, stitch):
    return {"hann_stitch": stitch.hann_stitch.launches,
            "fused_preprocess": pre.fused_preprocess.launches}


def zero_counts(pre, stitch):
    stitch.hann_stitch.launches = 0
    pre.fused_preprocess.launches = 0


def synthesize_series(root, n, t, bands, side, seed):
    """``n`` (t, bands, side, side) float32 Sentinel-2-scaled series
    ``s2_x_<month>_<i>.npy`` under ``root`` (the start month in the stem's
    third ``_``-part, as the LSTM autoencoder's dataset reads it): per band
    a level, a seasonal cycle of period 6 from the start month, a few
    brighter fields, noise; in [0, 10000]. Returns the glob."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        month = int(rng.integers(0, 12))
        level = rng.uniform(500.0, 3000.0, (1, bands, 1, 1))
        season = 1.0 + 0.3 * np.sin(2 * np.pi * (month + np.arange(t)) / 6.0)
        arr = level * season[:, None, None, None] + rng.normal(0, 150.0, (t, bands, side, side))
        for _ in range(3):
            y, x = rng.integers(0, side - side // 4, 2)
            arr[:, :, y : y + side // 4, x : x + side // 4] *= rng.uniform(1.2, 1.8)
        np.save(os.path.join(root, f"s2_x_{month}_{i:03d}.npy"),
                np.clip(arr, 0, 10000).astype(np.float32))
    return os.path.join(root, "*.npy")


def timeseries_train_phase(torch, pre, stitch, work, n_files, side, series_dim, batch, steps,
                           extra_flags=(), seed=SEED, device="cuda"):
    """The timeseries path: ``n_files`` seeded (7, 4, side, side) series
    through ``python -m satellite_computervision_tpu_torch.train --config
    timeseries --model convlstm --series-dim series_dim``, then ``--model
    lstm_autoencoder``, each ``steps`` steps of ``batch``; the kernels'
    counts over both runs (no kernel is on this path); per model the warm
    step, chips/s, busy share, launches per step, one float32 step on
    ``device`` against the CPU. Returns (fields, counts, warm steps)."""
    from satellite_computervision_tpu_torch.data.chip_generators import (
        LSTMAutoencoderChipDataset,
        LSTMChipDataset,
    )
    from satellite_computervision_tpu_torch.train import __main__ as train_cli
    from satellite_computervision_tpu_torch.train.zoo import get_family

    cfg = train_cli.CONFIGS["timeseries"]
    t0 = time.perf_counter()
    series = synthesize_series(os.path.join(work, "series"), n_files, cfg.n_time + 1,
                               len(cfg.bands), side, seed + 110)
    synth_s = time.perf_counter() - t0
    files = sorted(glob.glob(series))
    fields = dict(config="timeseries", files=n_files,
                  series=[cfg.n_time + 1, len(cfg.bands), side, side], series_dim=series_dim,
                  batch=batch, steps=steps, synth_seconds=synth_s,
                  dtype="bfloat16 autocast" if device == "cuda" and "--no-bf16" not in
                  extra_flags else "float32")
    warm = {}
    zero_counts(pre, stitch)
    for family, cls in (("convlstm", LSTMChipDataset),
                        ("lstm_autoencoder", LSTMAutoencoderChipDataset)):
        ckpt = os.path.join(work, f"{family}_ckpt")
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        trainer, _, cli_s = run_cli(train_cli, [
            "--config", "timeseries", "--model", family, "--series", series, "--series-dim",
            str(series_dim), "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", str(steps),
            "--batch-size", str(batch), *extra_flags])
        sync(device)
        losses = [r["train"]["loss"] for r in trainer.history]
        check(trainer.state.step == steps, f"{family}: {trainer.state.step} steps for {steps}")
        check(all(math.isfinite(v) for v in losses), f"{family}: non-finite loss {losses}")
        blob = torch.load(os.path.join(ckpt, "best", "model.pt"), map_location="cpu",
                          weights_only=True)
        check(blob.get("arch") == family, f"best/model.pt arch {blob.get('arch')!r}")

        ds = cls(files, batch_size=batch, dim=(series_dim, series_dim),
                 n_channels=len(cfg.bands), n_timesteps=cfg.n_time, seed=seed)
        x, y = ds[0][:2]
        with torch.no_grad():
            out = trainer.state.model.eval()(*_to(x if isinstance(x, list) else [x], device))
        shapes = {k: list(v.shape) for k, v in out.items()} if isinstance(out, dict) \
            else list(out.shape)
        finite = all(torch.isfinite(v).all() for v in (out.values() if isinstance(out, dict)
                                                       else [out]))
        check(finite, f"{family}: non-finite outputs")
        step_fields, step = warm_step_fields(torch, trainer, _to(x, device), _to(y, device),
                                             batch, series_dim, device)
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None

        fam = get_family(family)
        state = {n: v.detach().float().cpu() for n, v in trainer.state.model.state_dict().items()}
        loss_fn, pred_key = fam.loss(cfg)
        compared, loss_rel, grad_err = step_vs_cpu(
            torch, lambda: fam.build(cfg), state, loss_fn, pred_key, _first(x, 4), _first(y, 4),
            cfg.learning_rate, device)
        check(loss_rel <= 1e-4, f"{family}: f32 train loss disagrees with the CPU: {loss_rel}")
        check(grad_err <= 1e-3, f"{family}: f32 gradients disagree with the CPU: {grad_err}")
        fields[family] = dict(
            arch=blob["arch"], model_kwargs=blob["model_kwargs"],
            parameters=sum(p.numel() for p in trainer.state.model.parameters()),
            outputs=shapes, history=trainer.history, cli_seconds=cli_s,
            cli_chips_per_s=steps * batch / cli_s, step_vs_cpu=compared,
            f32_loss_rel_err=loss_rel, f32_grad_max_abs_err_over_max_grad=grad_err,
            peak_mem_gib=peak, **step_fields)
        warm[family] = step
    counts = kernel_counts(pre, stitch)
    fields["launches"] = counts
    return fields, counts, warm


def synthesize_landcover_records(path, n, bands, response, side, seed):
    """EE-schema GZIP TFRecord of ``n`` ``side``² chips: an 8-class ``lc``
    plane of rectangular patches over class 0, each band a class-dependent
    level plus noise in [0, 1]."""
    from satellite_computervision_tpu_torch.data.tfrecord import TFRecordWriter, build_example

    rng = np.random.default_rng(seed)
    means = rng.uniform(0.05, 0.6, (8, len(bands)))
    with gzip.open(path, "wb", compresslevel=1) as f, TFRecordWriter(f, None) as writer:
        for _ in range(n):
            lc = landcover_classes(rng, side)
            chip = means[lc] + rng.normal(0, 0.05, (side, side, len(bands)))
            ex = {b: chip[..., i].astype(np.float32).reshape(-1) for i, b in enumerate(bands)}
            ex[response] = lc.astype(np.float32).reshape(-1)
            writer.write(build_example(ex))


def landcover_classes(rng, side):
    """A (side, side) int map of 8 classes: class 0 with rectangles of 1-7."""
    lc = np.zeros((side, side), np.int64)
    for _ in range(12):
        y, x = rng.integers(0, side - side // 8, 2)
        hh, ww = rng.integers(side // 16, side // 3, 2)
        lc[y : y + hh, x : x + ww] = rng.integers(1, 8)
    return lc


def synthesize_landcover_npy(root, n, bands, side, series_t, series_side, seed):
    """``n`` landcover chip sets under ``root``: NAIP ``naip/`` (bands x
    side², 0-255), labels ``label/`` (1 x side², classes 0-7), S2 series
    ``s2/`` (series_t x bands x series_side², 0-10000), the imagery and
    series brighter by class. Returns (naip, series, label) globs."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(20.0, 200.0, (8, bands))
    dirs = {name: os.path.join(root, name) for name in ("naip", "s2", "label")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    step = side // series_side
    for i in range(n):
        lc = landcover_classes(rng, side)
        naip = means[lc].transpose(2, 0, 1) + rng.normal(0, 10.0, (bands, side, side))
        coarse = means[lc[::step, ::step][:series_side, :series_side]].transpose(2, 0, 1) * 30.0
        season = 1.0 + 0.3 * np.sin(2 * np.pi * np.arange(series_t) / series_t)
        s2 = coarse[None] * season[:, None, None, None] + rng.normal(
            0, 100.0, (series_t, bands, series_side, series_side))
        for name, arr in (("naip", np.clip(naip, 0, 255).astype(np.float32)),
                          ("s2", np.clip(s2, 0, 10000).astype(np.float32)),
                          ("label", lc[None].astype(np.uint8))):
            np.save(os.path.join(dirs[name], f"{name}_{i:03d}.npy"), arr)
    return [os.path.join(dirs[k], "*.npy") for k in ("naip", "s2", "label")]


def landcover_train_phase(torch, evaluate_cli, pre, stitch, work, n_chips, batch, steps, epochs,
                          series_side, hybrid_side, extra_flags=(), seed=SEED, device="cuda"):
    """The landcover path at the preset's width: the ACNN through ``train
    --config landcover --model acnn`` on GZIP EE-schema TFRecords (R/G/B/N,
    an 8-class ``lc``; ``epochs`` x ``steps`` steps of ``batch`` and an eval
    each epoch), then ``evaluate --model acnn`` on its checkpoint; the
    hierarchical model through ``--model hierarchical`` on ``n_chips`` npy
    chip sets (NAIP, a ``series_side``² S2 series, labels); the hybrid at
    the preset's side through the CLI, which must fail as JAX does; the
    hybrid at ``hybrid_side`` (a side its pools round-trip) through
    ``HybridChipDataset`` and ``Trainer``. Per model the warm step, chips/s,
    busy share, launches per step, peak memory and one float32 step on
    ``device`` against the CPU. Returns (fields, counts, warm steps)."""
    from satellite_computervision_tpu_torch.data.chip_generators import (
        ChipSource,
        HybridChipDataset,
    )
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        make_preprocess_fn,
    )
    from satellite_computervision_tpu_torch.models.unet import flax_init_
    from satellite_computervision_tpu_torch.train import __main__ as train_cli
    from satellite_computervision_tpu_torch.train.checkpoint import build_empty
    from satellite_computervision_tpu_torch.train.trainer import Trainer, create_train_state
    from satellite_computervision_tpu_torch.train.zoo import get_family

    cfg = train_cli.CONFIGS["landcover"]
    k, bands = cfg.kernel_size, list(cfg.bands)
    t0 = time.perf_counter()
    data = os.path.join(work, "landcover_tfrecords")
    os.makedirs(data, exist_ok=True)
    train_files = [os.path.join(data, f"train-{i}.tfrecord.gz") for i in range(2)]
    eval_file = os.path.join(data, "eval-0.tfrecord.gz")
    for i, path in enumerate(train_files + [eval_file]):
        synthesize_landcover_records(path, batch, bands, cfg.response, k, seed + 120 + i)
    naip, series, labels = synthesize_landcover_npy(
        os.path.join(work, "landcover_chips"), n_chips, len(bands), k, cfg.n_time, series_side,
        seed + 130)
    synth_s = time.perf_counter() - t0
    dtype = "bfloat16 autocast" if device == "cuda" and "--no-bf16" not in extra_flags \
        else "float32"
    fields = dict(config="landcover", classes=cfg.num_classes, side=k, batch=batch,
                  synth_seconds=synth_s, dtype=dtype)
    warm = {}

    def measured(family, trainer, x, y, side, cli_s, n_steps):
        fam = get_family(family)
        step_fields, step = warm_step_fields(torch, trainer, _to(x, device), _to(y, device),
                                             batch, side, device)
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
        model = trainer.state.model
        state = {n: v.detach().float().cpu() for n, v in model.state_dict().items()}
        loss_fn, pred_key = fam.loss(cfg)
        compared, loss_rel, grad_err = step_vs_cpu(
            torch, lambda: fam.build(cfg), state, loss_fn, pred_key, _first(x, 2),
            _first(y, 2), cfg.learning_rate, device)
        check(loss_rel <= 1e-4, f"{family}: f32 train loss disagrees with the CPU: {loss_rel}")
        check(grad_err <= 1e-3, f"{family}: f32 gradients disagree with the CPU: {grad_err}")
        warm[family] = step
        return dict(model_kwargs=dict(model.kwargs),
                    parameters=sum(p.numel() for p in model.parameters()),
                    history=trainer.history, seconds=cli_s, chips_per_s_end_to_end=(
                        n_steps * batch / cli_s), step_vs_cpu=compared,
                    f32_loss_rel_err=loss_rel, f32_grad_max_abs_err_over_max_grad=grad_err,
                    peak_mem_gib=peak, **step_fields)

    zero_counts(pre, stitch)
    # ---- the ACNN from TFRecords, evaluated each epoch, then the evaluate CLI
    ckpt = os.path.join(work, "acnn_ckpt")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer, _, cli_s = run_cli(train_cli, [
        "--config", "landcover", "--model", "acnn", "--train", os.path.join(data, "train-*"),
        "--eval", eval_file, "--ckpt", ckpt, "--epochs", str(epochs), "--steps-per-epoch",
        str(steps), "--batch-size", str(batch), *extra_flags])
    sync(device)
    check(trainer.state.step == steps * epochs, f"acnn: {trainer.state.step} steps")
    losses = [r[part]["loss"] for r in trainer.history for part in ("train", "val")]
    check(all(math.isfinite(v) for v in losses), f"acnn: non-finite loss {losses}")
    blob = torch.load(os.path.join(ckpt, "best", "model.pt"), map_location="cpu",
                      weights_only=True)
    check(blob.get("arch") == "acnn", f"best/model.pt arch {blob.get('arch')!r}")
    preprocess = make_preprocess_fn(bands, cfg.response, axes=cfg.axes, splits=cfg.splits,
                                    response_depth=cfg.num_classes, device=device)
    raw = next(iter(get_eval_dataset([eval_file], bands + [cfg.response], kernel_size=k,
                                     batch_size=batch, device=device)))
    x, y = preprocess(raw, train=False)
    fields["acnn"] = measured("acnn", trainer, x, y, k, cli_s, steps * epochs)
    report, _, eval_s = run_cli(evaluate_cli, [
        "--config", "landcover", "--model", "acnn", "--ckpt", ckpt, "--eval", eval_file,
        *extra_flags])
    counts = np.asarray(report["counts"])
    check(counts.shape == (cfg.num_classes,) * 2 and counts.sum() == batch * k * k,
          f"acnn confusion counts {counts.shape} sum to {counts.sum()}, not {batch * k * k}")
    fields["acnn"].update(eval_seconds=eval_s, eval_pixels=int(counts.sum()),
                          eval_overall=report["overall"])

    # ---- the hierarchical model from npy chips
    npy = ["--unet-source", f"naip={naip}", "--series", series, "--series-dim",
           str(series_side), "--labels", labels]
    ckpt = os.path.join(work, "hierarchical_ckpt")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer, _, cli_s = run_cli(train_cli, [
        "--config", "landcover", "--model", "hierarchical", *npy, "--ckpt", ckpt,
        "--epochs", "1", "--steps-per-epoch", str(steps * epochs), "--batch-size", str(batch),
        *extra_flags])
    sync(device)
    check(trainer.state.step == steps * epochs, f"hierarchical: {trainer.state.step} steps")
    losses = [r["train"]["loss"] for r in trainer.history]
    check(all(math.isfinite(v) for v in losses), f"hierarchical: non-finite loss {losses}")
    blob = torch.load(os.path.join(ckpt, "best", "model.pt"), map_location="cpu",
                      weights_only=True)
    check(blob.get("arch") == "hierarchical", f"best/model.pt arch {blob.get('arch')!r}")
    sources = {"naip": ChipSource.named("naip", sorted(glob.glob(naip)))}
    lstm_dim = (cfg.n_time, series_side, series_side, len(bands))
    ds = HybridChipDataset(sources, s2_series_files=sorted(glob.glob(series)), lstm_dim=lstm_dim,
                           label_files=sorted(glob.glob(labels)), batch_size=batch,
                           unet_dim=(k, k), n_classes=cfg.num_classes, seed=seed)
    x, y = ds[0]
    sub = max(2, cfg.num_classes // 2)
    y = (y, np.eye(sub, dtype=np.float32)[np.minimum(np.argmax(y, -1) // 2, sub - 1)])
    fields["hierarchical"] = measured("hierarchical", trainer, x, y, k, cli_s, steps * epochs)

    # ---- the hybrid: at the preset's side it cannot be built, as in JAX
    try:
        run_cli(train_cli, ["--config", "landcover", "--model", "hybrid", *npy, "--ckpt",
                            os.path.join(work, "hybrid_cli_ckpt"), *extra_flags])
        failed = None
    except ValueError as e:
        failed = str(e)
    check(failed is not None and "does not survive the pool factors" in failed,
          f"the hybrid at {k}² did not fail with the pool-factor error: {failed}")
    check(not os.path.exists(os.path.join(work, "hybrid_cli_ckpt")),
          "the refused hybrid run wrote a checkpoint directory")
    fields["hybrid_at_preset_side"] = failed

    # ---- the hybrid at a side its pools round-trip, through the library
    fam = get_family("hybrid")
    model = build_empty(fam.build, cfg).to_empty(device="cpu")
    flax_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    loss_fn, pred_key = fam.loss(cfg)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(create_train_state(model, cfg.learning_rate), loss_fn, pred_key=pred_key,
                      num_classes=cfg.num_classes, monitor=cfg.monitor,
                      compute_dtype=torch.bfloat16 if dtype != "float32" else None)
    ds = HybridChipDataset(sources, s2_series_files=sorted(glob.glob(series)), lstm_dim=lstm_dim,
                           label_files=sorted(glob.glob(labels)), batch_size=batch,
                           unet_dim=(hybrid_side, hybrid_side), n_classes=cfg.num_classes,
                           seed=seed)

    def batches():
        while True:
            for item in ds:
                yield _to(item, device)

    t0 = time.perf_counter()
    trainer.fit(batches(), epochs=1, steps_per_epoch=steps * epochs, log_fn=lambda r: None)
    sync(device)
    fit_s = time.perf_counter() - t0
    check(trainer.state.step == steps * epochs, f"hybrid: {trainer.state.step} steps")
    check(math.isfinite(trainer.history[0]["train"]["loss"]), "hybrid: non-finite loss")
    x, y = ds[0]
    fields["hybrid"] = measured("hybrid", trainer, x, y, hybrid_side, fit_s, steps * epochs)
    fields["hybrid"]["unet_side"] = hybrid_side
    counts = kernel_counts(pre, stitch)
    fields["launches"] = counts
    return fields, counts, warm


# masking band names (JAX cloud/masking.py) of the synthetic L1C items, and
# the composite's bands in compositing's names (cloud/pc.py) with the
# masking name each is renamed from
S2_RAW_BANDS = ("B1", "B2", "B3", "B4", "B8", "B10", "B11", "B12")
COMPOSITE_BANDS = {"B02": "B2", "B03": "B3", "B04": "B4", "B08": "B8"}
# raw DN levels: vegetated land (raw cloud score < 0), bright cloud (score
# 100), and the dark vegetated block (B2 = 300 DN: score -0.175)
S2_LAND = {"B1": 1300.0, "B2": 800.0, "B3": 900.0, "B4": 700.0, "B8": 2800.0, "B10": 20.0,
           "B11": 1900.0, "B12": 1100.0}
S2_CLOUD = {"B1": 4000.0, "B2": 5000.0, "B3": 5000.0, "B4": 5200.0, "B8": 5500.0,
            "B10": 600.0, "B11": 3200.0, "B12": 2600.0}
S2_DARK = {"B1": 700.0, "B2": 300.0, "B3": 500.0, "B4": 300.0, "B8": 3500.0, "B10": 1200.0,
           "B11": 1600.0, "B12": 800.0}


def synthesize_s2_items(torch, pc, n, side, crop, date, seed, device="cuda"):
    """``n`` raw Sentinel-2 L1C items on ``device``: float32 DN planes keyed
    by the masking module's names plus QA60, made from a seeded
    ``torch.Generator`` there. Vegetated land (per-item levels, 5 % noise),
    12 bright cloud patches, QA60 bit 10 on 4 % and bit 11 on 2 % of the
    pixels; inside the top-left ``crop`` square a dark vegetated block
    (raw cloud score < 0) and a stripe where B3 = B11 = 0 (NaN indices, and
    masked as shadow in every item). Items dated after the 2022-01-25
    cutoff carry the +1000 offset on every reflectance band."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    offset = pc.S2_OFFSET if date >= pc.S2_HARMONIZE_CUTOFF else 0.0
    items = []
    for _ in range(n):
        bands = {}
        for b in S2_RAW_BANDS:
            level = S2_LAND[b] * rng.uniform(0.85, 1.15)
            noise = torch.randn((side, side), generator=gen, device=device)
            bands[b] = level + noise * (0.05 * S2_LAND[b] + 10.0)
        for _ in range(12):
            hh, ww = rng.integers(max(1, side // 64), max(2, side // 8), 2)
            y, x = rng.integers(0, side - hh), rng.integers(0, side - ww)
            for b in S2_RAW_BANDS:
                bands[b][y : y + hh, x : x + ww] = S2_CLOUD[b]
        for b in S2_RAW_BANDS:
            bands[b][crop // 8 : 3 * crop // 8, crop // 8 : crop // 2] = S2_DARK[b]
        for b in ("B3", "B11"):
            bands[b][:, 5 * crop // 8 : 5 * crop // 8 + max(2, crop // 128)] = 0.0
        for b in S2_RAW_BANDS:
            bands[b] = bands[b].clamp_(min=0.0) + offset
        u = torch.rand((side, side), generator=gen, device=device)
        bands["QA60"] = (u < 0.04).float() * 1024.0 + (u > 0.98).float() * 2048.0
        items.append({"datetime": date, "bands": bands})
    return items


def mask_item(torch, masking, pc, item):
    """One item through the acquisition path: harmonized (after the
    cutoff) before masking, the keep mask ``combined_mask &
    basic_qa_mask``, the composite's bands (renamed) ``apply_mask``-ed to
    NaN. Returns (harmonized bands, keep mask, (H, W, 4) masked layer)."""
    after = item["datetime"] >= pc.S2_HARMONIZE_CUTOFF
    bands = {k: v if k == "QA60" else pc.harmonize_to_old(v, after)
             for k, v in item["bands"].items()}
    keep = masking.combined_mask(bands) & masking.basic_qa_mask(bands["QA60"])
    kept = masking.apply_mask({n: bands[m] for n, m in COMPOSITE_BANDS.items()}, keep)
    return bands, keep, torch.stack([kept[n] for n in COMPOSITE_BANDS], dim=-1)


def bit_equal(torch, a, b):
    """Equal bits, NaN where NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def acquire_phase(torch, predict, stitch, pre, ckpt, work, side, n_items, crop, geometry,
                  seed=SEED, device="cuda"):
    """Imagery in, map out: ``n_items`` raw Sentinel-2 items of ``side``²
    before (2021-06) and after (2022-06) made on the device -> harmonize ->
    cloud/water/shadow and QA60 masks -> NaN-median composites -> per-pixel
    z-normalization, NaN filled with 0 -> the 8-band change pair ->
    ``cloud.pc.predict_scene(blend="hann")`` with the change checkpoint ->
    ``numpy_to_raster(cog=True)`` -> ``read_geotiff`` -> ``get_img_bounds``
    in EPSG:4326. The kernels' counts are set to 0 just before and read
    just after. Then the top-left ``crop``² of every item and composite on
    the device against the same code on the CPU, and the served stitch
    against its plain version on the path's own chip predictions. Returns
    (phase fields, launches)."""
    from satellite_computervision_tpu_torch.cloud import compositing, masking, pc
    from satellite_computervision_tpu_torch.geo import read_geotiff
    from satellite_computervision_tpu_torch.geo.assembly import numpy_to_raster
    from satellite_computervision_tpu_torch.geo.crs import transform_bounds
    from satellite_computervision_tpu_torch.inference.batch import get_img_bounds
    from satellite_computervision_tpu_torch.inference.mixer import MixerInfo
    from satellite_computervision_tpu_torch.train.config import CONFIGS

    kernel, buffer, batch = geometry
    cpu = torch.device("cpu")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_counts(pre, stitch)
    seconds = {}

    t0 = time.perf_counter()
    periods = {"before": synthesize_s2_items(torch, pc, n_items, side, crop, "2021-06-01",
                                             seed + 80, device),
               "after": synthesize_s2_items(torch, pc, n_items, side, crop, "2022-06-01",
                                            seed + 81, device)}
    sync(device)
    seconds["synthesis"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stacks, crops, kept_px = {}, [], 0
    for name, items in periods.items():
        layers = []
        for item in items:
            bands, keep, layer = mask_item(torch, masking, pc, item)
            layers.append(layer)
            kept_px += keep.sum()
            # the checked crop: raw and harmonized bands, and the mask
            crops.append((item["datetime"],
                          *({k: v[:crop, :crop].clone() for k, v in d.items()}
                            for d in (item["bands"], bands)), keep[:crop, :crop].clone()))
        stacks[name] = torch.stack(layers)
    sync(device)
    seconds["masks"] = time.perf_counter() - t0
    del periods, items, item, bands, keep, layer, layers

    t0 = time.perf_counter()
    pair = torch.cat([compositing.composite_stack(stacks[p], normalize=True, fill=0.0,
                                                  device=device) for p in stacks], dim=-1)
    sync(device)
    seconds["composite"] = time.perf_counter() - t0

    cfg = CONFIGS["change"]
    served = predict.load_model(ckpt, torch.device(device), cfg=cfg, arch="siamese")
    nb = len(COMPOSITE_BANDS)
    chip_preds = []

    def forward(chips):
        out = served(chips[..., :nb], chips[..., nb:])["probs"]
        chip_preds.append(out)
        return out

    t0 = time.perf_counter()
    prob = pc.predict_scene(pair, forward, kernel=kernel, buffer=buffer, batch_size=batch,
                            blend="hann", device=device)
    sync(device)
    seconds["predict"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prob_host = prob.cpu().numpy()
    affine = (10.0, 0.0, 500000.0, 0.0, -10.0, 3900000.0)
    path = os.path.join(work, "acquire_change.tif")
    numpy_to_raster(prob_host, {"transform": list(affine), "crs": "EPSG:32617"}, path, cog=True)
    back, meta = read_geotiff(path)
    mixer = MixerInfo(total_patches=1, patches_per_row=1, patch_dimensions=(side, side),
                      affine=tuple(meta["transform"]), crs=meta["crs"])
    bounds = get_img_bounds(back.shape, mixer, dst_crs="EPSG:4326")
    seconds["write"] = time.perf_counter() - t0
    launches = kernel_counts(pre, stitch)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    check(launches == {"hann_stitch": 1, "fused_preprocess": 0},
          f"acquire: kernel launches {launches}, expected one hann_stitch")

    # ---- where the device time of masking and compositing goes: the
    # after items made again and one period masked and composited under
    # the profiler
    profiled = None
    if device == "cuda":
        items = synthesize_s2_items(torch, pc, n_items, side, crop, "2022-06-01", seed + 81,
                                    device)

        def mask_and_composite():
            layers = [mask_item(torch, masking, pc, item)[2] for item in items]
            compositing.composite_stack(torch.stack(layers), normalize=True, fill=0.0,
                                        device=device)

        mask_and_composite()
        profiled = device_profile(torch, mask_and_composite)
        del items

    # ---- what came out: the map, its georeferencing and bounds
    check(pair.shape == (side, side, 2 * nb) and bool(torch.isfinite(pair).all()),
          f"change pair {tuple(pair.shape)} not finite")
    check(back.shape == (side, side, 1) and np.array_equal(back, prob_host),
          "the COG does not read back as written")
    check(np.isfinite(back).all() and back.min() >= 0.0 and back.max() <= 1.0,
          "probabilities not finite or outside [0, 1]")
    check(tuple(meta["transform"]) == affine and meta["crs"] == "EPSG:32617",
          f"georeferencing lost: {meta}")
    left, bottom, right, top = transform_bounds(
        affine[2], affine[5] + side * affine[4], affine[2] + side * affine[0], affine[5],
        "EPSG:32617", "EPSG:4326")
    check(bounds == [[bottom, left], [top, right]], f"bounds {bounds}")
    check(-84.0 < left < right < -78.0 and 34.0 < bottom < top < 36.0,
          f"EPSG:32617 bounds out of zone 17: {bounds}")

    # ---- the served stitch against its plain version on the path's own
    # chip predictions (launches made here are not the path's)
    rows = cols = -(-side // kernel)
    preds = torch.cat(chip_preds).float()[: rows * cols]
    canvas = stitch.hann_stitch(preds, kernel, rows, cols, apply_window=True)
    plain = stitch.hann_stitch_reference(preds, kernel, rows, cols, apply_window=True)
    half = buffer // 2
    stitch_err = (canvas - plain).abs().max().item()
    check(stitch_err == 0.0, f"hann_stitch differs from its plain version: {stitch_err}")
    check(torch.equal(canvas[half : half + side, half : half + side], prob),
          "predict_scene's map is not the stitched canvas")

    # ---- the crop of every item and composite against the CPU
    score_raw, nan_index, layers_cpu = [], [], {p: [] for p in stacks}
    for i, (date, raw, bands, keep) in enumerate(crops):
        p = "before" if i < n_items else "after"
        cb, ckeep, clayer = mask_item(torch, masking, pc, {
            "datetime": date, "bands": {k: v.to(cpu) for k, v in raw.items()}})
        layers_cpu[p].append(clayer)
        check(torch.equal(keep.to(cpu), ckeep), f"item {i}: the card's mask differs from the CPU's")
        check(torch.equal(masking.sentinel_cloud_score(bands).to(cpu),
                          masking.sentinel_cloud_score(cb)),
              f"item {i}: the card's uint8 cloud score differs from the CPU's")
        check(bit_equal(torch, stacks[p][i % n_items][:crop, :crop].to(cpu), clayer),
              f"item {i}: the card's masked bands differ from the CPU's")
        score_raw.append(int((masking.raw_cloud_score(cb) < 0).sum()))
        nan_index.append(int(torch.isnan(masking.normalized_difference(cb["B3"], cb["B11"])).sum()))
    check(all(score_raw) and all(nan_index),
          f"an item's crop lacks raw scores < 0 or NaN indices: {score_raw}, {nan_index}")
    composite = {}
    for p_i, p in enumerate(stacks):
        cstack = torch.stack(layers_cpu[p])
        counts = (~torch.isnan(cstack)).sum(0)
        card_med = compositing.median_composite(stacks[p][:, :crop, :crop], device=device)
        cpu_med = compositing.median_composite(cstack, device="cpu")
        check(bit_equal(torch, card_med.to(cpu), cpu_med),
              f"{p}: the card's median differs from the CPU's")
        check(bool(torch.isnan(cpu_med[counts == 0]).all()) and bool((counts == 0).any()),
              f"{p}: no all-masked pixel, or one that is not NaN")
        even = ((counts % 2 == 0) & (counts > 0)).any().item()
        odd = (counts % 2 == 1).any().item()
        check(even and odd, f"{p}: the crop lacks even or odd valid counts")
        card_norm = compositing.normalize_composite(card_med, device=device)
        cpu_norm = compositing.normalize_composite(cpu_med, device="cpu")
        norm_err = nan_aware_err(torch, card_norm.to(cpu), cpu_norm) / \
            cpu_norm.nan_to_num().abs().max().item()
        check(norm_err <= 1e-6, f"{p}: normalized composite {norm_err} relative from the CPU")
        filled = torch.where(torch.isnan(card_norm), 0.0, card_norm)
        check(torch.equal(pair[:crop, :crop, p_i * nb : (p_i + 1) * nb], filled),
              f"{p}: the full composite's crop differs from the crop's composite")
        composite[p] = dict(valid_counts=torch.bincount(counts.reshape(-1)).tolist(),
                            normalized_max_rel_err=norm_err)
    total = side * side * 2 * n_items
    path_s = seconds["masks"] + seconds["composite"] + seconds["predict"] + seconds["write"]
    fields = dict(
        items=[n_items, n_items], item_shape=[side, side, len(S2_RAW_BANDS) + 1],
        dates=["2021-06-01", "2022-06-01"], pair_shape=list(pair.shape),
        geometry=list(geometry), chips=rows * cols, launches=launches, seconds=seconds,
        path_seconds=path_s, mpix_per_s=side * side / 1e6 / path_s,
        item_mpix_per_s=total / 1e6 / path_s, masked_share=1.0 - int(kept_px) / total,
        peak_mem_gib=peak, profile_mask_and_composite_one_period=profiled,
        crop=crop, crop_pixels_raw_score_below_0=score_raw,
        crop_pixels_nan_index=nan_index, composite=composite,
        stitch_max_abs_err=stitch_err, output_min=float(back.min()),
        output_max=float(back.max()), crs=meta["crs"], bounds_epsg4326=bounds)
    return fields, launches


def calibrate_phase(torch, predict, stitch, pre, ckpt, shape, geometry, seed=SEED,
                    device="cuda"):
    """The multi-state sweep: one ``shape`` scene per state with the
    example's radiometric biases through ``equalize_collection`` (host
    numpy), then served with the solar checkpoint by
    ``predict_scene_batch`` (hann, uint8 out) and a confusion report per
    state. The kernels' counts are set to 0 just before serving and read
    just after. Returns (phase fields, launches)."""
    from satellite_computervision_tpu_torch.cloud.calibration import equalize_collection
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.multistate_sweep import (
        BIASES,
        STATES,
        state_report,
        synth_state,
    )

    kernel, buffer, batch = geometry
    rng = np.random.default_rng(seed + 90)
    scenes, truths = zip(*(synth_state(rng, b, *shape) for b in BIASES))
    t0 = time.perf_counter()
    calibrated = equalize_collection(list(scenes))
    host_s = time.perf_counter() - t0

    def spread(ss):  # each state's largest band-median gap to the first's
        return [float(np.abs(np.median(s, (0, 1)) - np.median(ss[0], (0, 1))).max())
                for s in ss[1:]]

    before, after = spread(scenes), spread(calibrated)
    check(all(a < b for a, b in zip(after, before)),
          f"calibration did not bring the states' medians together: {before} -> {after}")

    served = predict.load_model(ckpt, torch.device(device), fold_bn=True)
    engine = TiledInferenceEngine(lambda c: served(c)["probs"], kernel=kernel, buffer=buffer,
                                  batch_size=batch, blend="hann", device=device,
                                  output_transform=lambda p: (p * 255.0).to(torch.uint8))
    stack = np.stack(calibrated)
    zero_counts(pre, stitch)
    sync(device)
    t0 = time.perf_counter()
    preds = engine.predict_scene_batch(stack)
    sync(device)
    serve_s = time.perf_counter() - t0
    launches = kernel_counts(pre, stitch)
    check(launches == {"hann_stitch": len(BIASES), "fused_preprocess": 0},
          f"calibrate: kernel launches {launches}, expected one hann_stitch per scene")
    preds = preds.cpu().numpy()
    check(preds.dtype == np.uint8 and preds.shape == (len(BIASES),) + shape[:2] + (1,),
          f"predictions {preds.dtype} {preds.shape}")
    report = state_report(preds, truths)
    check(list(report) == STATES and all(0.0 <= s["accuracy"] <= 1.0 for s in report.values()),
          f"report {report}")
    mpix = len(BIASES) * shape[0] * shape[1] / 1e6
    return dict(states=STATES, biases=list(BIASES), scene=list(shape), geometry=list(geometry),
                median_spread_before=before, median_spread_after=after,
                calibration_host_seconds=host_s, serve_seconds=serve_s,
                serve_mpix_per_s=mpix / serve_s, launches=launches, report=report), launches


def _state_equal(torch, a, b):
    """Every tensor of two ``state_dict``s bit-equal (same keys)."""
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _grads(torch, model):
    from satellite_computervision_tpu_torch.train.checkpoint import unwrap

    return {n: p.grad.detach().float().clone() for n, p in unwrap(model).named_parameters()}


def _max_rel(a, b):
    """max |a - b| over max |b| of two dicts of tensors (same keys)."""
    scale = max(v.abs().max().item() for v in b.values())
    return max((a[k] - v).abs().max().item() for k, v in b.items()) / scale


def dp_train_part(torch, pre, stitch, mesh, train_files, cfg, steps, device, seed=SEED):
    """The data-parallel solar step at ``cfg``'s full width: TFRecord
    batches (one pass, cycled) through the fused preprocess (``axes=(0,
    1)``) and
    ``make_parallel_train_step`` (DDP, global-batch BatchNorm), ``steps``
    steps; the plain ``make_train_step`` on the same batches from the same
    weights beside it; one float32 step of each held against the other
    (loss within 1e-4 relative, gradients within 1e-3 x max|grad|).
    Returns (fields, the counts of the DP path, its batches)."""
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        make_preprocess_fn,
    )
    from satellite_computervision_tpu_torch.models.unet import flax_init_
    from satellite_computervision_tpu_torch.parallel import (
        make_parallel_train_step,
        shard_batch,
        shard_train_state,
    )
    from satellite_computervision_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )
    from satellite_computervision_tpu_torch.train.zoo import get_family

    family = get_family("unet")
    k, batch, bands = cfg.kernel_size, cfg.train_batch, list(cfg.bands)
    init = flax_init_(family.build(cfg, bn_momentum=0.9), torch.Generator().manual_seed(seed + 200))
    loss_fn, pred_key = family.loss(cfg)
    bf16 = torch.bfloat16 if device == "cuda" else None
    preprocess = make_preprocess_fn(bands, cfg.response, axes=(0, 1), device=device)
    check(preprocess.fused, "axes=(0, 1) must take the fused_preprocess route")
    draw = torch.Generator().manual_seed(seed + 201)
    # one pass over the files, its reader thread done before any step is
    # timed (a repeating reader decodes ahead on the host while the steps
    # run); the batches cycle, each augmented anew
    raws = list(get_eval_dataset(train_files, bands + [cfg.response], kernel_size=k,
                                 batch_size=batch, device=device))
    raws = [raws[i % len(raws)] for i in range(steps)]

    def build(dp, lr=cfg.learning_rate):
        model = copy.deepcopy(init).to(device, memory_format=torch.channels_last)
        state = create_train_state(model, lr)
        return shard_train_state(state, mesh) if dp else state

    def run(step, state, batches):
        times, losses = [], []
        for x, y in batches:
            sync(device)
            t = time.perf_counter()
            losses.append(float(step(state, (x, y))["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
        return times, losses

    # ---- the path, with the counts set to 0 just before and read just after
    zero_counts(pre, stitch)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dp_state = build(True)
    dp_step = make_parallel_train_step(loss_fn, mesh, pred_key=pred_key, compute_dtype=bf16)
    batches = [preprocess(raw, draw, train=True) for raw in raws]
    dp_ms, dp_losses = run(dp_step, dp_state, [shard_batch(b, mesh) for b in batches])
    counts = kernel_counts(pre, stitch)
    check(counts == {"hann_stitch": 0, "fused_preprocess": steps},
          f"dp_train: kernel launches {counts}, expected {steps} fused_preprocess")
    dp_peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    plain_state = build(False)
    plain_step = make_train_step(loss_fn, pred_key, compute_dtype=bf16)
    plain_ms, plain_losses = run(plain_step, plain_state, batches)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    check(all(math.isfinite(v) for v in dp_losses + plain_losses),
          f"non-finite loss: {dp_losses} {plain_losses}")

    # ---- one float32 step of each from the same weights on the same batch
    f32 = []
    for dp in (True, False):
        state = build(dp)
        step = (make_parallel_train_step(loss_fn, mesh, pred_key=pred_key) if dp
                else make_train_step(loss_fn, pred_key))
        f32.append((float(step(state, batches[0])["loss"]), _grads(torch, state.model)))
        del state
    (dp_loss, dp_g), (plain_loss, plain_g) = f32
    loss_rel = abs(dp_loss - plain_loss) / abs(plain_loss)
    grad_err = _max_rel(dp_g, plain_g)
    check(loss_rel <= 1e-4, f"the DP step's f32 loss disagrees with the plain step's: {loss_rel}")
    check(grad_err <= 1e-3, f"the DP step's f32 gradients disagree: {grad_err}")

    fields = dict(config=cfg.name, chips=[batch, k, k, len(bands)], steps=steps,
                  dtype="bfloat16 autocast" if bf16 else "float32", launches=counts,
                  dp_step_ms=dp_ms, plain_step_ms=plain_ms,
                  dp_step_ms_median_warm=median(dp_ms[1:]),
                  plain_step_ms_median_warm=median(plain_ms[1:]),
                  dp_losses=dp_losses, plain_losses=plain_losses,
                  bf16_first_loss_rel_diff=abs(dp_losses[0] - plain_losses[0]) / abs(plain_losses[0]),
                  f32_losses=[dp_loss, plain_loss], f32_loss_rel_err=loss_rel,
                  f32_grad_max_abs_err_over_max_grad=grad_err,
                  dp_peak_mem_gib=dp_peak, plain_peak_mem_gib=plain_peak)
    if device == "cuda":
        for name, step, state in (("dp", dp_step, dp_state), ("plain", plain_step, plain_state)):
            prof = device_profile(torch, lambda: step(state, batches[0]), calls=3)
            fields[f"{name}_busy_share"] = prof["device_busy_share"]
            fields[f"{name}_device_launches_per_step"] = prof["device_launches"] / 3
            fields[f"{name}_profile_top"] = prof["top"][:6]
    return fields, counts, batches


def remat_part(torch, pre, stitch, work, train_glob, eval_file, cfg, steps, batch, device,
               extra_flags=(), seed=SEED):
    """``train --config parking --model unet --remat --orbax`` through the
    CLI (the full-width U-Net at ``cfg``'s chips), its DCP checkpoint
    restored into a fresh model bit-equal; then 2 steps with remat and 2
    without from the same weights on one batch: the losses within 1e-4
    relative and the BatchNorm buffers within 1e-6, peak memory and step
    time of each. Returns (fields, the counts of the CLI run)."""
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        make_preprocess_fn,
    )
    from satellite_computervision_tpu_torch.models.unet import flax_init_
    from satellite_computervision_tpu_torch.train import __main__ as train_cli
    from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager
    from satellite_computervision_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )
    from satellite_computervision_tpu_torch.train.zoo import get_family

    family = get_family("unet")
    ckpt = os.path.join(work, "remat_ckpt")
    zero_counts(pre, stitch)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer, text, cli_s = run_cli(train_cli, [
        "--config", "parking", "--model", "unet", "--train", train_glob, "--eval", eval_file,
        "--ckpt", ckpt, "--epochs", "1", "--steps-per-epoch", str(steps), "--batch-size",
        str(batch), "--remat", "--orbax", *extra_flags])
    sync(device)
    counts = kernel_counts(pre, stitch)
    cli_peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    model = trainer.state.model
    check(model.remat and "remat True" in text, "the CLI did not build a remat U-Net")
    check(trainer.state.step == steps, f"{trainer.state.step} steps")
    files = sorted(os.listdir(os.path.join(ckpt, "best")))
    check(".metadata" in files and "scv_meta.json" in files and "model.pt" not in files,
          f"best/ is not a torch.distributed.checkpoint: {files}")
    fresh = create_train_state(
        family.build(cfg, bn_momentum=0.9, remat=True).to(device, memory_format=torch.channels_last),
        cfg.learning_rate)
    _, meta = CheckpointManager(ckpt, backend="dcp").restore(fresh, "best")
    restored_equal = _state_equal(torch, model.state_dict(), fresh.model.state_dict())
    check(restored_equal, "the DCP checkpoint did not restore bit-equal")

    # ---- remat against plain in the library: same weights, same batch
    loss_fn, pred_key = family.loss(cfg)
    bands = list(cfg.bands)
    raw = next(iter(get_eval_dataset([eval_file], bands + [cfg.response],
                                     kernel_size=cfg.kernel_size, batch_size=batch,
                                     device=device)))
    x, y = make_preprocess_fn(bands, cfg.response, axes=cfg.axes, device=device)(raw, train=False)
    init = flax_init_(family.build(cfg, bn_momentum=0.9), torch.Generator().manual_seed(seed + 210))
    bf16 = torch.bfloat16 if device == "cuda" else None
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # one algorithm, run to run
    try:
        for remat in (True, False):
            m = family.build(cfg, bn_momentum=0.9, remat=remat)
            m.load_state_dict(init.state_dict())
            state = create_train_state(m.to(device, memory_format=torch.channels_last),
                                       cfg.learning_rate)
            step = make_train_step(loss_fn, pred_key, compute_dtype=bf16)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for _ in range(2):
                sync(device)
                t = time.perf_counter()
                losses.append(float(step(state, (x, y))["loss"]))
                times.append((time.perf_counter() - t) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
            buffers = {n: b.detach().float().clone() for n, b in state.model.named_buffers()}
            runs["remat" if remat else "plain"] = (losses, times, peak, buffers)
            del state, m
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (r_loss, r_ms, r_peak, r_buf), (p_loss, p_ms, p_peak, p_buf) = runs["remat"], runs["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r_loss, p_loss))
    buf_err = max((r_buf[n] - v).abs().max().item() for n, v in p_buf.items())
    check(loss_rel <= 1e-4, f"remat loss disagrees with the plain step's: {loss_rel}")
    check(buf_err <= 1e-6, f"remat BatchNorm buffers disagree with the plain step's: {buf_err}")
    return dict(config=cfg.name, chips=[batch, cfg.kernel_size, cfg.kernel_size, len(bands)],
                cli_seconds=cli_s, cli_steps=steps, cli_peak_mem_gib=cli_peak,
                launches=counts, dcp_files=files, dcp_meta=meta, dcp_restored_bit_equal=True,
                remat_losses=r_loss, plain_losses=p_loss, loss_max_rel_diff=loss_rel,
                bn_buffers_max_abs_diff=buf_err, remat_step_ms=r_ms, plain_step_ms=p_ms,
                remat_peak_mem_gib=r_peak, plain_peak_mem_gib=p_peak), counts


def retrain_part(torch, pre, stitch, train_ckpt, eval_file, batch_xy, cfg, steps, device,
                 seed=SEED):
    """``retrain`` from the solar training checkpoint with
    ``freeze_to="head"``: the best metric seeded from an eval (through the
    fused preprocess), ``steps`` steps, the head moved and every other
    parameter bit-unchanged. Returns (fields, counts)."""
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        make_preprocess_fn,
    )
    from satellite_computervision_tpu_torch.models.unet import flax_init_
    from satellite_computervision_tpu_torch.train.checkpoint import load_checkpoint
    from satellite_computervision_tpu_torch.train.retrain import retrain
    from satellite_computervision_tpu_torch.train.trainer import create_train_state
    from satellite_computervision_tpu_torch.train.zoo import get_family

    loss_fn, pred_key = get_family("unet").loss(cfg)
    model, _ = load_checkpoint(train_ckpt)
    # other weights than the checkpoint's: the restore must bring them
    model = flax_init_(model.train(), torch.Generator().manual_seed(seed + 220))
    model = model.to(device, memory_format=torch.channels_last)
    bands = list(cfg.bands)
    preprocess = make_preprocess_fn(bands, cfg.response, axes=(0, 1), device=device)
    zero_counts(pre, stitch)
    evals = [preprocess(raw, train=False) for raw in get_eval_dataset(
        [eval_file], bands + [cfg.response], kernel_size=cfg.kernel_size,
        batch_size=cfg.train_batch, device=device)]
    trainer = retrain(create_train_state(model, cfg.learning_rate), loss_fn,
                      checkpoint_path=os.path.join(train_ckpt, "best"), eval_iter=evals,
                      freeze_to="head", pred_key=pred_key, monitor=cfg.monitor,
                      compute_dtype=torch.bfloat16 if device == "cuda" else None)
    seeded = trainer.best
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = [float(trainer.train_step(trainer.state, batch_xy)["loss"]) for _ in range(steps)]
    sync(device)
    counts = kernel_counts(pre, stitch)
    check(counts["fused_preprocess"] == len(evals), f"retrain: kernel launches {counts}")
    moved = sorted(n for n, p in model.named_parameters() if not torch.equal(p, before[n]))
    check(moved == ["head.bias", "head.weight"], f"retrain moved {moved}, not the head alone")
    check(math.isfinite(seeded) and all(math.isfinite(v) for v in losses),
          f"retrain: best {seeded}, losses {losses}")
    return dict(freeze_to="head", steps=steps, seeded_best=seeded, monitor=cfg.monitor,
                losses=losses, moved=moved, frozen_bit_unchanged=len(before) - len(moved),
                launches=counts), counts


def spatial_bands(h, kernel, buffer, max_rows, halo_rows=2):
    """The bands of ``parallel/spatial.py``'s banded hann run over a scene
    ``h`` rows tall (one hann_stitch each per rank)."""
    rows_total = -(-h // kernel)
    if h <= max_rows:
        return 1
    return -(-rows_total // ((max_rows - buffer) // kernel - 2 * halo_rows))


def spatial_part(torch, pre, stitch, mesh, train_ckpt, scene, swath, max_rows, geometry,
                 device):
    """``make_spatial_inference(blend="hann")`` with the solar training
    checkpoint (folded BN; bf16 on the card) over ``scene`` and, banded by
    ``max_rows``, over ``swath``, each against the engine's
    ``predict_scene`` (within 1e-2 in bf16), and one float32 case (within
    1e-3); ``hann_stitch`` on the first band's own chips with the row
    weights bit-equal to its plain version; one launch per band. Returns
    (fields, counts over the three runs, the engine's scene prediction,
    the served forward)."""
    from satellite_computervision_tpu_torch import predict
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.parallel import make_spatial_inference
    from satellite_computervision_tpu_torch.parallel import spatial as spatial_mod

    kernel, buffer, batch = geometry
    served = predict.load_model(train_ckpt, torch.device(device), fold_bn=True)
    served32 = predict.load_model(train_ckpt, torch.device("cpu"), fold_bn=True).to(device)

    def fwd(m):
        return lambda c: m(c)["probs"]

    geo = dict(kernel=kernel, buffer=buffer, batch_size=batch, blend="hann", device=device)
    recorded = []
    real = spatial_mod.hann_stitch

    def recording(chips, *args, **kwargs):
        if not recorded:
            recorded.append((chips.clone(), args, kwargs))
        return real(chips, *args, **kwargs)

    cases, counts = {}, {"hann_stitch": 0, "fused_preprocess": 0}
    want_scene = None
    for name, model, data, rows, tol in (("scene", served, scene, None, 1e-2),
                                         ("swath", served, swath, max_rows, 1e-2),
                                         ("scene_f32", served32, scene, None, 1e-3)):
        engine = TiledInferenceEngine(fwd(model), max_rows=rows, **geo)
        want = engine.predict_scene(data)
        run = make_spatial_inference(fwd(model), mesh, max_rows=rows, **geo)
        spatial_mod.hann_stitch = recording
        try:
            zero_counts(pre, stitch)
            sync(device)
            t0 = time.perf_counter()
            got = run(data)
            sync(device)
            seconds = time.perf_counter() - t0
            launches = kernel_counts(pre, stitch)
        finally:
            spatial_mod.hann_stitch = real
        bands = spatial_bands(data.shape[0], kernel, buffer, rows or data.shape[0])
        check(launches == {"hann_stitch": bands, "fused_preprocess": 0},
              f"spatial {name}: kernel launches {launches}, expected {bands} hann_stitch")
        counts["hann_stitch"] += launches["hann_stitch"]
        check(tuple(got.shape) == data.shape[:2] + (1,), f"spatial {name}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()) and 0.0 <= float(got.min()) and
              float(got.max()) <= 1.0, f"spatial {name}: outputs outside [0, 1]")
        err = (got.float() - want.float()).abs().max().item()
        check(err <= tol, f"spatial {name} disagrees with the engine: {err} > {tol}")
        engine_s = median(wall_ms(lambda: engine.predict_scene(data), iters=3, device=device))
        cases[name] = dict(shape=list(data.shape), max_rows=rows, bands=bands,
                           launches=launches, max_abs_err_vs_engine=err, tolerance=tol,
                           seconds=seconds, engine_ms=engine_s,
                           spatial_ms=median(wall_ms(lambda: run(data), iters=3, device=device)))
        if name == "scene":
            want_scene = want
    # the first band's stitch against its plain version (not counted)
    chips, args, kwargs = recorded[0]
    stitch_err = (stitch.hann_stitch(chips, *args, **kwargs)
                  - stitch.hann_stitch_reference(chips, *args, **kwargs)).abs().max().item()
    check(stitch_err == 0.0, f"hann_stitch with row weights is not bit-equal: {stitch_err}")
    return dict(cases=cases, stitch_row_weights_max_abs_err=stitch_err,
                stitch_shape=list(chips.shape), launches=counts), counts, want_scene, fwd(served)


def sharded_engine_part(torch, pre, stitch, mesh, scene, want, fwd, geometry, device):
    """``cloud.pc.predict_scene(mesh=...)`` over ``scene``: bit-equal to the
    unsharded engine at world size 1. Returns (fields, counts)."""
    from satellite_computervision_tpu_torch.cloud import pc

    kernel, buffer, batch = geometry
    zero_counts(pre, stitch)
    sync(device)
    t0 = time.perf_counter()
    got = pc.predict_scene(scene, fwd, kernel=kernel, buffer=buffer, batch_size=batch,
                           mesh=mesh, blend="hann", device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    counts = kernel_counts(pre, stitch)
    check(counts == {"hann_stitch": 1, "fused_preprocess": 0},
          f"sharded engine: kernel launches {counts}")
    check(torch.equal(got, want), "the sharded engine is not bit-equal to the engine")
    return dict(shape=list(scene.shape), seconds=seconds, bit_equal_to_engine=True,
                launches=counts), counts


def parallel_phase(torch, pre, stitch, work, inputs, solar_cfg, parking_cfg, geometry,
                   dp_steps=6, remat_steps=2, remat_batch=16, retrain_steps=3, extra_flags=(),
                   device="cuda"):
    """Parallel training and serving in a one-rank process group (NCCL on
    the card, gloo on the CPU), opened here and destroyed at the end:
    ``dp_train``, ``remat``, ``retrain``, ``spatial`` and
    ``sharded_engine`` (see each part). ``inputs``: the earlier phases'
    solar TFRecords (``train_files``, ``eval_file``), checkpoint
    (``train_ckpt``), parking TFRecords (``parking_glob``,
    ``parking_eval``), ``scene`` and ``swath`` arrays and ``max_rows``.
    Returns (fields, counts by path)."""
    import torch.distributed as dist

    from satellite_computervision_tpu_torch.parallel import initialize_distributed, make_mesh

    init = os.path.join(work, "pg_init")
    if os.path.exists(init):
        os.remove(init)
    initialize_distributed(f"file://{init}", device=device, timeout=600)
    try:
        mesh = make_mesh()
        fields = dict(backend=dist.get_backend(), world_size=dist.get_world_size())
        fields["dp_train"], dp_counts, batches = dp_train_part(
            torch, pre, stitch, mesh, inputs["train_files"], solar_cfg, dp_steps, device)
        fields["remat"], remat_counts = remat_part(
            torch, pre, stitch, work, inputs["parking_glob"], inputs["parking_eval"],
            parking_cfg, remat_steps, remat_batch, device, extra_flags)
        fields["retrain"], retrain_counts = retrain_part(
            torch, pre, stitch, inputs["train_ckpt"], inputs["eval_file"], batches[0],
            solar_cfg, retrain_steps, device)
        fields["spatial"], spatial_counts, want, fwd = spatial_part(
            torch, pre, stitch, mesh, inputs["train_ckpt"], inputs["scene"], inputs["swath"],
            inputs["max_rows"], geometry, device)
        fields["sharded_engine"], sharded_counts = sharded_engine_part(
            torch, pre, stitch, mesh, inputs["scene"], want, fwd, geometry, device)
    finally:
        dist.destroy_process_group()
    counts = {"parallel.dp_train": dp_counts, "parallel.remat": remat_counts,
              "parallel.retrain": retrain_counts, "parallel.spatial": spatial_counts,
              "parallel.sharded_engine": sharded_counts}
    return fields, counts


# the reference-layout solar U-Net of the h5 phase: the reference's
# widths, no space-to-depth stem, one conv per block (its conv_block quirk)
H5_UNET = dict(filters=(32, 64, 128, 256, 512), factors=(2, 2, 2, 2, 2), convs_per_block=1)
# the other .h5 families: (zoo family, preset, exporter / loader suffix)
H5_FAMILIES = (("siamese", "change", "siamese"), ("convlstm", "timeseries", "lstm"),
               ("lstm_autoencoder", "timeseries", "lstm_autoencoder"),
               ("hybrid", "landcover", "hybrid"))


def _payload_bytes(layers):
    return int(sum(a.nbytes for _, weights in layers for _, a in weights))


def _forget_quarters(model):
    """The state_dict keys and slices of the ConvLSTM forget-gate biases,
    which a Keras round trip stores as b + 1 and reads back as (b + 1) - 1."""
    out = {}
    for name, mod in model.named_modules():
        if name.endswith("cell"):
            f = mod.features
            out[f"{name}.input_conv.bias"] = slice(f, 2 * f)
    return out


def eval_inputs(cfg, files, device, batch_size=16):
    """The eval records' preprocessed chips, batch by batch, as the
    evaluate CLI feeds them (no augmentation)."""
    from satellite_computervision_tpu_torch.data.pipeline import (
        get_eval_dataset,
        make_preprocess_fn,
    )

    preprocess = make_preprocess_fn(list(cfg.bands), cfg.response, axes=cfg.axes,
                                    splits=cfg.splits, augment=False, device=device)
    for raw in get_eval_dataset(files, list(cfg.bands) + [cfg.response],
                                kernel_size=cfg.kernel_size, batch_size=batch_size,
                                device=device):
        yield preprocess(raw, train=False)[0]


def calibrate_head_(torch, model, cfg, files, device, share=0.2):
    """Shift ``model``'s head bias so that about ``share`` of the pixels of
    the first eval batch score above the preset's threshold (random weights
    alone score none, and a report of one predicted class would hold the
    folded and unfolded evaluations to nothing). Leaves ``model`` on the
    CPU."""
    x = next(eval_inputs(cfg, files[:1], device, batch_size=4))
    with torch.no_grad():
        logits = model.to(device)(x)["logits"].float().flatten()
        cut = torch.quantile(logits[:: max(1, logits.numel() // 100000)], 1.0 - share).item()
        model.head.bias += math.log(cfg.threshold / (1.0 - cfg.threshold)) - cut
    model.cpu()


def h5_phase(torch, predict, evaluate_cli, stitch, pre, work, eval_glob, scene, geometry,
             smi, device="cuda", seed=SEED, hybrid_side=LANDCOVER_HYBRID_SIDE, h5_files=None):
    """The Keras ``.h5`` bridge at full width: a reference-layout solar
    U-Net out to the reference's layout and back, evaluated and served;
    the other four families out and back. With ``h5py`` (``h5_files``
    None: present or not) the U-Net goes through the ``export`` CLI, the
    ``evaluate --h5`` CLI and ``compat.get_blob_model`` on a ``file://``
    URL; without it the same exporters, loaders and ``load_h5_model``
    take the layers in memory (what the file would hold). Returns (fields,
    counts)."""
    import dataclasses
    import importlib.util

    from satellite_computervision_tpu_torch import compat
    from satellite_computervision_tpu_torch import export as export_cli
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.models import UNet, fold_unet
    from satellite_computervision_tpu_torch.ops import chips as ops_chips
    from satellite_computervision_tpu_torch.train import keras_export, keras_import
    from satellite_computervision_tpu_torch.train.checkpoint import build_empty, save_checkpoint
    from satellite_computervision_tpu_torch.train.config import CONFIGS
    from satellite_computervision_tpu_torch.train.zoo import get_family

    if h5_files is None:
        h5_files = importlib.util.find_spec("h5py") is not None
    dev = torch.device(device)
    cfg = CONFIGS["solar"]
    gen = torch.Generator().manual_seed(seed + 40)
    root = os.path.join(work, "h5")
    os.makedirs(root, exist_ok=True)
    zero_counts(pre, stitch)
    t_phase = time.perf_counter()
    fields = dict(h5py="present" if h5_files else "absent", nvidia_smi=smi)

    # ---- the U-Net out to .h5 and back
    files = sorted(glob.glob(eval_glob))
    check(files, f"no eval records at {eval_glob}")
    model = UNet(len(cfg.bands), n_classes=1, head="sigmoid", threshold=cfg.threshold,
                 **H5_UNET).eval()
    randomize_(model, gen)
    calibrate_head_(torch, model, cfg, files, dev)
    ckpt = os.path.join(root, "ckpt")
    save_checkpoint(ckpt, model, {"seed": seed})
    h5_path = os.path.join(root, "solar_unet.h5")
    t0 = time.perf_counter()
    if h5_files:
        run_cli(export_cli, ["--config", "solar", "--ckpt", ckpt, "--out", h5_path,
                             "--device", device])
        layers = keras_import.keras_layers(h5_path)
        h5_bytes = os.path.getsize(h5_path)
    else:
        with contextlib.redirect_stdout(sys.stderr):
            layers = keras_export.keras_unet_layers(
                predict.load_model(ckpt, dev, cfg=cfg, dtype=torch.float32))
        h5_bytes = "not measured (h5py absent)"
    export_s = time.perf_counter() - t0
    arch = keras_import.infer_unet_arch(layers)
    want_arch = dict(bands=len(cfg.bands), filters=H5_UNET["filters"],
                     factors=H5_UNET["factors"], convs_per_block=1, n_classes=1)
    check(arch == want_arch, f"infer_unet_arch gave {arch}, not {want_arch}")
    t0 = time.perf_counter()
    back = keras_import.load_keras_unet_h5(
        layers, build_empty(UNet, arch["bands"], n_classes=1, head="sigmoid",
                            threshold=cfg.threshold, filters=arch["filters"],
                            factors=arch["factors"], convs_per_block=1))
    import_s = time.perf_counter() - t0
    want_state = model.state_dict()
    check(all(torch.equal(v, want_state[k]) for k, v in back.state_dict().items()
              if not k.endswith("num_batches_tracked")),
          "the re-imported U-Net state_dict is not bit-equal to the original")
    fields["unet"] = dict(arch={k: list(v) if isinstance(v, tuple) else v
                                for k, v in arch.items()},
                          layers=len(layers), weight_bytes=_payload_bytes(layers),
                          h5_bytes=h5_bytes, export_seconds=export_s, import_seconds=import_s,
                          state_bit_equal=True)

    # ---- evaluate: --ckpt, --h5 --no-fold, --h5 folded on the eval records
    reports, seconds = {}, {}
    for mode in ("ckpt", "h5_no_fold", "h5_folded"):
        t0 = time.perf_counter()
        if mode == "ckpt" or h5_files:
            source = ["--ckpt", ckpt] if mode == "ckpt" else ["--h5", h5_path]
            flags = ["--no-fold"] if mode == "h5_no_fold" else []
            report, _, _ = run_cli(evaluate_cli, ["--config", "solar", "--eval", eval_glob,
                                                  "--device", device] + source + flags)
        else:
            with contextlib.redirect_stdout(sys.stderr):
                served = evaluate_cli.load_h5_model(layers, cfg, dev,
                                                    fold=mode == "h5_folded")
            report = evaluate_cli.confusion_report(served, cfg, files, dev)
        sync(device)
        seconds[mode] = time.perf_counter() - t0
        reports[mode] = np.asarray(report["counts"])
    total = int(reports["ckpt"].sum())
    check(all(int(c.sum()) == total for c in reports.values()), "eval pixel counts differ")
    check(np.array_equal(reports["h5_no_fold"], reports["ckpt"]),
          f"evaluate --h5 --no-fold {reports['h5_no_fold'].tolist()} differs from "
          f"--ckpt {reports['ckpt'].tolist()}")
    check(reports["ckpt"][:, 1].sum() > 0 and reports["ckpt"][:, 0].sum() > 0,
          f"one class predicted: {reports['ckpt'].tolist()}")
    moved = int(np.abs(reports["h5_folded"] - reports["ckpt"]).sum() // 2)
    # folded BN in bfloat16 rounds other products than the live BN, so a
    # pixel near the threshold may change class: each moved pixel must be
    # one whose float32 probability lies within 1e-2 of the threshold (the
    # bound of tests/test_torch_evaluate.py for bfloat16 against float32)
    f32 = predict.to_serving(back, dev, torch.float32)
    near = 0
    with torch.inference_mode():
        for x in eval_inputs(cfg, files, dev):
            near += int(((f32(x)["probs"] - cfg.threshold).abs() < 1e-2).sum())
    check(moved <= near, f"folded evaluate moved {moved} of {total} pixels; only {near} "
          "lie within 1e-2 of the threshold in float32")
    fields["evaluate"] = dict(counts={k: v.tolist() for k, v in reports.items()},
                              eval_pixels=total, folded_pixels_moved=moved,
                              folded_moved_share=moved / total,
                              f32_pixels_near_threshold=near, seconds=seconds,
                              via="CLI" if h5_files else "load_h5_model + confusion_report")

    # ---- serve the imported weights over the slice scene
    t0 = time.perf_counter()
    if h5_files:
        url = "file://" + os.path.abspath(h5_path)
        served = compat.get_blob_model(weights_url=url, target=build_empty(
            UNet, arch["bands"], n_classes=1, head="sigmoid", threshold=cfg.threshold,
            filters=arch["filters"], factors=arch["factors"], convs_per_block=1),
            family="unet")
    else:
        served = back
    served = predict.to_serving(fold_unet(served), dev)
    load_s = time.perf_counter() - t0
    kernel, buffer, batch = geometry
    chip_preds = []

    def probs(chips):
        with torch.inference_mode():
            out = served(chips)["probs"]
        chip_preds.append(out)
        return out

    engine = TiledInferenceEngine(probs, kernel=kernel, buffer=buffer, batch_size=batch,
                                  blend="hann", device=device)
    t0 = time.perf_counter()
    hann_out = engine.predict_scene(scene)
    sync(device)
    hann_s = time.perf_counter() - t0
    h, w = scene.shape[:2]
    check(hann_out.shape == (h, w, 1) and bool(torch.isfinite(hann_out).all())
          and float(hann_out.min()) >= 0.0 and float(hann_out.max()) <= 1.0,
          "the h5 U-Net's scene is not finite probabilities of the scene's shape")
    chip_preds.clear()

    def plain_probs(chips):  # the same forward without the capture
        with torch.inference_mode():
            return served(chips)["probs"]

    t0 = time.perf_counter()
    summed = compat.predict_chips(scene, None, np.zeros((h, w, 1), np.float32), plain_probs,
                                  kernel=kernel, buff=buffer, device=device)
    sync(device)
    chips_s = time.perf_counter() - t0
    counts = kernel_counts(pre, stitch)
    check(counts["hann_stitch"] == 1, f"hann_stitch launched {counts} times on the h5 path")

    # held against their plain versions (launches not counted): the
    # engine's stitch on its own chip predictions, and predict_chips
    # against the ops.chips per-chip loop
    engine.predict_scene(scene)
    rows, cols = -(-h // kernel), -(-w // kernel)
    preds = torch.cat(chip_preds).float()[: rows * cols]
    canvas = stitch.hann_stitch(preds, kernel, rows, cols, apply_window=True)
    plain = stitch.hann_stitch_reference(preds, kernel, rows, cols, apply_window=True)
    stitch_err = (canvas - plain).abs().max().item()
    check(stitch_err == 0.0, f"hann_stitch differs from its plain version: {stitch_err}")
    half = buffer // 2
    check(torch.equal(canvas[half:half + h, half:half + w], hann_out),
          "the engine's map is not the stitched canvas")
    idx = ops_chips.generate_chip_indices(h, w, kernel, buffer, mode="reference")
    scene_dev = torch.from_numpy(np.asarray(scene)).to(dev)
    chips = ops_chips.extract_chips(scene_dev, idx, kernel, buffer)
    # batches as the engine makes them: the last one filled up with its
    # final chip, so each forward sees the same batch on either side
    filled = torch.cat([chips, chips[-1:].expand((-len(chips)) % batch, *chips.shape[1:])])
    loop_preds = torch.cat([plain_probs(filled[i:i + batch]).float()
                            for i in range(0, len(filled), batch)])[: len(chips)]
    loop = ops_chips.stitch_chips(loop_preds, idx, (h, w, 1), kernel, buffer, blend="sum")
    chips_err = (summed - loop).abs().max().item()
    check(chips_err <= 1e-6, f"predict_chips differs from the ops.chips loop: {chips_err}")
    fields["serve"] = dict(load_seconds=load_s, via="get_blob_model" if h5_files else "layers",
                           hann_seconds=hann_s, hann_launches=counts["hann_stitch"],
                           stitch_max_abs_err=stitch_err, predict_chips_seconds=chips_s,
                           predict_chips_chips=len(idx),
                           predict_chips_vs_chip_loop_max_abs_err=chips_err)

    # ---- the other four families at their presets' widths: out and back,
    # the forward on the device before and after
    fam_fields = {}
    for name, preset, suffix in H5_FAMILIES:
        fcfg = CONFIGS[preset]
        if name == "hybrid":
            fcfg = dataclasses.replace(fcfg, kernel_size=hybrid_side)
        family = get_family(name)
        fmodel = family.build(fcfg).eval()
        randomize_(fmodel, gen)
        fmodel = fmodel.to(dev)
        inputs = [(torch.rand((2,) + a.shape[1:], generator=gen)).to(dev)
                  for a in family.example_inputs(fcfg)]
        t0 = time.perf_counter()
        if h5_files:
            fpath = os.path.join(root, f"{name}.h5")
            getattr(keras_export, f"export_keras_{suffix}_h5")(fmodel, fpath)
            flayers = keras_import.keras_layers(fpath)
            fbytes = os.path.getsize(fpath)
        else:
            flayers = getattr(keras_export, f"keras_{suffix}_layers")(fmodel)
            fbytes = "not measured (h5py absent)"
        fexport_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fback = getattr(keras_import, f"load_keras_{suffix}_h5")(
            flayers, build_empty(family.build, fcfg)).to(dev)
        fimport_s = time.perf_counter() - t0
        quarters = _forget_quarters(fmodel)
        state_err, fwant = 0.0, fmodel.state_dict()
        for k, v in fback.state_dict().items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = (v - fwant[k]).abs()
            if k in quarters:
                state_err = max(state_err, diff[quarters[k]].max().item())
                diff[quarters[k]] = 0
            check(float(diff.max()) == 0.0, f"{name}: {k} changed in the round trip")
        check(state_err <= 2.4e-7, f"{name}: forget biases moved {state_err}")
        with torch.inference_mode():
            before, after = fmodel(*inputs), fback(*inputs)
        before = before if isinstance(before, dict) else {"out": before}
        after = after if isinstance(after, dict) else {"out": after}
        errs = {k: (after[k].float() - v.float()).abs().max().item()
                for k, v in before.items() if k != "classes"}
        scale = max(v.float().abs().max().item() for k, v in before.items() if k != "classes")
        bit_equal = all(torch.equal(after[k], v) for k, v in before.items())
        check(bit_equal if not quarters else max(errs.values()) <= 1e-5 * max(scale, 1.0),
              f"{name}: the forward changed in the round trip: {errs}")
        fam_fields[name] = dict(preset=preset, layers=len(flayers),
                                weight_bytes=_payload_bytes(flayers), h5_bytes=fbytes,
                                export_seconds=fexport_s, import_seconds=fimport_s,
                                forget_bias_max_abs_err=state_err if quarters else None,
                                forward_bit_equal=bit_equal, forward_max_abs_err=errs)
    fields["families"] = fam_fields
    fields["seconds"] = time.perf_counter() - t_phase
    return fields, counts


# the JAX scripts' record keys (examples/convergence_common.py and
# examples/swath_codec_sweep.py), which the twins' records must hold
EPOCH_KEYS = {"epoch", "train_loss", "eval_loss", "iou", "f1", "precision", "recall",
              "accuracy", "secs"}
SWATH_SCENE_KEYS = {"platform", "scene", "height", "width", "bands", "raw_mb", "in_mb",
                    "out_mb", "calib_page", "kernel", "buffer", "max_rows", "secs",
                    "mpix_per_s", "peak_rss_mb", "rss_now_mb"}
SWATH_SUMMARY_KEYS = {"platform", "swath_scenes", "scene_mpix", "raw_mb_per_scene",
                      "synth_secs", "synth_mb_per_s", "sweep_mpix_per_s", "peak_rss_mb",
                      "rss_now_mb", "rss_start_mb", "rss_growth_mb", "band_mb", "config"}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


# the convergence phase's rehearsal: each twin's sizes (one epoch of a
# few batches), and the swath sweep's one scene of reduced height
CONVERGENCE_SIZES = dict(
    solar=["--train-size", "32", "--eval-size", "16", "--epochs", "1", "--batch-size", "16"],
    change=["--train-size", "16", "--eval-size", "8", "--epochs", "1"],
    parking_export=["--model", "deeplab", "--train-size", "32", "--eval-size", "16",
                    "--epochs", "1"],
    parking_warm=["--model", "deeplab", "--train-size", "16", "--eval-size", "16",
                  "--epochs", "1"],
    swath=dict(height=1536, width=8192, kernel=512, buffer=128, flags=[]),
)


def convergence_phase(torch, pre, stitch, work, device="cuda", sizes=CONVERGENCE_SIZES):
    """The four convergence twins through ``main(argv)`` at full model
    width, cut to a rehearsal (``sizes``): solar (U-Net 32…512, 2 steps of
    16 chips, one eval batch, the scene eval's chips, hann and whole
    modes), change (the Siamese U-Net, 2 steps of 8 pairs, one eval batch,
    the scene eval through ``change_pair_composite`` in hann and whole
    modes), parking (DeepLab v3+ on ResNet-50 at 512², 2 steps and an eval
    batch, the backbone exported, then 1 step warm-started from it) and
    the swath sweep (one 1536 x 8192 x 4 uint16 LZW COG, k512 + b128,
    batch 16, three hann bands). Each run's records against the JAX
    scripts' keys, losses finite, the kernels' launches counted per run
    (one ``hann_stitch`` per solar and change scene eval, one per swath
    band, none elsewhere) and every stitch of the runs held against its
    plain version. Returns (fields, counts summed over the runs)."""
    from satellite_computervision_tpu_torch import (
        change_convergence,
        parking_convergence,
        solar_convergence,
        swath_codec_sweep,
    )
    from satellite_computervision_tpu_torch.inference import tiles

    root = os.path.join(work, "convergence")
    os.makedirs(root, exist_ok=True)
    for name in os.listdir(root):
        if name.endswith(".jsonl"):
            os.remove(os.path.join(root, name))
    sw = sizes["swath"]
    swath_bands = len(band_chip_rows(-(-sw["height"] // sw["kernel"]),
                                     2 * sw["kernel"] + sw["buffer"], sw["kernel"],
                                     sw["buffer"]))
    bb = os.path.join(root, "backbone.pth")
    runs = [
        ("solar", solar_convergence, sizes["solar"] + [
            "--scene-eval", "--out", os.path.join(root, "solar.jsonl")], 1),
        ("change", change_convergence, sizes["change"] + [
            "--scene-eval", "--out", os.path.join(root, "change.jsonl")], 1),
        ("parking_export", parking_convergence, sizes["parking_export"] + [
            "--export-backbone", bb, "--out", os.path.join(root, "parking.jsonl")], 0),
        ("parking_warm", parking_convergence, sizes["parking_warm"] + [
            "--torch-weights", bb, "--out", os.path.join(root, "parking.jsonl")], 0),
        ("swath", swath_codec_sweep, sw["flags"] + [
            "--scenes", "1", "--height", str(sw["height"]), "--width", str(sw["width"]),
            "--kernel", str(sw["kernel"]), "--buffer", str(sw["buffer"]),
            "--dir", os.path.join(root, "swath"), "--log", os.path.join(root, "swath.jsonl")],
         swath_bands),
    ]
    recorded = []
    real = tiles.hann_stitch

    def recording(chips, *args, **kwargs):
        recorded.append((chips.clone(), args, kwargs))
        return real(chips, *args, **kwargs)

    fields, counts = {}, {"hann_stitch": 0, "fused_preprocess": 0}
    tiles.hann_stitch = recording
    try:
        for name, module, argv, want in runs:
            zero_counts(pre, stitch)
            sync(device)
            t0 = time.perf_counter()
            summary, _, _ = run_cli(module, argv + ["--device", device])
            sync(device)
            seconds = time.perf_counter() - t0
            launches = kernel_counts(pre, stitch)
            check(launches == {"hann_stitch": want, "fused_preprocess": 0},
                  f"convergence {name}: kernel launches {launches}, expected {want} hann_stitch")
            for k, v in launches.items():
                counts[k] += v
            fields[name] = dict(seconds=seconds, launches=launches, summary=summary)
    finally:
        tiles.hann_stitch = real

    for name in ("solar", "change", "parking"):
        lines = _jsonl(os.path.join(root, f"{name}.jsonl"))
        epochs = [r for r in lines if "epoch" in r]
        check(epochs and all(EPOCH_KEYS | {"chips_per_s", "synth_secs"} <= set(r)
                             for r in epochs), f"convergence {name}: records lack JAX's keys")
        check(all(math.isfinite(r["train_loss"]) and math.isfinite(r["eval_loss"])
                  for r in epochs), f"convergence {name}: a loss is not finite")
        check(all("final" in r and "config" in r for r in lines if "epoch" not in r
                  and "scene_eval_iou" not in r), f"convergence {name}: no summary line")
        fields[name if name != "parking" else "parking_export"]["records"] = epochs
    modes = {"solar": {"chips", "hann", "whole"}, "change": {"hann", "whole"}}
    for name, want in modes.items():
        iou = [r["scene_eval_iou"] for r in _jsonl(os.path.join(root, f"{name}.jsonl"))
               if "scene_eval_iou" in r and "final" not in r]
        check(len(iou) == 1 and set(iou[0]) == want,
              f"convergence {name}: scene eval modes {iou}, expected {sorted(want)}")
        fields[name]["scene_eval_iou"] = iou[0]
    check([r.get("warm_start") for r in _jsonl(os.path.join(root, "parking.jsonl"))
           if "epoch" in r] == [False, True], "parking: the warm start did not run")
    swath = _jsonl(os.path.join(root, "swath.jsonl"))
    check(len(swath) == 2 and SWATH_SCENE_KEYS | {"hann_stitch_launches"} <= set(swath[0])
          and SWATH_SUMMARY_KEYS <= set(swath[1]["summary"]),
          "convergence swath: records lack JAX's keys")
    check(swath[0]["hann_stitch_launches"] == swath_bands, "swath: launches per band")

    # every stitch of the runs on its plain version (launches not counted)
    check(len(recorded) == counts["hann_stitch"], "a stitch was not recorded")
    errs = []
    for chips, args, kwargs in recorded:
        got = stitch.hann_stitch(chips, *args, **kwargs)
        errs.append((got - stitch.hann_stitch_reference(chips, *args, **kwargs))
                    .abs().max().item())
    check(all(e == 0.0 for e in errs), f"convergence: hann_stitch is not bit-equal: {errs}")
    fields["stitch"] = dict(calls=len(recorded), max_abs_err=max(errs),
                            shapes=[list(c.shape) for c, _, _ in recorded])
    fields["seconds"] = sum(f["seconds"] for f in fields.values() if "seconds" in f)
    return fields, counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from satellite_computervision_tpu_torch import evaluate as evaluate_cli
    from satellite_computervision_tpu_torch import native, predict
    from satellite_computervision_tpu_torch.geo import GeoTiffScene, read_geotiff
    from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
    from satellite_computervision_tpu_torch.kernels import _build, stitch
    from satellite_computervision_tpu_torch.kernels import preprocess as pre
    from satellite_computervision_tpu_torch.models import unet_solar
    from satellite_computervision_tpu_torch.parallel.spatial import band_row_weights
    from satellite_computervision_tpu_torch.train.checkpoint import save_checkpoint
    from satellite_computervision_tpu_torch.train.config import (
        CHANGE_CONFIG,
        LANDCOVER_CONFIG,
        PARKING_CONFIG,
        SOLAR_CONFIG,
        TIMESERIES_CONFIG,
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
    # the acquire path's grid: the change geometry over a 4096² composite
    # pair, 256 chips of 384² into a 4352² canvas
    a_rows = -(-ACQUIRE_SIDE // ck)
    acquire_shape = stitch_case(torch, stitch, ck, cb, a_rows, a_rows, 1, gen, timed=True)
    # the band of parallel.spatial's hann core at world size 1 over the
    # slice scene: its 4 chip rows and a phantom (zero) row on each side,
    # 24 chips of 640² into a 3584 x 2560 canvas, the whole grid's row weights
    spatial_shape = stitch_case(torch, stitch, kernel, buffer, rows + 2, cols, 1, gen,
                                timed=True, culled_rows=1, culled_last_rows=1,
                                row_weights=band_row_weights(rows, rows, 0, kernel,
                                                             kernel + buffer))
    emit("kernels", name="hann_stitch", small=small, main_path=main_shape, bands=band_cases,
         change=change_shape, change_bands=change_bands, parking=parking_shape,
         acquire=acquire_shape, spatial_band=spatial_shape)
    # the engine's route: the same products and adds in the same order, so
    # bit-equal; pre-weighted chips: within 1e-6
    tol = 1e-6
    cases = [small, main_shape, change_shape, parking_shape, acquire_shape, spatial_shape] \
        + band_cases + change_bands
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

    # ---- imagery in, map out: raw items masked and composited on the card,
    # the change checkpoint over the pair; then the calibrated multi-state
    # sweep served with the trained solar checkpoint
    acquire, acquire_launches = acquire_phase(
        torch, predict, stitch, pre, change_ckpt, work, ACQUIRE_SIDE, ACQUIRE_ITEMS,
        ACQUIRE_CROP, CHANGE_CONFIG.serving_geometry)
    emit("acquire", **acquire)
    torch.cuda.empty_cache()
    calibrate, calibrate_launches = calibrate_phase(
        torch, predict, stitch, pre, os.path.join(work, "train_ckpt"), SCENE,
        SOLAR_CONFIG.serving_geometry)
    emit("calibrate", **calibrate)
    serving_launches.update(acquire=acquire_launches["hann_stitch"],
                            calibrate=calibrate_launches["hann_stitch"])

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

    # ---- the timeseries families (ConvLSTM, LSTM autoencoder) and the
    # landcover families (ACNN, hierarchical, hybrid): no kernel on these
    # paths; their counts are taken over each
    timeseries, ts_counts, ts_steps = timeseries_train_phase(
        torch, pre, stitch, work, TIMESERIES_FILES, TIMESERIES_SIDE,
        TIMESERIES_CONFIG.kernel_size, TIMESERIES_CONFIG.batch_size, TIMESERIES_STEPS)
    emit("timeseries_train", **timeseries)
    landcover, lc_counts, lc_steps = landcover_train_phase(
        torch, evaluate_cli, pre, stitch, work, LANDCOVER_CHIPS, LANDCOVER_CONFIG.batch_size,
        LANDCOVER_STEPS, LANDCOVER_EPOCHS, LANDCOVER_SERIES_SIDE, LANDCOVER_HYBRID_SIDE)
    emit("landcover_train", **landcover)
    new_paths = {"timeseries_train": ts_counts, "landcover_train": lc_counts}
    serving_launches.update({p: c["hann_stitch"] for p, c in new_paths.items()})
    new_paths.update(acquire=acquire_launches, calibrate=calibrate_launches)

    # ---- parallel training and serving in a one-rank NCCL group: the
    # data-parallel solar step, remat through the CLI, retrain, the
    # spatially sharded hann engine and pc.predict_scene(mesh=...)
    torch.cuda.empty_cache()
    parallel, parallel_counts = parallel_phase(torch, pre, stitch, work, dict(
        train_files=sorted(glob.glob(os.path.join(work, "tfrecords", "train-*.tfrecord.gz"))),
        eval_file=os.path.join(work, "tfrecords", "eval-0.tfrecord.gz"),
        train_ckpt=os.path.join(work, "train_ckpt"),
        parking_glob=os.path.join(work, "parking_tfrecords", "train-*"),
        parking_eval=parking_eval, scene=scene,
        swath=np.asarray(GeoTiffScene(os.path.join(work, "swath.tif"))),
        max_rows=SWATH_MAX_ROWS), SOLAR_CONFIG, PARKING_CONFIG, (kernel, buffer, batch))
    emit("parallel", **parallel)
    serving_launches.update({p: c["hann_stitch"] for p, c in parallel_counts.items()})
    new_paths.update(parallel_counts)

    # ---- the Keras .h5 bridge: a reference-layout U-Net out and back,
    # evaluated and served through the hann engine; four families out and back
    torch.cuda.empty_cache()
    h5, h5_counts = h5_phase(torch, predict, evaluate_cli, stitch, pre, work,
                             os.path.join(work, "tfrecords", "eval-*.tfrecord.gz"), scene,
                             (kernel, buffer, batch), smi)
    emit("h5", **h5)
    serving_launches["h5"] = h5_counts["hann_stitch"]
    new_paths["h5"] = h5_counts

    # ---- the convergence twins (solar, change, parking, swath sweep) at
    # full width through main(argv), cut to a rehearsal
    torch.cuda.empty_cache()
    convergence, conv_counts = convergence_phase(torch, pre, stitch, work)
    emit("convergence", **convergence)
    serving_launches["convergence"] = conv_counts["hann_stitch"]
    new_paths["convergence"] = conv_counts
    train_by_path = {"train": train_launches["fused_preprocess"],
                     **{p: c["fused_preprocess"] for p, c in new_paths.items()}}

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
             "bound_by", "library_ms")},
         "acquire_shape": {k: acquire_shape[k] for k in (
             "shape", "canvas", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")},
         "spatial_band_shape": {k: spatial_shape[k] for k in (
             "shape", "canvas", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "library_device_ms")}},
        {"name": "fused_preprocess", "route": "cuda",
         "source": "satellite_computervision_tpu_torch/csrc/fused_preprocess.cu",
         "replaces": "satellite_computervision_tpu/pallas/preprocess.py:135",
         "launches": sum(train_by_path.values()), "launches_by_path": train_by_path,
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
