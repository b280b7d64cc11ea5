"""Benchmark of the port on one CUDA card: full-scene tiled-inference
throughput (the north-star metric) against the reference's inference
pattern, one synchronous batch-1 predict per chip with a host round trip
and a host-side stitch (utils/prediction_tools.py:133-156), with the same
model and chip geometry (solar U-Net, 256 + 128 chips, 4-band scenes).

The twin of the JAX package's ``bench.py``: the same model (U-Net 32…512,
sigmoid head; bf16 is autocast over float32 parameters, weights from a
seeded ``torch.Generator``), the same scenes (six 1920² × 4 uint16 from
numpy's seed 0), the same stages in the same order and the same field
names. It prints ONE JSON line:

  value, vs_baseline      MPix/s of the engine's pipelined sweep (uint16
                          in, uint8 read back to the host) and the median
                          ratio of interleaved (reference loop, engine) pairs
  s2d_whole_ms, mpix_s2d, the device-resident scene: the space-to-depth
  mfu_s2d                 U-Net, BN folded, in whole-scene mode
  hann_tuned_ms, ...      k512 + b128, batch 16, hann blend (one launch of
                          the CUDA ``hann_stitch`` per scene)
  ref_device_ms,          the reference's 36 float32 batch-1 forwards, all
  vs_baseline_device*     dispatched, one sync (pure compute)
  ref_syncloop_ms,        the same 36 with one host sync each (the loop as
  vs_refloop*             the reference runs it)
  train_*                 the solar train step (weighted BCE on logits, Adam
                          9e-4, bf16) at batch 16 and 64, plain and S2D
  whole_ms*, hann_ms      whole-scene mode live and folded; the k256 hann grid
  lzw_*                   the host LZW codec of the COG writer and reader
  device, cudnn_*         the card (name, power limit, count) and cuDNN's flags

Where the twin differs from the JAX bench, and why:

- Timing. The JAX bench times a jitted ``engine._build`` program and
  subtracts a one-element-readback floor (``_timed_scalar``, ``_floor``,
  ``_sub_floor``): workarounds for its device link. The port's engine has
  no ``_build``. The twin times ``predict_scene`` on a scene already on the
  card, warm, best of a few calls, each on the host clock ended by
  ``torch.cuda.synchronize()``; the floor has no counterpart. Short
  programs (the probes' conv stacks) are timed with CUDA events around
  back-to-back calls, a kernel alone with ``torch.profiler``.
- MFU. Operations are counted from shapes: ``torch.utils.flop_counter.
  FlopCounterMode`` over one untimed call of the same work (the
  ``hann_stitch`` kernel, called through ctypes, is invisible to it; it
  does no matrix work). The denominator is the card's published dense bf16
  peak from :data:`PEAKS`; a card not in the table gets ``mfu_*: null``
  and a note. XLA's ``cost_analysis`` counts otherwise, so these MFUs are
  not comparable with any JAX record.
- ``donate=True`` has no counterpart: a torch step updates its state in
  place.
- ``hann_ms_pallas`` has no twin. The engine has no switch between the
  kernel and a plain blend: on a CUDA tensor it launches ``hann_stitch``
  or raises. Beside ``hann_ms`` stand the kernel alone at the grid's
  shape and the ``F.fold`` route of the same blend (no serving path calls
  it): ``hann_stitch_ms`` and ``hann_stitch_fold_ms`` with CUDA events
  around back-to-back calls, ``hann_stitch_device_ms`` and
  ``hann_stitch_fold_device_ms`` from ``torch.profiler`` ("not measured"
  where its events do not add up: late in a long process it has shown
  none of the kernel's and a part of the route's).
- cuDNN's process-wide flags are left as they are and recorded:
  PyTorch runs "float32" convs in TF32 by default
  (``cudnn_allow_tf32``), so ``ref_device_ms``'s float32 reference does.
- Exit codes. A stage that raises lands in ``errors`` as in the JAX bench,
  and the process then exits 1 after printing the line; so does a run cut
  by the watchdog or by SIGTERM/SIGINT (the line names the stage). A stage
  that does not fit the remaining budget is named in ``skipped``.

Emit-once contract (the JAX bench's): the budget is ``SCV_BENCH_BUDGET``
seconds (default 1200); fields land in the result as they are measured;
a watchdog prints the line 15 s before the budget ends, SIGTERM/SIGINT
print it, and the run's end (or an exception out of it) prints it; an
``RLock`` makes the first of these the only one.

Usage:
  python -m satellite_computervision_tpu_torch.bench [--device cuda]
  python -m satellite_computervision_tpu_torch.bench --device-metrics
  python -m satellite_computervision_tpu_torch.bench --swath [swath_codec_sweep flags]
  python -m satellite_computervision_tpu_torch.bench --probe-ref-device | --probe-layout
      | --probe-s2dconv | --probe-batch | --probe-traingeo | --overlap | --profile
      | --profile-ops
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from satellite_computervision_tpu_torch import native
from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.kernels import stitch
from satellite_computervision_tpu_torch.models import UNet, fold_unet, flax_init_
from satellite_computervision_tpu_torch.models.blocks import BN_MOMENTUM
from satellite_computervision_tpu_torch.models.losses import weighted_bce
from satellite_computervision_tpu_torch.ops.chips import generate_chip_indices
from satellite_computervision_tpu_torch.staging import stage_to_device
from satellite_computervision_tpu_torch.train.trainer import create_train_state, make_train_step

KERNEL, BUFFER, BANDS = 256, 128, 4
SCENE = 1920  # pixels per side; reference-mode grid -> 6x6 chips
BATCH = 12  # chips per forward group
N_SCENES = 6  # pipelined sweep length (multi-state workload shape)
FILTERS = (32, 64, 128, 256, 512)
COMPUTE_DTYPE = torch.bfloat16
# the tuned serving geometry: kernel (buffer BUFFER) and batch
TUNED_KERNEL, TUNED_BATCH = 512, 16
# the train step: tile side, bands, and the two batches timed
TRAIN_TILE, TRAIN_BANDS, TRAIN_BATCHES = 256, 6, (16, 64)
CODEC_PLANE = (2048, 4096)
# published dense bf16 peak (FLOP/s) and the power limit it assumes, by
# torch.cuda.get_device_name (NVIDIA's data sheet, H100 SXM)
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 700.0)}
METRIC = ("tiled-inference scene throughput, solar U-Net 256+128 4-band, pipelined "
          "uint16 scenes (vs reference batch-1 per-chip predict loop, interleaved pairs)")
# every field of the default path; each must be present and finite
DEFAULT_FIELDS = (
    "value", "vs_baseline", "s2d_whole_ms", "mpix_s2d", "mfu_s2d", "hann_tuned_ms",
    "mfu_tuned", "mpix_device_tuned", "ref_device_ms", "vs_baseline_device",
    "vs_baseline_device_tuned", "ref_syncloop_ms", "vs_refloop", "vs_refloop_tuned",
    "train_ms_per_step", "train_mfu", "train_mpix", "train_tuned_ms_per_step",
    "train_mfu_tuned", "train_mpix_tuned", "train_s2d_ms_per_step", "train_mfu_s2d",
    "train_mpix_s2d", "train_s2d_b64_ms_per_step", "train_mpix_s2d_b64", "whole_ms",
    "whole_ms_fold", "mfu_whole", "hann_ms", "lzw_enc_mb_s", "lzw_dec_mb_s", "lzw_ratio",
    "bench_seconds")
# stage name -> seconds it must find left in the budget to start
STAGE_ESTIMATES = {"headline": 60, "device_ratios": 60, "train": 60, "extras": 40, "codec": 10}


@dataclasses.dataclass(frozen=True)
class Repeats:
    """How often each measurement repeats (the JAX bench's constants)."""

    pairs: int = 2  # interleaved (engine, reference loop) pairs of the headline
    sweeps: int = 2  # pipelined sweeps per engine side of a pair
    timed: int = 5  # best-of calls of a device-resident scene
    ref: int = 3  # best-of dispatches of the 36 float32 reference forwards
    syncloop: int = 2  # best-of synchronous reference loops
    train: int = 5  # best-of train steps
    codec: int = 3  # LZW encodes and decodes averaged
    stitch: int = 50  # timed and profiled calls of the stitch alone and of its F.fold route


# ---------------------------------------------------------------------------
# The line: emitted once, whatever ends the run.
# ---------------------------------------------------------------------------


class Report:
    """The run's one JSON line. Stages put fields into :attr:`fields`;
    :meth:`emit` prints them once. The ``RLock``: a signal handler runs on
    the main thread and may interrupt an ``emit`` in progress (the flag
    flips before the print, so a re-entry prints nothing)."""

    def __init__(self):
        self.fields: Dict = {"metric": METRIC, "value": None, "unit": "MPix/s",
                             "vs_baseline": None}
        self.stage: Optional[str] = None
        self._lock = threading.RLock()
        self._emitted = False

    def fail(self, stage: str, message: str) -> None:
        with self._lock:
            self.fields.setdefault("errors", {})[stage] = message

    def emit(self) -> None:
        with self._lock:
            if self._emitted:
                return
            self._emitted = True
            print(json.dumps(dict(self.fields)), flush=True)


@contextlib.contextmanager
def guarded(report: Report, budget: float):
    """The watchdog (15 s before ``budget``) and SIGTERM/SIGINT each name
    the running stage in ``errors``, print the line and exit 1; leaving the
    block, normally or by an exception, prints it (the JAX bench's atexit
    guard, here so that an in-process caller gets its line too). The
    signal handlers are restored on the way out."""

    def die(reason):
        report.fail(report.stage or "setup", reason)
        report.emit()
        os._exit(1)

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(
                sig, lambda signum, _frame: die(signal.Signals(signum).name))
        except (ValueError, OSError):  # not the main thread
            pass
    watchdog = threading.Timer(max(budget - 15.0, 5.0), die,
                               args=(f"the budget of {budget} s ran out",))
    watchdog.daemon = True
    watchdog.start()
    try:
        yield
    finally:
        watchdog.cancel()
        report.emit()
        for sig, handler in previous.items():
            signal.signal(sig, handler)


# ---------------------------------------------------------------------------
# Model, engines, timing
# ---------------------------------------------------------------------------


def build_model(device, space_to_depth: bool = False, seed: int = 0, bands: int = BANDS,
                bn_momentum: float = BN_MOMENTUM) -> UNet:
    """The bench's U-Net at :data:`FILTERS` (factors 2, sigmoid head) with
    flax's default init drawn from ``seed``, float32, in eval mode."""
    model = UNet(bands, n_classes=1, filters=FILTERS, factors=(2,) * len(FILTERS),
                 head="sigmoid", space_to_depth=space_to_depth, bn_momentum=bn_momentum)
    flax_init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def predictor(model: torch.nn.Module, dtype=COMPUTE_DTYPE) -> Callable:
    """``chips -> probs`` of ``model``, computed in ``dtype`` (autocast
    over its float32 parameters; float32 runs as it is)."""

    def predict(chips):
        with torch.autocast(chips.device.type, dtype=dtype, enabled=dtype != torch.float32):
            return model(chips)["probs"]

    return predict


def to_float(scene: torch.Tensor) -> torch.Tensor:
    """uint16 digital numbers -> float32 reflectance, on the device."""
    return scene.to(torch.float32) / 10000.0


def to_uint8(probs: torch.Tensor) -> torch.Tensor:
    return (probs * 255.0).to(torch.uint8)


def make_engine(model, device, dtype=COMPUTE_DTYPE, output_transform=to_uint8):
    """The headline engine: the reference's grid and overwrite stitch, the
    uint16 scene cast on the device, uint8 out."""
    return TiledInferenceEngine(
        predictor(model, dtype), kernel=KERNEL, buffer=BUFFER, batch_size=BATCH,
        out_channels=1, blend="overwrite", index_mode="reference", preprocess_fn=to_float,
        output_transform=output_transform, device=device)


def hann_engine(model, device, kernel: int, batch: int, dtype=COMPUTE_DTYPE,
                output_transform=to_uint8):
    """The seam-free serving engine: the full-cover grid, hann blend."""
    return TiledInferenceEngine(
        predictor(model, dtype), kernel=kernel, buffer=BUFFER, batch_size=batch,
        out_channels=1, blend="hann", index_mode="grid", preprocess_fn=to_float,
        output_transform=output_transform, device=device)


def whole_engine(model, device, whole_multiple: int = 32):
    """One forward over the whole edge-padded scene."""
    return TiledInferenceEngine(
        predictor(model), kernel=KERNEL, buffer=BUFFER, batch_size=BATCH,
        out_channels=1, tile_mode="whole", whole_multiple=whole_multiple,
        preprocess_fn=to_float, output_transform=to_uint8, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device: torch.device, reps: int) -> float:
    """Best seconds of ``reps`` warm calls of ``fn``, each on the host clock
    ended by a device synchronize (after one warm-up call)."""
    fn()
    _sync(device)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def event_seconds(fn: Callable, device: torch.device, iters: int = 10) -> float:
    """Mean seconds per call of ``iters`` back-to-back warm calls: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    _sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / iters


def device_ms(fn: Callable, device: torch.device, calls: int, name: Optional[str] = None):
    """Mean device milliseconds per call of ``fn`` under ``torch.profiler``:
    of the kernels whose name holds ``name``, or of every device event when
    ``name`` is None. None off the card (no device time to read). "Not
    measured" where the profiler shows no such event, or where an event's
    count is not a whole multiple of ``calls``: on the card's host the
    profiler now and then drops device events (a kernel's time then reads
    below its bound), and such a sum is no device time."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and (name is None or name in e.key)]
    if not events or any(e.count % calls for e in events):
        return "not measured"
    return sum(e.device_time_total for e in events) / 1e3 / calls


def count_flops(fn: Callable) -> int:
    """Floating-point operations of one call of ``fn`` (2 per multiply-add
    of convs and matmuls), counted from shapes by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def card_peak(device: torch.device) -> Optional[float]:
    """The card's dense bf16 peak FLOP/s from :data:`PEAKS`, or None."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return PEAKS[name][0] if name in PEAKS else None


def mfu(flops: float, seconds: float, peak: Optional[float]) -> Optional[float]:
    return None if peak is None else flops / seconds / peak


def device_info(device: torch.device) -> Dict:
    """The card's name (torch), power limit and count (``nvidia-smi``), or
    the CPU's name."""
    if device.type != "cuda":
        return {"name": device.type, "power_limit_w": None, "count": 0}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[
            device.index or 0].strip()
    return {"name": torch.cuda.get_device_name(device),
            "power_limit_w": float(line.rsplit(",", 1)[1].split()[0]),
            "count": torch.cuda.device_count(), "nvidia_smi": line}


def seeded_scenes(n: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 3000, (SCENE, SCENE, BANDS)).astype(np.uint16) for _ in range(n)]


# ---------------------------------------------------------------------------
# Stages: each writes its fields into ``result`` as soon as they are measured
# ---------------------------------------------------------------------------


def bench_ours(engine, scenes, repeats: int) -> float:
    """Seconds per scene of the engine's pipelined sweep (staging thread,
    device compute, uint8 read back into host memory), best of
    ``repeats`` sweeps after a warm scene."""
    engine.predict_scene(scenes[0]).cpu()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _out in engine.predict_scenes(scenes, readback=True):
            pass
        times.append((time.perf_counter() - t0) / len(scenes))
    return min(times)


def reference_pattern(predict: Callable, scene_u16: np.ndarray, device):
    """The reference loop: a batch-1 forward per chip of the reference grid,
    each chip copied to the device and its prediction back to the host,
    stitched in numpy (utils/prediction_tools.py:133-156). Returns (seconds
    of the whole grid, the (H, W) float32 canvas)."""
    h, w = scene_u16.shape[:2]
    half = BUFFER // 2
    idx = generate_chip_indices(h, w, KERNEL, BUFFER, mode="reference")
    scene_np = scene_u16.astype(np.float32) / 10000.0

    def one(y, x):
        chip = np.ascontiguousarray(scene_np[y - half : y + KERNEL + half,
                                             x - half : x + KERNEL + half])
        return predict(torch.from_numpy(chip).to(device)[None])[0].cpu().numpy()

    canvas = np.zeros((h, w), np.float32)
    with torch.inference_mode():
        one(*idx[0])  # warm
        t0 = time.perf_counter()
        for y, x in idx:
            pred = one(y, x)
            canvas[y : y + KERNEL, x : x + KERNEL] += pred[half : half + KERNEL,
                                                           half : half + KERNEL, 0]
        seconds = time.perf_counter() - t0
    return seconds, canvas


def stage_headline(result, model, scenes, device, reps: Repeats) -> None:
    """``value`` and ``vs_baseline``: the engine's sweep and the reference
    loop in interleaved pairs, the ratio the median of the pairs'
    ratios; both fields land after every pair."""
    engine = make_engine(model, device)
    predict = predictor(model)
    mpix = scenes[0].shape[0] * scenes[0].shape[1] / 1e6
    pairs = []
    for _ in range(reps.pairs):
        ours = bench_ours(engine, scenes, reps.sweeps)
        ref, _ = reference_pattern(predict, scenes[0], device)
        pairs.append((ours, ref))
        result["value"] = mpix / min(o for o, _ in pairs)
        result["vs_baseline"] = statistics.median(r / o for o, r in pairs)


def stage_device_ratios(result, model, staged, device, reps: Repeats) -> None:
    """The device-resident scene in the fastest mode (S2D U-Net, folded,
    whole scene) and in the tuned chip geometry, against the reference's
    float32 batch-1 forwards dispatched together (``ref_device_ms``) and
    run as the reference runs them, one host sync each
    (``ref_syncloop_ms``)."""
    peak = card_peak(device)
    mpix = staged.shape[0] * staged.shape[1] / 1e6

    s2d = fold_unet(build_model(device, space_to_depth=True, seed=1))
    s2d_whole = whole_engine(s2d, device, whole_multiple=64)

    def run_s2d():
        s2d_whole.predict_scene(staged)

    t_s2d = timed(run_s2d, device, reps.timed)
    result["s2d_whole_ms"] = t_s2d * 1e3
    result["mpix_s2d"] = mpix / t_s2d
    result["mfu_s2d"] = mfu(count_flops(run_s2d), t_s2d, peak)

    tuned = hann_engine(fold_unet(model), device, TUNED_KERNEL, TUNED_BATCH)

    def run_tuned():
        tuned.predict_scene(staged)

    t_tuned = timed(run_tuned, device, reps.timed)
    result["hann_tuned_ms"] = t_tuned * 1e3
    result["mfu_tuned"] = mfu(count_flops(run_tuned), t_tuned, peak)
    result["mpix_device_tuned"] = mpix / t_tuned

    f32 = predictor(model, torch.float32)
    h, w = staged.shape[:2]
    side, half = KERNEL + BUFFER, BUFFER // 2
    with torch.inference_mode():
        scene_f = to_float(staged)
        chips = [scene_f[y - half : y - half + side, x - half : x - half + side][None]
                 .contiguous() for y, x in generate_chip_indices(h, w, KERNEL, BUFFER)]

        def dispatch_all():
            for c in chips:
                f32(c)

        t_ref = timed(dispatch_all, device, reps.ref)
        result["ref_device_ms"] = t_ref * 1e3
        result["vs_baseline_device"] = t_ref / t_s2d
        result["vs_baseline_device_tuned"] = t_ref / t_tuned

        def syncloop():
            for c in chips:
                f32(c).cpu()

        t_sync = timed(syncloop, device, reps.syncloop)
    result["ref_syncloop_ms"] = t_sync * 1e3
    result["vs_refloop"] = t_sync / t_s2d
    result["vs_refloop_tuned"] = t_sync / t_tuned


def train_step(compute_dtype=COMPUTE_DTYPE) -> Callable:
    """The solar step: weighted BCE on logits (pos_weight 2), Adam 9e-4
    (:func:`create_train_state`), the forward in ``compute_dtype``."""
    return make_train_step(lambda t, p: weighted_bce(t, p, pos_weight=2.0, logits=True),
                           compute_dtype=compute_dtype)


def train_batch(rng: np.random.Generator, batch: int, device):
    """Seeded normals and 20 % positive labels at the train tile."""
    x = rng.normal(size=(batch, TRAIN_TILE, TRAIN_TILE, TRAIN_BANDS)).astype(np.float32)
    y = (rng.uniform(size=(batch, TRAIN_TILE, TRAIN_TILE, 1)) > 0.8).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def timed_step(space_to_depth: bool, x, y, device, reps: int):
    """(best seconds of a warm step, FLOPs of one step) of a fresh train
    U-Net (seed 0, BN momentum 0.9) at batch ``x``."""
    model = build_model(device, space_to_depth=space_to_depth, bands=x.shape[-1],
                        bn_momentum=0.9)
    state = create_train_state(model)
    step = train_step()

    def run():
        step(state, (x, y))["loss"].item()

    seconds = timed(run, device, reps)
    return seconds, count_flops(run)


def stage_train(result, device, reps: Repeats) -> None:
    """The solar train step at batch 16 and 64, plain and S2D stem. MFU is
    relative to each network's own FLOPs; ``train_mpix*`` is the
    architecture-neutral rate."""
    peak = card_peak(device)
    rng = np.random.default_rng(1)
    small, large = TRAIN_BATCHES
    x, y = train_batch(rng, small, device)
    xt, yt = train_batch(rng, large, device)
    pix = TRAIN_TILE * TRAIN_TILE

    t, fl = timed_step(False, x, y, device, reps.train)
    result["train_ms_per_step"] = t * 1e3
    result["train_mfu"] = mfu(fl, t, peak)
    result["train_mpix"] = small * pix / t / 1e6

    t, fl = timed_step(False, xt, yt, device, reps.train)
    result["train_tuned_ms_per_step"] = t * 1e3
    result["train_mfu_tuned"] = mfu(fl, t, peak)
    result["train_mpix_tuned"] = large * pix / t / 1e6

    t, fl = timed_step(True, x, y, device, reps.train)
    result["train_s2d_ms_per_step"] = t * 1e3
    result["train_mfu_s2d"] = mfu(fl, t, peak)
    result["train_mpix_s2d"] = small * pix / t / 1e6

    t, _ = timed_step(True, xt, yt, device, reps.train)
    result["train_s2d_b64_ms_per_step"] = t * 1e3
    result["train_mpix_s2d_b64"] = large * pix / t / 1e6


def fold_blend(preds, kernel: int, rows: int, cols: int, window, inv_w):
    """The blend of ``hann_stitch(apply_window=True)`` through library
    calls: the window multiply, ``F.fold`` to overlap-add the chips, the
    inverse weights. A timing yardstick (here and in chip_smoke.py); no
    serving path calls it."""
    n, side, _, c = preds.shape
    h, w = (rows - 1) * kernel + side, (cols - 1) * kernel + side
    weighted = preds * window[..., None]
    folded = F.fold(weighted.permute(3, 1, 2, 0).reshape(1, c * side * side, n),
                    output_size=(h, w), kernel_size=side, stride=kernel)
    canvas = F.pad(folded, (0, (cols + 1) * kernel - w, 0, (rows + 1) * kernel - h))
    return canvas[0].permute(1, 2, 0) * inv_w[..., None]


def stage_extras(result, model, staged, device, reps: Repeats) -> None:
    """Whole-scene mode with live and folded BN; the k256 hann grid, and
    its stitch alone (the CUDA kernel, and the ``F.fold`` route)."""
    peak = card_peak(device)
    folded = fold_unet(model)
    for tag, m in (("", model), ("_fold", folded)):
        engine = whole_engine(m, device)

        def run(engine=engine):
            engine.predict_scene(staged)

        t = timed(run, device, reps.timed)
        result[f"whole_ms{tag}"] = t * 1e3
        if tag == "_fold":
            result["mfu_whole"] = mfu(count_flops(run), t, peak)

    hann = hann_engine(folded, device, KERNEL, BATCH)
    result["hann_ms"] = timed(lambda: hann.predict_scene(staged), device, reps.timed) * 1e3

    rows, cols = hann._grid_geometry(*staged.shape[:2])[:2]
    side = KERNEL + BUFFER
    preds = torch.rand((rows * cols, side, side, 1),
                       generator=torch.Generator().manual_seed(0)).to(device)
    window = stitch.hann_window_2d(side, device)
    inv_w = torch.from_numpy(stitch.hann_inverse_weights(rows, cols, KERNEL, side)).to(device)
    result["hann_stitch_shape"] = [rows * cols, side, side, 1]
    result["hann_stitch_fold_max_abs_err"] = (
        fold_blend(preds, KERNEL, rows, cols, window, inv_w)
        - stitch.hann_stitch(preds, KERNEL, rows, cols, apply_window=True)).abs().max().item()

    def kernel():
        stitch.hann_stitch(preds, KERNEL, rows, cols, apply_window=True)

    def library():
        fold_blend(preds, KERNEL, rows, cols, window, inv_w)

    card = device.type == "cuda"
    for tag, fn in (("", kernel), ("_fold", library)):
        result[f"hann_stitch{tag}_ms"] = (event_seconds(fn, device, reps.stitch) * 1e3
                                          if card else None)
    result["hann_stitch_device_ms"] = device_ms(kernel, device, reps.stitch,
                                                "hann_stitch_kernel")
    result["hann_stitch_fold_device_ms"] = device_ms(library, device, reps.stitch)


def codec_plane() -> bytes:
    """A predictor-2-differenced, satellite-like uint8 plane (numpy seed 0)."""
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 7, CODEC_PLANE, dtype=np.uint8).cumsum(axis=1).astype(np.uint8)
    diff = plane.copy()
    diff[:, 1:] = plane[:, 1:] - plane[:, :-1]
    return diff.tobytes()


def stage_codec(result, reps: Repeats) -> None:
    """The native LZW codec's encode and decode MB/s and its ratio: the hot
    loop of the streaming COG writer and reader. Host only."""
    if native.get_lib() is None:
        raise RuntimeError("the native codec (native/fastrecord.cc) is not built: no g++?")
    raw = codec_plane()
    enc = native.lzw_encode(raw)
    if enc is None or native.lzw_decode(enc, len(raw)) != raw:
        raise RuntimeError("the native LZW codec does not round-trip the plane")
    mb = len(raw) / 1e6
    t0 = time.perf_counter()
    for _ in range(reps.codec):
        native.lzw_encode(raw)
    enc_s = (time.perf_counter() - t0) / reps.codec
    t0 = time.perf_counter()
    for _ in range(reps.codec):
        native.lzw_decode(enc, len(raw))
    dec_s = (time.perf_counter() - t0) / reps.codec
    result["lzw_enc_mb_s"] = mb / enc_s
    result["lzw_dec_mb_s"] = mb / dec_s
    result["lzw_ratio"] = len(raw) / len(enc)


def describe(result, device) -> None:
    """The card and the settings every number depends on."""
    result["device"] = device_info(device)
    result["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
    result["cudnn_benchmark"] = torch.backends.cudnn.benchmark
    peak = card_peak(device)
    result["peak_bf16_flops"] = peak
    if peak is None:
        result["mfu_note"] = (f"no published bf16 peak for {result['device']['name']!r} "
                              "in bench.PEAKS: mfu_* are null")
    else:
        name = result["device"]["name"]
        result["peak_power_limit_w"] = PEAKS[name][1]


def run(report: Report, device: torch.device, deadline: float,
        reps: Repeats = Repeats()) -> None:
    """The default path: the five stages in order of importance, each
    started only when its estimate fits before ``deadline``
    (``time.monotonic``); a stage that raises is named in ``errors`` with
    its message, its traceback on stderr, and the next one runs."""
    result = report.fields
    started = time.monotonic()
    describe(result, device)
    scenes = seeded_scenes(N_SCENES)
    model = build_model(device)
    staged = torch.from_numpy(scenes[0]).to(device)
    stages = [
        ("headline", lambda: stage_headline(result, model, scenes, device, reps)),
        ("device_ratios", lambda: stage_device_ratios(result, model, staged, device, reps)),
        ("train", lambda: stage_train(result, device, reps)),
        ("extras", lambda: stage_extras(result, model, staged, device, reps)),
        ("codec", lambda: stage_codec(result, reps)),
    ]
    for name, thunk in stages:
        if deadline - time.monotonic() < STAGE_ESTIMATES[name]:
            result.setdefault("skipped", []).append(name)
            continue
        report.stage = name
        t0 = time.perf_counter()
        try:
            thunk()
        except Exception as e:  # the next stage still runs; the exit code says so
            traceback.print_exc()
            report.fail(name, f"{type(e).__name__}: {e}")
        result.setdefault("stage_seconds", {})[name] = time.perf_counter() - t0
    report.stage = None
    result["bench_seconds"] = time.monotonic() - started


# ---------------------------------------------------------------------------
# Probes: each answers one question and prints its lines; none runs by default
# ---------------------------------------------------------------------------


def _pct(flops: float, seconds: float, peak: Optional[float]) -> str:
    return "MFU unknown" if peak is None else f"{flops / seconds / peak * 100:.1f}% MFU"


def device_metrics_only(device) -> int:
    """--device-metrics: the device-resident fields alone (for controlled
    reruns; keep the host otherwise idle)."""
    report = Report()
    describe(report.fields, device)
    model = build_model(device)
    staged = torch.from_numpy(seeded_scenes(1)[0]).to(device)
    reps = Repeats()
    stage_device_ratios(report.fields, model, staged, device, reps)
    stage_train(report.fields, device, reps)
    stage_extras(report.fields, model, staged, device, reps)
    report.emit()
    return 0


def probe_ref_device(device) -> int:
    """--probe-ref-device: the reference pattern's device cost (float32
    batch-1 forwards, utils/prediction_tools.py:133-156) three ways:
    (a) six forwards back to back, CUDA events (the JAX probe's one
    unrolled program has no counterpart), times 36; (b) the 36 dispatched
    together, one sync; (c) the 36 with a host sync each."""
    model = build_model(device)
    f32 = predictor(model, torch.float32)
    peak = card_peak(device)
    scene_f = to_float(torch.from_numpy(seeded_scenes(1)[0]).to(device))
    side, half = KERNEL + BUFFER, BUFFER // 2
    chips = [scene_f[y - half : y - half + side, x - half : x - half + side][None].contiguous()
             for y, x in generate_chip_indices(SCENE, SCENE, KERNEL, BUFFER)]
    n, r = len(chips), 6
    with torch.inference_mode():
        def six():
            for c in chips[:r]:
                f32(c)

        t6 = event_seconds(six, device)
        per_chip = t6 / r
        print(f"(a) {r} forwards back to back: {t6 * 1e3:.2f} ms -> {per_chip * 1e3:.2f} "
              f"ms/chip ({_pct(count_flops(six), t6, peak)}), x{n} = "
              f"{per_chip * n * 1e3:.1f} ms", flush=True)

        def dispatch_all():
            for c in chips:
                f32(c)

        print(f"(b) {n} dispatched + 1 sync: "
              f"{timed(dispatch_all, device, 3) * 1e3:.1f} ms", flush=True)

        def syncloop():
            for c in chips:
                f32(c).cpu()

        print(f"(c) {n} sync round trips: {timed(syncloop, device, 2) * 1e3:.1f} ms",
              flush=True)
    return 0


def _conv_stack_ms(x, kernels, device, padding="same"):
    """Event-timed seconds of relu(conv(...)) over ``kernels`` (stride 1)
    on ``x``."""
    def stack():
        y = x
        for k in kernels:
            y = F.relu(F.conv2d(y, k, padding=padding))
        return y

    with torch.inference_mode():
        return event_seconds(stack, device)


def _bf16(rng, shape, device, scale=1.0, channels_last=False):
    t = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    t = t.to(device=device, dtype=torch.bfloat16)
    return t.to(memory_format=torch.channels_last) if channels_last else t


def probe_layout(device) -> int:
    """--probe-layout: cuDNN's bf16 conv at the U-Net's whole-scene level
    shapes with channels-last tensors against contiguous NCHW. Each timing
    is a two-conv stack (ReLU after each), CUDA events."""
    rng = np.random.default_rng(0)
    peak = card_peak(device)
    for h, cin, cout in [(1984, 4, 32), (1984, 32, 32), (992, 64, 64), (496, 128, 128)]:
        for layout in ("channels_last", "contiguous"):
            cl = layout == "channels_last"
            x = _bf16(rng, (1, cin, h, h), device, channels_last=cl)
            k1 = _bf16(rng, (cout, cin, 3, 3), device, 0.1, channels_last=cl)
            k2 = _bf16(rng, (cout, cout, 3, 3), device, 0.1, channels_last=cl)
            t = _conv_stack_ms(x, (k1, k2), device)
            flops = 2 * 9 * h * h * (cin * cout + cout * cout)
            print(f"{h}^2 {cin}->{cout}->{cout} {layout}: {t * 1e3:7.2f} ms "
                  f"({_pct(flops, t, peak)})", flush=True)
    return 0


def probe_s2d_conv(device) -> int:
    """--probe-s2dconv: is a parity-decomposed conv worth building? A
    stride-1 3x3 conv over (H, W, C) equals a 2x2 conv over the (H/2, W/2,
    4C) space-to-depth form with rearranged weights: 16/9 the FLOPs at 4x
    the channels. bf16, channels-last, one conv + ReLU each; the input is
    padded for a 'same' output before the timing (an even kernel pads one
    pixel at the end, as XLA's SAME does), the conv itself pads nothing."""
    rng = np.random.default_rng(0)
    peak = card_peak(device)
    cases = [  # (name, NHWC input, (kh, kw, cin, cout))
        ("3x3 1984^2 c32 (original L0)", (1, 1984, 1984, 32), (3, 3, 32, 32)),
        ("2x2 992^2 c128 (S2D form of L0)", (1, 992, 992, 128), (2, 2, 128, 128)),
        ("3x3 1984^2 c4->32 (stem)", (1, 1984, 1984, 4), (3, 3, 4, 32)),
        ("2x2 992^2 c16->128 (S2D stem)", (1, 992, 992, 16), (2, 2, 16, 128)),
        ("3x3 992^2 c64 (L1)", (1, 992, 992, 64), (3, 3, 64, 64)),
        ("2x2 496^2 c256 (S2D form of L1)", (1, 496, 496, 256), (2, 2, 256, 256)),
    ]
    for name, (n, h, w, c), (kh, kw, cin, cout) in cases:
        x = F.pad(_bf16(rng, (n, c, h, w), device), (
            (kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)).to(memory_format=torch.channels_last)
        k = _bf16(rng, (cout, cin, kh, kw), device, 0.1, channels_last=True)
        t = _conv_stack_ms(x, (k,), device, padding=0)
        flops = 2 * kh * kw * cin * cout * h * w
        print(f"{name}: {t * 1e3:7.2f} ms ({_pct(flops, t, peak)})", flush=True)
    return 0


def probe_conv_batching(device) -> int:
    """--probe-batch: the same pixels split into other batch and spatial
    sizes; is the shallow convs' MFU a matter of spatial tiling?"""
    rng = np.random.default_rng(0)
    peak = card_peak(device)
    cases = [("b1 1984^2 c32", (1, 1984, 32)), ("b1 2048^2 c32", (1, 2048, 32)),
             ("b4 992^2 c32", (4, 992, 32)), ("b16 496^2 c32", (16, 496, 32)),
             ("b64 248^2 c32", (64, 248, 32)), ("b16 496^2 c64", (16, 496, 64))]
    for name, (n, h, c) in cases:
        x = _bf16(rng, (n, c, h, h), device, channels_last=True)
        k = _bf16(rng, (c, c, 3, 3), device, 0.1, channels_last=True)
        t = _conv_stack_ms(x, (k,), device)
        flops = 2 * 9 * n * h * h * c * c
        print(f"{name}: {t * 1e3:7.2f} ms ({_pct(flops, t, peak)})", flush=True)
    return 0


def probe_train_geometry(device) -> int:
    """--probe-traingeo: the solar train step across batch/tile splits (1x
    and 4x the reference's pixels); out of memory is a result too."""
    rng = np.random.default_rng(1)
    peak = card_peak(device)
    for batch, tile in [(16, 256), (4, 512), (64, 256), (16, 512), (8, 512), (32, 384)]:
        x = torch.from_numpy(rng.normal(size=(batch, tile, tile, TRAIN_BANDS))
                             .astype(np.float32)).to(device)
        y = torch.from_numpy((rng.uniform(size=(batch, tile, tile, 1)) > 0.8)
                             .astype(np.float32)).to(device)
        try:
            t, flops = timed_step(False, x, y, device, 5)
        except torch.cuda.OutOfMemoryError as e:
            print(f"b{batch} {tile}^2: FAILED ({type(e).__name__})", flush=True)
            torch.cuda.empty_cache()
            continue
        print(f"b{batch} {tile}^2: {t * 1e3:7.1f} ms  {batch * tile * tile / t / 1e6:7.1f} "
              f"MPix/s  ({_pct(flops, t, peak)})", flush=True)
    return 0


def overlap_experiment(device) -> int:
    """--overlap: does staging the next stack of scenes on a thread (pinned
    memory, a side stream: ``staging``) hide its copy behind the
    current stack's compute?"""
    rng = np.random.default_rng(0)
    stacks = [rng.integers(0, 3000, (N_SCENES, SCENE, SCENE, BANDS)).astype(np.uint16)
              for _ in range(2)]
    engine = make_engine(build_model(device), device)
    engine.predict_scene_batch(stacks[0]).cpu()  # warm
    t0 = time.perf_counter()
    for s in stacks * 2:
        engine.predict_scene_batch(s).cpu()
    serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = stage_to_device(((stacks[i % 2], None) for i in range(4)), 1, device)
    try:
        for stack, _ in staged:
            engine.predict_scene_batch(stack).cpu()
    finally:
        staged.close()
    piped = time.perf_counter() - t0
    print(f"serial 4 sweeps: {serial:.3f}s; thread-staged: {piped:.3f}s "
          f"({serial / piped:.2f}x)", flush=True)
    return 0


def profile_components(device) -> int:
    """--profile: the scene pipeline's legs: H2D of the uint16 scene, the
    device compute, D2H of the uint8 prediction; the pipelined sweeps and
    the stacked batch; the hann mode device-resident and pipelined."""
    scenes = seeded_scenes(N_SCENES)
    model = build_model(device)
    engine = make_engine(model, device)
    mpix = SCENE * SCENE / 1e6
    staged = torch.from_numpy(scenes[0]).to(device)
    pred = engine.predict_scene(staged)
    h2d = timed(lambda: torch.from_numpy(scenes[1]).to(device), device, 3)
    d2h = timed(lambda: pred.cpu(), device, 3)
    comp = timed(lambda: engine.predict_scene(staged), device, 3)
    print(f"scene {SCENE}x{SCENE}x{BANDS} uint16 = {scenes[0].nbytes / 1e6:.1f} MB in, "
          f"{pred.numel() * pred.element_size() / 1e6:.1f} MB out")
    print(f"H2D:     {h2d:.4f}s ({scenes[0].nbytes / 1e6 / h2d:.0f} MB/s)")
    print(f"compute: {comp:.4f}s ({mpix / comp:.1f} MPix/s device-resident)")
    print(f"D2H:     {d2h:.4f}s ({pred.numel() * pred.element_size() / 1e6 / d2h:.0f} MB/s)")

    def sweep(eng, readback):
        t0 = time.perf_counter()
        for out in eng.predict_scenes(scenes, readback=readback):
            if not readback:
                out.cpu()
        return (time.perf_counter() - t0) / len(scenes)

    piped = sweep(engine, False)
    print(f"2-stage predict_scenes: {piped:.4f}s/scene ({mpix / piped:.2f} MPix/s)")
    piped3 = sweep(engine, True)
    print(f"3-stage predict_scenes: {piped3:.4f}s/scene ({mpix / piped3:.2f} MPix/s)")
    stack = np.stack(scenes)
    stacked = timed(lambda: engine.predict_scene_batch(stack).cpu(), device, 1) / len(scenes)
    print(f"stacked predict_scene_batch: {stacked:.4f}s/scene ({mpix / stacked:.2f} MPix/s)")
    hann = hann_engine(model, device, KERNEL, BATCH)
    hann_comp = timed(lambda: hann.predict_scene(staged), device, 3)
    rows, cols = hann._grid_geometry(SCENE, SCENE)[:2]
    print(f"hann device-resident: {hann_comp:.4f}s ({mpix / hann_comp:.1f} MPix/s; "
          f"{rows * cols}-chip full-cover grid + blend vs overwrite's "
          f"{len(generate_chip_indices(SCENE, SCENE, KERNEL, BUFFER))}-chip reference grid)")
    hann_s = sweep(hann, True)
    print(f"hann-blend pipeline: {hann_s:.4f}s/scene ({mpix / hann_s:.2f} MPix/s)", flush=True)
    return 0


def profile_ops(device) -> int:
    """--profile-ops: where the engine's device time goes. The JAX bench's
    ablation (preprocess + gather, the batched forward, the whole engine,
    whole-scene mode), each timed alone on device-resident data; then
    ``torch.profiler``'s table of one warm scene by kernel."""
    scene = seeded_scenes(1)[0]
    model = build_model(device)
    predict = predictor(model)
    engine = make_engine(model, device)
    half, side = BUFFER // 2, KERNEL + BUFFER
    staged = torch.from_numpy(scene).to(device)
    corners = [(y, x) for y in range(half, SCENE - side, KERNEL)
               for x in range(half, SCENE - side, KERNEL)]
    n = len(corners)
    corners += corners[-1:] * ((-n) % BATCH)
    chips_dev = torch.from_numpy(np.random.default_rng(0).normal(
        size=(len(corners), side, side, BANDS)).astype(np.float32)).to(device)

    def gather_only():
        scene_f = to_float(staged)
        return torch.stack([scene_f[y : y + side, x : x + side] for y, x in corners])

    def forward_only():
        with torch.inference_mode():
            return torch.cat([predict(g) for g in chips_dev.split(BATCH)])

    whole = whole_engine(model, device)
    g = timed(gather_only, device, 5)
    fwd = timed(forward_only, device, 5)
    full = timed(lambda: engine.predict_scene(staged), device, 5)
    w = timed(lambda: whole.predict_scene(staged), device, 5)
    print(f"preprocess+gather:     {g * 1e3:7.2f} ms ({n} chips of {side}^2)")
    print(f"model forward (batched): {fwd * 1e3:5.2f} ms ({len(corners)} chips, "
          f"groups of {BATCH})")
    print(f"full engine program:   {full * 1e3:7.2f} ms (gather+forward+crop+stitch+uint8)")
    print(f"whole-scene forward:   {w * 1e3:7.2f} ms ({SCENE}^2 single conv pass, no tiling)",
          flush=True)
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.predict_scene(staged)
            torch.cuda.synchronize(device)
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20),
              flush=True)
    return 0


PROBES = {
    "--device-metrics": device_metrics_only,
    "--probe-ref-device": probe_ref_device,
    "--probe-layout": probe_layout,
    "--probe-s2dconv": probe_s2d_conv,
    "--probe-batch": probe_conv_batching,
    "--probe-traingeo": probe_train_geometry,
    "--overlap": overlap_experiment,
    "--profile": profile_components,
    "--profile-ops": profile_ops,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--swath" in argv:
        # the swath twin takes every flag after --swath, its own --device too
        from satellite_computervision_tpu_torch import swath_codec_sweep

        swath_codec_sweep.main(argv[argv.index("--swath") + 1:])
        return 0
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    probes = ap.add_mutually_exclusive_group()
    for flag in PROBES:
        probes.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for flag, fn in PROBES.items():
        if getattr(args, flag[2:].replace("-", "_")):
            return fn(device)

    budget = float(os.environ.get("SCV_BENCH_BUDGET", "1200"))
    report = Report()
    with guarded(report, budget):
        run(report, device, time.monotonic() + budget)
    return 1 if "errors" in report.fields else 0


if __name__ == "__main__":
    sys.exit(main())
