"""Shared plumbing for the port's convergence harnesses.

The twin of ``examples/convergence_common.py``: stable seeding, smooth
background fields, prefetched batch streams, binary and multiclass
metrics, the class palette of the multi-head harnesses, the
epoch/eval/JSONL loop with the loss summed on the device, and the scene
evals' autocast and IoU. The seeding,
fields, metrics and constants are copies of the JAX module's numpy code
(bit-equal); the batch stream draws the same shuffle from the same
``np.random.default_rng(args.seed)``, so a twin trains on the JAX run's
chips in the JAX run's order.

The port adds two timings to each epoch's record, beside the JAX keys
(which keep their meaning): ``chips_per_s`` (training chips over the
training loop's wall seconds) and ``synth_secs`` (wall seconds the host
spent making the epoch's chips, train and eval, on the worker that runs
ahead of the device). Chips are made by a pool of threads in the order
of the shuffle; ``make_chip`` is a pure function of ``(split, index)``,
so the batches are the same as one thread's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.data.pipeline import prefetch_to_device


def stable_seed(split: str, index: int, stride: int = 1_000_003) -> int:
    """Process-stable chip seed (str hash is salted per interpreter,
    which would give every run a different dataset)."""
    return (zlib.crc32(split.encode()) & 0xFFFF) * stride + index


def smooth_field(rng, k: int, scale: int = 16) -> np.ndarray:
    """(k, k) spatially correlated noise: bilinear-upsampled low-res normal."""
    low = rng.normal(size=(k // scale + 2, k // scale + 2)).astype(np.float32)
    idx = np.linspace(0, low.shape[0] - 1.001, k)
    yi, xi = np.meshgrid(idx, idx, indexing="ij")
    y0, x0 = yi.astype(int), xi.astype(int)
    fy, fx = yi - y0, xi - x0
    a = low[y0, x0] * (1 - fy) * (1 - fx) + low[y0 + 1, x0] * fy * (1 - fx)
    b = low[y0, x0 + 1] * (1 - fy) * fx + low[y0 + 1, x0 + 1] * fy * fx
    return a + b


# ---------------------------------------------------------------------------
# Shared landcover class signatures for the multi-head harnesses (the
# hierarchical and hybrid convergence runs build chips from one palette).
# ---------------------------------------------------------------------------

PERIOD = 12.0  # seasonal period in observation steps

CLASSES = ["water", "tree", "grass", "crop", "impervious", "wetland"]
NCLASS = len(CLASSES)
SUBCLASSES = ["wet", "vegetation", "built"]
NSUB = len(SUBCLASSES)
# main -> coarse super-class (the hierarchical mid-depth head's target)
SUB_OF = np.array([0, 1, 1, 1, 2, 0], np.int32)

# per-class (R, G, B, N) reflectance means; grass (2) and crop (3) are
# IDENTICAL on purpose — only the timeseries separates them
SIGS = np.array([
    [0.10, 0.14, 0.20, 0.06],   # water
    [0.14, 0.24, 0.13, 0.58],   # tree
    [0.38, 0.48, 0.26, 0.58],   # grass
    [0.38, 0.48, 0.26, 0.58],   # crop (== grass in a single date)
    [0.56, 0.56, 0.56, 0.30],   # impervious
    [0.17, 0.26, 0.20, 0.42],   # wetland
], np.float32)
# seasonal NDVI-like amplitude per class: crop swings hard, grass a
# little, the rest are near-static
AMPS = np.array([0.00, 0.05, 0.08, 0.40, 0.00, 0.12], np.float32)


def chip_batches(make_chip, split, n, batch, rng, shuffle=True, prefetch=2,
                 device="cuda", timing=None):
    """Prefetched device batches from a ``(split, index)`` chip fn, in the
    JAX stream's order (the shuffle drawn from ``rng`` when the stream
    starts; a last partial batch dropped). Each batch is a tuple with one
    stacked tensor per item of the chips' tuples: ``(x, y)`` for a chip of
    features and label, more for the multi-input harnesses.
    ``timing["synth_secs"]``, when given, gathers the wall seconds spent
    making chips."""

    def raw():
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        # the host's cores less two (the training loop, the batch worker)
        with ThreadPoolExecutor(max(1, (os.cpu_count() or 1) - 2)) as pool:
            for i in range(0, n - batch + 1, batch):
                t0 = time.perf_counter()
                fields = zip(*pool.map(lambda j: make_chip(split, int(j)),
                                       order[i : i + batch]))
                item = {str(f): np.stack(z) for f, z in enumerate(fields)}
                if timing is not None:
                    timing["synth_secs"] += time.perf_counter() - t0
                yield item

    for b in prefetch_to_device(raw(), size=prefetch, device=device):
        yield tuple(b.values())


def binary_metrics(cm) -> dict:
    tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
    iou = tp / max(tp + fp + fn, 1)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    acc = (tp + tn) / max(cm.sum(), 1)
    return {"iou": iou, "f1": f1, "precision": prec, "recall": rec, "accuracy": acc}


def multiclass_metrics(cm, class_names=None) -> dict:
    """Per-class IoU + mean IoU + accuracy from an (C, C) confusion
    matrix (rows = truth). ``iou`` aliases ``mean_iou`` so the shared
    best-epoch tracking works unchanged."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    iou = tp / np.maximum(tp + fp + fn, 1)
    names = class_names or [f"c{i}" for i in range(cm.shape[0])]
    out = {
        "iou": float(iou.mean()),
        "mean_iou": float(iou.mean()),
        "accuracy": float(tp.sum() / max(cm.sum(), 1)),
    }
    out.update({f"iou_{n}": float(v) for n, v in zip(names, iou)})
    return out


def port_timings(steps, batch, train_secs, timing) -> dict:
    """The port's two keys of an epoch record: training chips over the
    training loop's wall seconds, and the seconds spent making chips."""
    return {"chips_per_s": round(steps * batch / max(train_secs, 1e-9), 1),
            "synth_secs": round(timing["synth_secs"], 1)}


def autocast(device: torch.device, compute_dtype):
    """bfloat16 autocast on CUDA when ``compute_dtype`` asks for it."""
    if compute_dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def scene_iou(prob: np.ndarray, labels: np.ndarray, threshold: float) -> float:
    """IoU of ``prob >= threshold`` against boolean ``labels``, 4 places."""
    pred = prob >= threshold
    tp = int((pred & labels).sum())
    fp = int((pred & ~labels).sum())
    fn = int((~pred & labels).sum())
    return round(tp / max(tp + fp + fn, 1), 4)


def run_convergence(
    state,
    train_step,
    eval_step,
    make_chip,
    args,
    log,
    extra_record=None,
    num_classes=2,
    metrics_fn=None,
    keep_best_state=False,
    on_best=None,
):
    """The shared epoch loop: train (the loss summed on the device — one
    host sync per epoch), eval to a confusion matrix summed on the host in
    float64, a JSONL record per epoch, best-epoch tracking (on
    ``metrics_fn``'s ``iou`` key — mean IoU for :func:`multiclass_metrics`).
    ``state`` is a ``train.trainer.TrainState`` that the steps update in
    place; batches go to ``args.device``. Returns (state, best: dict).

    With ``keep_best_state=True`` the returned state holds the BEST
    epoch's weights (a host copy of the parameters and BatchNorm buffers
    taken at each new best; the optimizer is not copied) rather than the
    last. ``on_best(state, best)``, when given, runs at each new best (the
    solar twin saves its checkpoint there).

    The JAX loop hands ``train_step`` a fresh ``jax.random`` key per step;
    the port's step takes none. No model the twins build draws from it:
    the U-Net's ``dropout`` is None as they build it, and the Siamese U-Net
    and DeepLab have no dropout."""
    metrics_fn = metrics_fn or binary_metrics
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    best = None
    best_state = None
    for epoch in range(args.epochs):
        t0 = time.time()
        timing = {"synth_secs": 0.0}
        tloss, steps = None, 0
        for x, y in chip_batches(make_chip, "train", args.train_size,
                                 args.batch_size, rng, device=device, timing=timing):
            out = train_step(state, (x, y))
            tloss = out["loss"] if tloss is None else tloss + out["loss"]
            steps += 1
        tloss = float(tloss) if steps else 0.0
        train_secs = time.time() - t0

        cm = np.zeros((num_classes, num_classes), np.float64)
        eloss, esteps = None, 0
        for x, y in chip_batches(make_chip, "eval", args.eval_size,
                                 args.batch_size, rng, shuffle=False, device=device,
                                 timing=timing):
            out = eval_step(state, (x, y))
            cm += out["cm"].cpu().numpy().astype(np.float64)
            eloss = out["loss"] if eloss is None else eloss + out["loss"]
            esteps += 1
        eloss = float(eloss) if esteps else 0.0

        m = metrics_fn(cm)
        rec = {
            "epoch": epoch,
            "train_loss": tloss / max(steps, 1),
            "eval_loss": eloss / max(esteps, 1),
            **{k: round(float(v), 4) for k, v in m.items()},
            "secs": round(time.time() - t0, 1),
            **port_timings(steps, args.batch_size, train_secs, timing),
        }
        if extra_record:
            rec.update(extra_record)
        # >= so the first epoch always seeds a full-schema best record
        if best is None or m["iou"] >= best["iou"]:
            best = {**m, "epoch": epoch}
            if keep_best_state:  # parameters and buffers (BN statistics)
                best_state = {k: v.detach().to("cpu", copy=True)
                              for k, v in state.model.state_dict().items()}
            if on_best is not None:
                on_best(state, best)
        print(json.dumps(rec))
        log.write(json.dumps(rec) + "\n")
        log.flush()
    if keep_best_state and best_state is not None:
        state.model.load_state_dict(best_state)
    return state, best or {}
