"""TFRecord chip datasets and batch preprocessing on the device.

Port of ``satellite_computervision_tpu/data/pipeline.py``. Host threads
read and parse TFRecords into numpy batches (``ChipDataset``,
``_shuffled``, ``_batched``: the same order as the JAX package for a
seed); :func:`prefetch_to_device` moves each batch to the device through
the serving engine's stager (``staging``: a pinned ring, a side CUDA
stream) while the previous step runs; the numeric preprocessing
(:func:`make_preprocess_fn`) runs on the device on whole batches.

Spans (``utils.profiling.span``, recorded only while a ``torch.profiler``
session runs), each with the batch's sequence number ``batch``:
``train.batch`` (shuffle and stack), ``train.stage`` (pinned copies, with
their ``bytes``; inside it ``train.ring_wait``) and ``train.stage_ahead``
on the staging thread, ``train.batch_wait`` on the consumer's; the
returned preprocess runs in ``train.preprocess``.

``make_preprocess_fn`` with per-chip, per-channel rescaling (``axes=(0,
1)``, no ``moments``, no ``splits``) runs the hand-written CUDA
``fused_preprocess`` (kernels/preprocess.py) on ``[continuous bands ‖
one-hot features ‖ response]``: the same function as the plain op chain,
in one kernel call per batch. Other settings run the plain ops.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from satellite_computervision_tpu_torch._device import resolve_device
from satellite_computervision_tpu_torch.kernels.preprocess import (
    draw_augment_params,
    fused_preprocess,
)
from satellite_computervision_tpu_torch.ops.augment import aug_color, apply_morph
from satellite_computervision_tpu_torch.ops.classes import one_hot as one_hot_encode
from satellite_computervision_tpu_torch.ops.normalize import rescale_image
from satellite_computervision_tpu_torch.staging import stage_to_device
from satellite_computervision_tpu_torch.utils.profiling import span


class ChipDataset:
    """Iterates (K, K)-shaped feature dicts from EE-exported TFRecords.

    ``feature_names`` lists every band stored per example (features +
    response, the EE export schema of fixed-length float lists); each is
    reshaped to ``(kernel, kernel)``. ``workers > 1`` decodes files on a
    thread pool (gzip and the native codec release the GIL); files then
    complete out of order, so keep ``workers=1`` for a deterministic order.
    """

    def __init__(self, files: Sequence[str], feature_names: Sequence[str],
                 kernel_size: int = 256, compression: Optional[str] = "GZIP",
                 workers: int = 1):
        self.files = list(files)
        self.feature_names = list(feature_names)
        self.kernel_size = kernel_size
        self.compression = compression
        self.workers = workers

    def _read_file(self, path):
        from satellite_computervision_tpu_torch.data.tfrecord import read_float_examples

        k = self.kernel_size
        return [
            {name: arr.reshape(k, k) for name, arr in row.items()}
            for row in read_float_examples(path, self.feature_names, self.compression)
        ]

    def __iter__(self):
        if self.workers <= 1 or len(self.files) <= 1:
            for path in self.files:
                yield from self._read_file(path)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.workers) as pool:
            # a bounded in-flight window keeps memory flat while decoding
            # overlaps
            files = iter(self.files)
            pending = [pool.submit(self._read_file, p)
                       for _, p in zip(range(self.workers), files)]
            while pending:
                done = pending.pop(0)
                nxt = next(files, None)
                if nxt is not None:
                    pending.append(pool.submit(self._read_file, nxt))
                yield from done.result()


def make_preprocess_fn(
    features: Sequence[str],
    response: str,
    axes: Sequence[int] = (2,),
    splits=None,
    moments=None,
    one_hot: Optional[Dict[str, int]] = None,
    response_depth: Optional[int] = None,
    derived: Optional[Dict[str, Callable]] = None,
    augment: bool = True,
    device="cuda",
) -> Callable:
    """Build the batch preprocess: dict of (B, K, K) bands -> (x, y) on
    ``device``.

    Mirrors the JAX function element for element: derived bands, one-hot
    response (``response_depth``) or expand-dims, continuous band stack ->
    color aug -> rescale, concat one-hot feature bands + response, joint
    morph aug, split, clip labels to <= 1. ``augment=False`` (or
    ``train=False`` per call) drops both random augs.

    The returned ``preprocess(batch, generator=None, train=True,
    draws=None)`` draws, per chip, ``n_color`` contrast and brightness
    multipliers and one morph from ``generator`` (:func:`draw_augment_params`)
    unless ``draws=(contra, bright, morph)`` is given; augmenting without
    either raises. ``preprocess.fused`` says whether the call goes through
    ``fused_preprocess`` (``axes == (0, 1)``, no moments, no splits).
    """
    device = resolve_device(device)
    one_hot = one_hot or {}
    derived = derived or {}
    continuous = [f for f in features if f not in one_hot]
    n_color = len(continuous)
    fused = tuple(axes) == (0, 1) and moments is None and splits is None
    # rescale_image takes per-image axes; the batch adds a leading axis
    batch_axes = tuple(a % 3 + 1 for a in axes)

    def preprocess(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                   train: bool = True, draws=None):
        with span("train.preprocess"):
            return _preprocess(batch, generator, train, draws)

    def _preprocess(batch, generator, train, draws):
        # staged batches may be float16 (TrainIterator stage_dtype); all
        # math runs in float32
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True).float()
                 for k, v in batch.items()}
        for name, fn in derived.items():
            batch[name] = fn(batch)
        if response_depth is not None:
            res = one_hot_encode(batch[response], response_depth)
        else:
            res = batch[response][..., None]
        onehots = [one_hot_encode(batch[name], depth)
                   for name, depth in one_hot.items() if name in features]

        aug = augment and train
        if aug and draws is None:
            if generator is None:
                raise ValueError("augmenting needs a generator (or explicit draws)")
            draws = draw_augment_params(generator, batch[response].shape[0], n_color)
        contra, bright, morph = draws if aug else (None, None, None)

        if fused:
            # the planes of [bands ‖ one-hots ‖ response] stacked along a
            # leading axis, then one transpose to channels last: stacking
            # along the last axis writes 4-byte runs C floats apart and is
            # ~8x slower on the card (PERF.md)
            planes = [batch[f] for f in continuous] + [
                plane for t in onehots + [res] for plane in t.unbind(-1)]
            stacked = fused_preprocess(
                torch.stack(planes).permute(1, 2, 3, 0).contiguous(), n_color,
                contra, bright, morph, augment=aug)
        else:
            bands = torch.stack([batch[f] for f in continuous], dim=-1)  # (B, K, K, C)
            if aug:
                bands = aug_color(bands, contra[:, None, None, :n_color].to(device),
                                  bright[:, None, None, :n_color].to(device))
            bands = rescale_image(bands, axes=batch_axes, moments=moments, splits=splits)
            stacked = torch.cat([bands, *onehots, res], dim=-1)
            if aug:
                stacked = torch.stack([apply_morph(chip, *m)
                                       for chip, m in zip(stacked, morph.tolist())])

        n_res = res.shape[-1]
        feats = stacked[..., :-n_res]
        labels = torch.clamp(stacked[..., -n_res:], max=1.0)
        return feats, labels

    preprocess.fused = fused
    return preprocess


def _batched(iterator, batch_size: int, feature_names, drop_remainder=False):
    """Batch a dict-example stream. The final partial batch is kept by
    default (tf.data ``.batch``); repeating training streams drop it so
    every step has one shape."""
    buf = []
    for ex in iterator:
        buf.append(ex)
        if len(buf) == batch_size:
            yield {name: np.stack([b[name] for b in buf]) for name in feature_names}
            buf = []
    if buf and not drop_remainder:
        yield {name: np.stack([b[name] for b in buf]) for name in feature_names}


def _shuffled(iterator, buffer_size: int, rng: random.Random):
    """Reservoir-style shuffle buffer (tf.data ``.shuffle`` equivalent)."""
    buf = []
    for ex in iterator:
        buf.append(ex)
        if len(buf) >= buffer_size:
            i = rng.randrange(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Device batches from a stream of dicts of numpy arrays, staged on a
    thread at most ``size`` batches ahead (``staging.stage_to_device``) so
    host decode and the copies overlap the consumer's device work. Worker
    errors re-raise in the consumer; closing the stream joins the thread."""
    device = resolve_device(device)

    def batches():
        it, n = iter(iterator), 0
        while True:
            with span("train.batch", batch=n):
                batch = next(it, None)
            if batch is None:
                return
            yield batch, None
            n += 1

    staged = stage_to_device(batches(), size, device, key="batch", stage="train.stage",
                             ring_wait="train.ring_wait", ahead="train.stage_ahead",
                             wait="train.batch_wait")
    try:
        for batch, _ in staged:
            yield batch
    finally:
        staged.close()


class TrainIterator:
    """Shuffled, batched, optionally repeating device-batch stream:
    shuffle(buffer) -> batch(batch_size) -> repeat, one
    ``random.Random(seed + epoch)`` per epoch as the JAX package orders it.

    ``stage_dtype`` (e.g. ``np.float16``) halves the host-to-device bytes;
    the preprocess casts back to float32 on the device. ``device`` defaults
    to CUDA and raises without it."""

    def __init__(self, dataset: ChipDataset, batch_size: int = 16, shuffle_buffer: int = 1024,
                 repeat: bool = True, seed: int = 0, prefetch: int = 2,
                 drop_remainder: Optional[bool] = None, stage_dtype=None, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer
        self.repeat = repeat
        self.seed = seed
        self.prefetch = prefetch
        self.stage_dtype = stage_dtype
        # repeating (training) streams default to one static shape;
        # single-pass (eval) streams keep the tail batch
        self.drop_remainder = repeat if drop_remainder is None else drop_remainder
        self.device = resolve_device(device)

    def _epochs(self):
        epoch = 0
        while True:
            rng = random.Random(self.seed + epoch)
            it = iter(self.dataset)
            if self.shuffle_buffer > 1:
                it = _shuffled(it, self.shuffle_buffer, rng)
            batches = _batched(it, self.batch_size, self.dataset.feature_names,
                               self.drop_remainder)
            if self.stage_dtype is not None:
                dt = self.stage_dtype
                batches = ({name: arr.astype(dt) for name, arr in b.items()} for b in batches)
            yield from batches
            epoch += 1
            if not self.repeat:
                return

    def __iter__(self):
        return prefetch_to_device(self._epochs(), self.prefetch, self.device)


def get_training_dataset(files, feature_names, kernel_size: int = 256, batch_size: int = 16,
                         shuffle_buffer: int = 1024, repeat: bool = True, seed: int = 0,
                         compression: Optional[str] = "GZIP", workers: int = 2,
                         stage_dtype=None, device="cuda") -> TrainIterator:
    ds = ChipDataset(files, feature_names, kernel_size, compression, workers=workers)
    return TrainIterator(ds, batch_size, shuffle_buffer, repeat, seed,
                         stage_dtype=stage_dtype, device=device)


def get_eval_dataset(files, feature_names, kernel_size: int = 256, batch_size: int = 1,
                     compression: Optional[str] = "GZIP", device="cuda") -> TrainIterator:
    """Unshuffled, single pass."""
    ds = ChipDataset(files, feature_names, kernel_size, compression)
    return TrainIterator(ds, batch_size, shuffle_buffer=0, repeat=False, device=device)
