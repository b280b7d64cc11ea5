""".npy chip datasets: the before/after pairs of change detection.

Port of ``satellite_computervision_tpu/data/chip_generators.py``
(``_to_chw``, ``_center_trim_hw``, ``_BaseChipDataset``,
``SiameseChipDataset``; the reference's SiameseDataGenerator,
utils/processing.py:757-892). The multi-source U-Net, LSTM, LSTM
autoencoder and hybrid datasets are not ported yet.

- The host does the IO and layout (CHW -> HWC, centre trim, stack) in
  NumPy and yields NumPy batches, as the JAX datasets do; the training CLI
  moves them to the device.
- The shuffle order and the NaN fills come from
  ``np.random.default_rng(seed)``, drawn in the JAX dataset's order, so
  they equal its draws. Colour and morph draws come from an explicit
  ``torch.Generator`` through ``ops/augment.py``'s ``draw_*`` functions
  (torch's Philox and JAX's threefry never give the same numbers; the
  tests inject JAX's).
- A batch that holds NaNs without ``add_nan_mask`` raises rather than
  being skipped.
"""

from __future__ import annotations

import io
import urllib.request
from typing import Sequence, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch.ops.augment import (
    apply_morph,
    aug_color,
    draw_color_params,
    draw_morph_params,
)


def load_numpy(path_or_url: str) -> np.ndarray:
    """np.load from a local path or an http(s) URL (own copy of
    ``cloud/blob.py::load_numpy``)."""
    if path_or_url.startswith(("http://", "https://")):
        with urllib.request.urlopen(path_or_url) as resp:
            return np.load(io.BytesIO(resp.read()), allow_pickle=False)
    return np.load(path_or_url, allow_pickle=False)


def _to_chw(arr: np.ndarray) -> np.ndarray:
    """Ensure (C, H, W): chips arrive CHW but some are HWC (the
    reference's heuristic: channels is the small axis)."""
    if arr.shape[-1] < arr.shape[0]:
        return np.moveaxis(arr, -1, 0)
    return arr


def _center_trim_hw(arr: np.ndarray, dim: Tuple[int, int], h_axis: int) -> np.ndarray:
    th = (arr.shape[h_axis] - dim[0]) // 2
    tw = (arr.shape[h_axis + 1] - dim[1]) // 2
    slicer = [slice(None)] * arr.ndim
    slicer[h_axis] = slice(th, th + dim[0])
    slicer[h_axis + 1] = slice(tw, tw + dim[1])
    return arr[tuple(slicer)]


class _BaseChipDataset:
    def __init__(self, n_items: int, batch_size: int, shuffle: bool, seed: int, to_fit: bool):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.to_fit = to_fit
        self._n_items = n_items
        self._rng = np.random.default_rng(seed)
        self._gen = torch.Generator().manual_seed(seed)
        self.on_epoch_end()

    def __len__(self) -> int:
        return self._n_items // self.batch_size

    def on_epoch_end(self):
        self.indexes = np.arange(self._n_items)
        if self.shuffle:
            self._rng.shuffle(self.indexes)

    def _batch_indexes(self, index: int) -> np.ndarray:
        return self.indexes[index * self.batch_size : (index + 1) * self.batch_size]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
        self.on_epoch_end()


class SiameseChipDataset(_BaseChipDataset):
    """Before/after chip pairs for change detection.

    Yields ``[before, after]`` (each ``(B, H, W, C)`` float32, divided by
    ``divisor`` and centre-trimmed to ``unet_dim``) and, when ``to_fit``,
    the binary labels ``(B, H, W, 1)`` (class > 1 -> 1), after one colour
    draw per side (per channel, shared by the batch) and one flip/rot90
    draw for the before + after + label stack. ``add_nan_mask`` fills
    invalid pixels (non-finite or below -1 after the divide) with uniform
    draws and zeroes the labels where either side is invalid."""

    def __init__(
        self,
        before_files: Sequence[str],
        after_files: Sequence[str],
        label_files: Sequence[str],
        add_nan_mask: bool = False,
        batch_size: int = 32,
        unet_dim: Tuple[int, int] = (256, 256),
        divisor: float = 10000.0,
        shuffle: bool = True,
        to_fit: bool = True,
        seed: int = 0,
    ):
        self.before_files = before_files
        self.after_files = after_files
        self.label_files = label_files
        self.add_nan_mask = add_nan_mask
        self.unet_dim = unet_dim
        self.divisor = divisor
        super().__init__(len(label_files), batch_size, shuffle, seed, to_fit)

    def _load_pairside(self, files: Sequence[str], idxs: np.ndarray):
        arrays = [_to_chw(np.asarray(load_numpy(files[k]), np.float32)) for k in idxs]
        batch = np.stack(arrays) / self.divisor
        batch = _center_trim_hw(batch, self.unet_dim, h_axis=2)
        batch = np.moveaxis(batch, 1, 3)  # (B, H, W, C)
        if self.add_nan_mask:
            invalid = ~np.isfinite(batch) | (batch < -1)
            mask = 1.0 - invalid.any(axis=-1, keepdims=True).astype(np.float32)
            batch = np.where(invalid, self._rng.random(batch.shape).astype(np.float32), batch)
        else:
            if not np.isfinite(batch).all():
                raise ValueError("NaNs in batch, enable add_nan_mask")
            mask = None
        if self.to_fit:
            contra, bright = draw_color_params(self._gen, batch.shape[-1])
            batch = aug_color(torch.from_numpy(np.ascontiguousarray(batch)), contra, bright,
                              nan_aware=True).numpy()
        return batch, mask

    def _process_y(self, idxs: np.ndarray) -> np.ndarray:
        """Binary labels: any class > 1 -> 1."""
        lc = np.stack(
            [np.squeeze(np.asarray(load_numpy(self.label_files[k]))) for k in idxs]
        ).astype(int)
        binary = np.where(lc > 1, 1, lc)
        binary = _center_trim_hw(binary, self.unet_dim, h_axis=1)
        return binary[..., None].astype(np.float32)

    def __getitem__(self, index: int):
        idxs = self._batch_indexes(index)
        before, mask_b = self._load_pairside(self.before_files, idxs)
        after, mask_a = self._load_pairside(self.after_files, idxs)
        if not self.to_fit:
            return [before, after]
        labels = self._process_y(idxs)
        if self.add_nan_mask:
            labels = labels * np.minimum(mask_b, mask_a)
        c = before.shape[-1]
        stacked = torch.from_numpy(np.concatenate([before, after, labels], axis=-1))
        morphed = apply_morph(stacked, *draw_morph_params(self._gen)).numpy()
        return [morphed[..., :c], morphed[..., c : 2 * c]], morphed[..., -1:]
