""".npy chip datasets: multi-source U-Net chips, before/after pairs,
timeseries and hybrid U-Net + timeseries batches.

Port of ``satellite_computervision_tpu/data/chip_generators.py`` (the
reference's UNETDataGenerator / SiameseDataGenerator / LSTMDataGenerator /
LSTMAutoencoderGenerator / HybridDataGenerator,
utils/processing.py:456-1184).

- The host does the IO and layout (CHW -> HWC, centre trim, stack) in
  NumPy and yields NumPy batches, as the JAX datasets do; the training CLI
  moves them to the device.
- The shuffle order and the NaN fills come from
  ``np.random.default_rng(seed)``, drawn in the JAX dataset's order, so
  they equal its draws. Colour and morph draws come from an explicit
  ``torch.Generator`` through ``ops/augment.py``'s ``draw_*`` functions
  (torch's Philox and JAX's threefry never give the same numbers; the
  tests inject JAX's).
- A batch that holds NaNs without ``add_nan_mask`` (a source without
  ``nan_mask``) raises rather than being skipped, and a series whose
  next-step label is all zero at every one of 8 rotations raises, as in
  JAX.
- Colour augmentation takes the 5-D ``(B, T, H, W, C)`` series as the 4-D
  chips: the means are over the two spatial axes.

Per-source rescale divisors match the reference: NAIP/255, S2/10000,
HAG & LiDAR/100, DEM/2000, S1/-50.
"""

from __future__ import annotations

import dataclasses
import io
import urllib.request
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from satellite_computervision_tpu_torch.ops.augment import (
    apply_morph,
    aug_color,
    draw_color_params,
    draw_morph_params,
)
from satellite_computervision_tpu_torch.ops.classes import merge_classes
from satellite_computervision_tpu_torch.ops.harmonics import make_harmonics

# the reference's class transitions (utils/processing.py:466-467)
DEFAULT_LC_TRANSITIONS = [(12, 3), (11, 3), (10, 3), (9, 8), (255, 0)]
DEFAULT_LU_TRANSITIONS = [(82, 9), (84, 10)]

RESCALE_DIVISORS = {
    "naip": 255.0,
    "s2": 10000.0,
    "hag": 100.0,
    "lidar": 100.0,
    "dem": 2000.0,
    "s1": -50.0,
    "ssurgo": None,
}

# sources whose invalid pixels are masked and random-filled
MASKED_SOURCES = ("hag", "lidar", "dem")
# sources that are colour-augmented when fitting
COLOR_AUG_SOURCES = ("naip", "s2")


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


@dataclasses.dataclass
class ChipSource:
    """One variable's chip files and its preprocessing policy."""

    files: Sequence[str]
    divisor: Optional[float] = None
    nan_mask: bool = False
    color_aug: bool = False

    @staticmethod
    def named(name: str, files: Sequence[str]) -> "ChipSource":
        return ChipSource(files=files, divisor=RESCALE_DIVISORS.get(name),
                          nan_mask=name in MASKED_SOURCES, color_aug=name in COLOR_AUG_SOURCES)


def _recolor(data: np.ndarray, gen: torch.Generator) -> np.ndarray:
    """One colour draw (per channel, shared by the batch) applied to a
    channels-last batch, NaN-aware."""
    contra, bright = draw_color_params(gen, data.shape[-1])
    return aug_color(torch.from_numpy(np.ascontiguousarray(data)), contra, bright,
                     nan_aware=True).numpy()


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


class UNetChipDataset(_BaseChipDataset):
    """Multi-source U-Net chip batches. ``sources`` is an ordered
    ``{name: ChipSource}``; label (and land-use) files are separate.
    Yields ``(feats, one_hot_labels)`` when ``to_fit`` (colour draws for
    the colour sources, then one flip/rot90 draw for features and labels
    alike), else ``feats``."""

    def __init__(
        self,
        sources: Dict[str, ChipSource],
        label_files: Optional[Sequence[str]] = None,
        lu_files: Optional[Sequence[str]] = None,
        batch_size: int = 32,
        unet_dim: Tuple[int, int] = (256, 256),
        n_classes: int = 8,
        shuffle: bool = True,
        to_fit: bool = True,
        lc_transitions=tuple(DEFAULT_LC_TRANSITIONS),
        lu_transitions=tuple(DEFAULT_LU_TRANSITIONS),
        seed: int = 0,
    ):
        self.sources = sources
        self.label_files = label_files
        self.lu_files = lu_files
        self.unet_dim = unet_dim
        self.n_classes = n_classes
        self.lc_transitions = list(lc_transitions) if lc_transitions else None
        self.lu_transitions = list(lu_transitions) if lu_transitions else None
        n_items = len(label_files if label_files is not None
                      else next(iter(sources.values())).files)
        super().__init__(n_items, batch_size, shuffle, seed, to_fit)

    def _load_source(self, source: ChipSource, idxs: np.ndarray) -> np.ndarray:
        """Load -> CHW -> divide -> NaN mask and fill -> trim -> (B, H, W, C)."""
        arrays = [_to_chw(np.asarray(load_numpy(source.files[k]), np.float32)) for k in idxs]
        if source.divisor:
            arrays = [a / source.divisor for a in arrays]
        batch = np.stack(arrays)  # (B, C, H, W)
        if source.nan_mask:
            # the mask channel is appended when fitting and when not, so the
            # model's input width is stable; invalid pixels are filled with
            # normal draws only when fitting
            invalid = ~np.isfinite(batch) | (batch < -5000)
            mask = invalid.any(axis=1, keepdims=True).astype(np.float32)
            if self.to_fit:
                fill = self._rng.standard_normal(batch.shape).astype(np.float32)
                batch = np.where(invalid, fill, batch)
            batch = np.concatenate([batch, mask], axis=1)
        if not np.isfinite(batch).all():
            raise ValueError("NaNs in batch (source without nan_mask)")
        batch = _center_trim_hw(batch, self.unet_dim, h_axis=2)
        return np.moveaxis(batch, 1, 3)

    def _process_y(self, idxs: np.ndarray) -> np.ndarray:
        """Labels: land-cover reclass, land-use overlay, trim, one-hot."""
        lc = torch.from_numpy(np.stack(
            [np.asarray(load_numpy(self.label_files[k])) for k in idxs]).astype(int))
        if self.lc_transitions:
            lc = merge_classes(lc, self.lc_transitions)
        if self.lu_files is not None and self.lu_transitions:
            lu = torch.from_numpy(np.stack(
                [np.asarray(load_numpy(self.lu_files[k])) for k in idxs]).astype(int))
            lc = merge_classes(lu, self.lu_transitions, out_array=lc)
        lc = np.squeeze(_center_trim_hw(lc.numpy(), self.unet_dim, h_axis=2), axis=1)
        return np.eye(self.n_classes, dtype=np.float32)[lc]  # (B, H, W, n_classes)

    def _load_sources(self, idxs: np.ndarray) -> np.ndarray:
        pieces = []
        for source in self.sources.values():
            data = self._load_source(source, idxs)
            if source.color_aug and self.to_fit:
                data = _recolor(data, self._gen)
            pieces.append(data)
        return np.concatenate(pieces, axis=-1)

    def __getitem__(self, index: int):
        idxs = self._batch_indexes(index)
        x = self._load_sources(idxs)
        if not self.to_fit:
            return x
        y = self._process_y(idxs)
        params = draw_morph_params(self._gen)
        x = apply_morph(torch.from_numpy(x), *params).numpy()
        y = apply_morph(torch.from_numpy(y), *params).numpy()
        return x, y


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
            batch = _recolor(batch, self._gen)
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


def rearrange_timeseries(batch: np.ndarray, rng: np.random.Generator):
    """Rotate the sequence start at random, keeping the relative order;
    returns ``(rearranged, start)``."""
    t = batch.shape[1]
    start = int(rng.integers(0, t))
    return np.concatenate([batch[:, start:], batch[:, :start]], axis=1), start


def split_timeseries(batch: np.ndarray, n_channels: int):
    """(B, T, H, W, C) -> the first T-1 steps, and the last step's first
    ``n_channels`` bands (the next-step label)."""
    return batch[:, :-1], batch[:, -1, :, :, :n_channels]


class LSTMChipDataset(_BaseChipDataset):
    """(T, C, H, W) ``.npy`` series -> ``(B, T-1, H, W, C)`` features and the
    next step ``(B, H, W, n_channels)`` as the label, divided by
    ``divisor``, non-finite values 0, the start rotated at random."""

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int = 32,
        dim: Tuple[int, int] = (256, 256),
        n_channels: int = 4,
        n_timesteps: int = 6,
        divisor: float = 10000.0,
        shuffle: bool = True,
        to_fit: bool = True,
        seed: int = 0,
    ):
        self.files = files
        self.dim = dim
        self.n_channels = n_channels
        self.n_timesteps = n_timesteps
        self.divisor = divisor
        super().__init__(len(files), batch_size, shuffle, seed, to_fit)

    def _load_batch(self, idxs: np.ndarray, timesteps: int) -> np.ndarray:
        arrays = [np.asarray(load_numpy(self.files[k]), np.float32) for k in idxs]
        batch = np.stack(arrays)[:, :timesteps]  # (B, T, C, H, W)
        batch = _center_trim_hw(batch, self.dim, h_axis=3)
        batch = np.moveaxis(batch, 2, 4)  # (B, T, H, W, C)
        normalized = batch / self.divisor
        return np.where(np.isfinite(normalized), normalized, 0.0)

    def __getitem__(self, index: int):
        idxs = self._batch_indexes(index)
        normalized = self._load_batch(idxs, self.n_timesteps)
        if not self.to_fit:
            return normalized
        for _ in range(8):  # rotate again while a label comes out all zero
            rearranged, _ = rearrange_timeseries(normalized, self._rng)
            feats, labels = split_timeseries(rearranged, self.n_channels)
            if not np.any(labels.sum(axis=(1, 2, 3)) == 0.0):
                return feats, labels
        # a series that is zero at every rotation has no next-step target
        empty = [int(k) for k, s in zip(idxs, labels.sum(axis=(1, 2, 3))) if s == 0.0]
        raise ValueError(
            "all-empty next-step labels after 8 sequence rotations for "
            f"series files {[self.files[k] for k in empty]}; drop these "
            "series (every timestep is zero) or pass to_fit=False"
        )


class LSTMAutoencoderChipDataset(LSTMChipDataset):
    """Adds the sin/cos harmonics input, the reversed-sequence target and
    optional relative-error sample weights: loads ``n_timesteps + 1``
    steps and yields ``[feats, harmonics], [reversed feats, next step],
    weights``. The start month is the third ``_``-part of the file stem
    (``s2_x_<month>_...``)."""

    def __init__(self, *args, harmonics: bool = True, sample_weights: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.harmonics = harmonics
        self.sample_weights = sample_weights

    def _harmonics(self, starts) -> np.ndarray:
        return make_harmonics(torch.tensor(starts), self.n_timesteps, self.dim).numpy()

    def __getitem__(self, index: int):
        idxs = self._batch_indexes(index)
        normalized = self._load_batch(idxs, self.n_timesteps + 1)
        starts = [int(Path(self.files[k]).stem.split("_")[2]) for k in idxs]
        if not self.to_fit:
            return [normalized, self._harmonics(starts) if self.harmonics else None]
        rearranged, start = rearrange_timeseries(normalized, self._rng)
        feats, y = split_timeseries(rearranged, self.n_channels)
        temporal_y = np.flip(feats, axis=1)
        weights = None
        if self.sample_weights:
            last = feats[:, -1]
            weights = [None, np.abs(last - y) / (last + y)]
        harmonics = None
        if self.harmonics:
            harmonics = self._harmonics([s + start - self.n_timesteps for s in starts])
        return [feats, harmonics], [temporal_y, y], weights


class HybridChipDataset(UNetChipDataset):
    """U-Net sources plus the S2 (and S1) series of the hybrid model:
    yields ``[unet_data, lstm_data]`` and, when ``to_fit``, the one-hot
    labels. The S2 series is divided by 10000 and colour-augmented when
    fitting, the S1 series divided by -50; both centre-trimmed to
    ``lstm_dim``'s (T, H, W), non-finite values 0. No flip/rot90."""

    def __init__(
        self,
        sources: Dict[str, ChipSource],
        s2_series_files: Optional[Sequence[str]] = None,
        s1_series_files: Optional[Sequence[str]] = None,
        lstm_dim: Tuple[int, int, int, int] = (6, 32, 32, 6),
        **kwargs,
    ):
        super().__init__(sources, **kwargs)
        self.s2_series_files = s2_series_files
        self.s1_series_files = s1_series_files
        self.lstm_dim = lstm_dim

    def _load_series(self, files: Sequence[str], idxs: np.ndarray, maxval: float) -> np.ndarray:
        arrays = [np.asarray(load_numpy(files[k]), np.float32) for k in idxs]
        batch = np.stack(arrays)[:, : self.lstm_dim[0]]  # (B, T, C, H, W)
        batch = _center_trim_hw(batch, self.lstm_dim[1:3], h_axis=3)
        normalized = np.moveaxis(batch, 2, 4) / maxval
        return np.where(np.isfinite(normalized), normalized, 0.0)

    def __getitem__(self, index: int):
        idxs = self._batch_indexes(index)
        lstm_pieces = []
        if self.s2_series_files is not None:
            s2 = self._load_series(self.s2_series_files, idxs, 10000.0)
            lstm_pieces.append(_recolor(s2, self._gen) if self.to_fit else s2)
        if self.s1_series_files is not None:
            lstm_pieces.append(self._load_series(self.s1_series_files, idxs, -50.0))
        lstm_data = np.concatenate(lstm_pieces, axis=-1)
        unet_data = self._load_sources(idxs)
        if not self.to_fit:
            return [unet_data, lstm_data]
        return [unet_data, lstm_data], self._process_y(idxs)
