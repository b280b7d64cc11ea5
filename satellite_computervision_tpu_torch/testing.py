"""Synthetic fixtures mimicking the cloud export formats exactly.

Earth Engine / Planetary Computer cannot run in CI (SURVEY.md §7 hard
part 6), so these generators fabricate their on-disk products:

- EE training exports: GZIP TFRecords of fixed-length (K, K) float bands
  (utils/processing.py:394-419 schema);
- EE prediction exports: buffered-patch TFRecords + the mixer JSON
  (utils/prediction_tools.py:159-226, 644-652);
- PC chip trees: per-source ``.npy`` chip directories with the
  ``<a>_<b>_<id3>_<id4>`` naming the file matchers key on
  (utils/processing.py:26-114).

Every generator plants deterministic, learnable structure (bright
rectangles on noise) so smoke tests can assert models actually learn.

The port's own copy of ``satellite_computervision_tpu/testing.py``: numpy
draws in the same order from the same seed, written through the port's
``data/tfrecord.py`` and ``inference/mixer.py``, so the records, ``.npy``
chips and mixer JSON are the JAX package's byte for byte (a GZIP file's
header holds its name and time; what it decompresses to is the same).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from satellite_computervision_tpu_torch.data.tfrecord import write_tfrecord_file
from satellite_computervision_tpu_torch.inference.mixer import MixerInfo, write_mixer

DEFAULT_AFFINE = (10.0, 0.0, 500000.0, 0.0, -10.0, 4500000.0)


def synth_chip(rng, kernel: int, bands: Sequence[str], target_boost: float = 0.5):
    """One chip: noise background + bright rectangles, with a binary label."""
    chip = {b: rng.uniform(0.05, 0.3, (kernel, kernel)).astype(np.float32) for b in bands}
    label = np.zeros((kernel, kernel), np.float32)
    for _ in range(int(rng.integers(1, 4))):
        y, x = rng.integers(2, max(3, kernel - kernel // 4), 2)
        h, w = rng.integers(kernel // 8, kernel // 4, 2)
        label[y : y + h, x : x + w] = 1.0
        for b in bands:
            chip[b][y : y + h, x : x + w] += target_boost
    return chip, label


def make_training_tfrecord(
    path: str,
    n_examples: int = 32,
    kernel: int = 64,
    bands: Sequence[str] = ("B2", "B3", "B4", "B8"),
    response: str = "landcover",
    seed: int = 0,
    compression: Optional[str] = "GZIP",
) -> None:
    """EE training-export TFRecord (fixed-length float features)."""
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(n_examples):
        chip, label = synth_chip(rng, kernel, bands)
        ex = {b: v.reshape(-1) for b, v in chip.items()}
        ex[response] = label.reshape(-1)
        examples.append(ex)
    write_tfrecord_file(path, examples, compression)


def make_prediction_export(
    out_dir: str,
    rows: int = 2,
    cols: int = 3,
    kernel: int = 32,
    buffer: int = 16,
    bands: Sequence[str] = ("B2", "B3", "B4", "B8"),
    base: str = "export",
    affine: Tuple[float, ...] = DEFAULT_AFFINE,
    crs: str = "EPSG:32617",
    seed: int = 0,
    files: int = 1,
) -> Tuple[List[str], str]:
    """EE prediction export: buffered patches + mixer JSON. Returns
    (tfrecord paths, mixer path)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    side = kernel + buffer
    total = rows * cols
    per_file = -(-total // files)
    paths = []
    remaining = total
    for fi in range(files):
        n = min(per_file, remaining)
        remaining -= n
        examples = []
        for _ in range(n):
            chip, _ = synth_chip(rng, side, bands)
            examples.append({b: v.reshape(-1) for b, v in chip.items()})
        p = os.path.join(out_dir, f"{base}-{fi:05d}.tfrecord")
        write_tfrecord_file(p, examples, "GZIP")
        paths.append(p)
    mixer = MixerInfo(
        total_patches=total,
        patches_per_row=cols,
        patch_dimensions=(kernel, kernel),
        affine=tuple(affine),
        crs=crs,
    )
    mixer_path = os.path.join(out_dir, f"{base}-mixer.json")
    write_mixer(mixer_path, mixer)
    return paths, mixer_path


def make_npy_chip_tree(
    root: str,
    sources: Dict[str, Tuple[int, float]] = None,
    n_chips: int = 8,
    dim: int = 32,
    n_classes: int = 8,
    seed: int = 0,
) -> Dict[str, List[str]]:
    """PC-style per-source npy chip directories.

    ``sources`` maps source name -> (channels, scale), default the
    reference's NAIP/S2/DEM trio; a ``label`` source is always written.
    Filenames follow the ``<site>_<date>_<id3>_<id4>`` convention the file
    matchers slice (utils/processing.py:26-45). Returns {source: [paths]}.
    """
    rng = np.random.default_rng(seed)
    if sources is None:
        sources = {"naip": (4, 255.0), "s2": (4, 10000.0), "dem": (1, 2000.0)}
    out: Dict[str, List[str]] = {}
    for name, (channels, scale) in sources.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        files = []
        for i in range(n_chips):
            arr = (rng.uniform(0, 1, (channels, dim, dim)) * scale).astype(np.float32)
            p = os.path.join(d, f"{name}_site_2021_{i:03d}_x.npy")
            np.save(p, arr)
            files.append(p)
        out[name] = files
    d = os.path.join(root, "label")
    os.makedirs(d, exist_ok=True)
    labels = []
    for i in range(n_chips):
        arr = rng.integers(0, n_classes, (1, dim, dim)).astype(np.uint8)
        p = os.path.join(d, f"label_site_2021_{i:03d}_x.npy")
        np.save(p, arr)
        labels.append(p)
    out["label"] = labels
    return out


def make_siamese_chip_tree(
    root: str, n_chips: int = 6, dim: int = 32, channels: int = 4, seed: int = 0
) -> Dict[str, List[str]]:
    """Before/after/label npy chips for the change-detection family
    (SiameseDataGenerator inputs, utils/processing.py:757-892)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, List[str]] = {}
    for name in ("before", "after"):
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        files = []
        for i in range(n_chips):
            arr = (rng.uniform(0, 1, (channels, dim, dim)) * 10000).astype(np.float32)
            p = os.path.join(d, f"{name}_site_2021_{i:03d}_x.npy")
            np.save(p, arr)
            files.append(p)
        out[name] = files
    d = os.path.join(root, "label")
    os.makedirs(d, exist_ok=True)
    labels = []
    for i in range(n_chips):
        arr = rng.integers(0, 3, (1, dim, dim)).astype(np.uint8)
        p = os.path.join(d, f"label_site_2021_{i:03d}_x.npy")
        np.save(p, arr)
        labels.append(p)
    out["label"] = labels
    return out


def make_series_chips(
    root: str, n_chips: int = 6, n_time: int = 7, channels: int = 4,
    dim: int = 32, seed: int = 0, start_month: int = 3,
) -> List[str]:
    """(T, C, H, W) npy timeseries chips for the ConvLSTM families
    (LSTMDataGenerator inputs, utils/processing.py:895-972). The filename's
    third '_'-part carries the start month the LSTM-AE harmonics parse."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    files = []
    for i in range(n_chips):
        arr = (rng.uniform(0, 1, (n_time, channels, dim, dim)) * 10000).astype(np.float32)
        p = os.path.join(root, f"series_site_{start_month}_{i:03d}.npy")
        np.save(p, arr)
        files.append(p)
    return files
