"""Typed workload configs (the port's own copy of the JAX package's
``train/config.py``, kept value-for-value so the two packages serve the
same geometry and parity tests compare like with like).

The reference configures runs via module-level constants in notebook cells
(BANDS/RESPONSE/KERNEL_SIZE/BATCH_SIZE/EPOCHS/..., solar notebook cell 17,
parking cell 16). Presets below carry those exact values.

``serve_*``, ``train_batch`` and ``space_to_depth`` were chosen from
measurements on a TPU v5e, not on an H100. They are kept for parity; they
are not H100 measurements and should be re-decided only from H100 runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str
    bands: Sequence[str]
    response: str
    kernel_size: int
    kernel_buffer: int
    batch_size: int
    epochs: int
    learning_rate: float
    train_size: int
    eval_size: int
    shuffle_buffer: int
    loss: str
    loss_kwargs: Dict = dataclasses.field(default_factory=dict)
    num_classes: int = 1
    threshold: float = 0.5
    monitor: str = "mean_iou"
    one_hot: Optional[Dict[str, int]] = None
    axes: Tuple[int, ...] = (2,)
    splits: Optional[Sequence[int]] = None
    family: str = "unet"
    n_time: int = 6
    # Serving geometry (chip kernel/buffer/batch for inference). None =
    # fall back to the training kernel/buffer/batch.
    serve_kernel: Optional[int] = None
    serve_buffer: Optional[int] = None
    serve_batch: Optional[int] = None
    # Training geometry: train_batch applies to every training path,
    # train_tile only to generator-fed training.
    train_tile: Optional[int] = None
    train_batch: Optional[int] = None
    # Space-to-depth stem for from-scratch U-Net training (models/unet.py).
    space_to_depth: bool = False

    @property
    def serving_geometry(self) -> Tuple[int, int, int]:
        """(kernel, buffer, batch) the predict CLI serves by default."""
        return (
            self.serve_kernel or self.kernel_size,
            self.serve_buffer if self.serve_buffer is not None else self.kernel_buffer,
            self.serve_batch or self.batch_size,
        )

    @property
    def training_geometry(self) -> Tuple[int, int]:
        """(tile, batch) for generator-fed training."""
        return (
            self.train_tile or self.kernel_size,
            self.train_batch or self.batch_size,
        )

    @property
    def steps_per_epoch(self) -> int:
        return self.train_size // self.batch_size

    @property
    def eval_steps(self) -> int:
        return self.eval_size


# Solar-array U-Net on Sentinel-2 (solar notebook cell 17; threshold 0.9
# per utils/model_tools.py:444-445).
SOLAR_CONFIG = TrainConfig(
    name="solar",
    bands=("B2", "B3", "B4", "B8", "B11", "B12"),
    response="landcover",
    kernel_size=256,
    kernel_buffer=128,
    batch_size=16,
    epochs=20,
    learning_rate=9e-4,
    train_size=7700,
    eval_size=3300,
    shuffle_buffer=11000,
    loss="weighted_bce",
    loss_kwargs={"pos_weight": 1.0},
    num_classes=1,
    threshold=0.9,
    # chosen on a TPU v5e (k512+b128 batch 16 beat the k256 training
    # geometry there); not an H100 measurement
    serve_kernel=512,
    serve_buffer=128,
    serve_batch=16,
    # chosen on a TPU v5e; not an H100 measurement
    train_batch=64,
    space_to_depth=True,
)

# Parking-lot model on NAIP RGB (parking notebook cells 16, 39, 58).
PARKING_CONFIG = TrainConfig(
    name="parking",
    bands=("R", "G", "B"),
    response="impervious",
    kernel_size=512,
    kernel_buffer=256,
    batch_size=16,
    epochs=50,
    learning_rate=9e-4,
    train_size=8000,
    eval_size=5000,
    shuffle_buffer=8000,
    loss="weighted_bce",
    loss_kwargs={"pos_weight": 20.0},
    num_classes=1,
    threshold=0.5,
)

# Sentinel-2 before/after change detection with the Siamese U-Net
# (make_siamese_unet utils/model_tools.py:638-663; chips fed by
# SiameseDataGenerator utils/processing.py:757-892, /10000 divisor,
# binary any-class>1 labels; scene assembly = run_local's 4-band pairs,
# utils/pc_tools.py:620-654).
CHANGE_CONFIG = TrainConfig(
    name="change",
    bands=("B02", "B03", "B04", "B08"),
    response="change",
    kernel_size=256,
    kernel_buffer=128,
    batch_size=8,
    epochs=20,
    learning_rate=9e-4,
    train_size=4000,
    eval_size=1000,
    shuffle_buffer=4000,
    loss="weighted_bce",
    loss_kwargs={"pos_weight": 4.0},
    num_classes=1,
    threshold=0.5,
    family="siamese",
)

# ConvLSTM next-step timeseries regression (get_lstm_model
# utils/model_tools.py:773-808; LSTMDataGenerator utils/processing.py:
# 895-972: (T, C, H, W) npy series, /10000, random sequence rotation).
TIMESERIES_CONFIG = TrainConfig(
    name="timeseries",
    bands=("B02", "B03", "B04", "B08"),
    response="next",
    kernel_size=64,
    kernel_buffer=32,
    batch_size=16,
    epochs=20,
    learning_rate=9e-4,
    train_size=2000,
    eval_size=500,
    shuffle_buffer=2000,
    loss="mse_4d",
    num_classes=4,
    monitor="loss",
    family="convlstm",
    n_time=6,
)

# Hierarchical landcover (hybrid / ACNN / hierarchical families; 8 classes
# = get_hybrid_model's default, utils/model_tools.py:874-920; chips from
# HybridDataGenerator utils/processing.py:1051-1184). At kernel_size 256
# the hybrid's (3, 2, 2, 2) pools do not round-trip (256 -> 85 -> 42 -> 21
# -> 10 -> 20 != 21), so the hybrid family fails to build here, as in the
# JAX package; acnn and hierarchical train at 256.
LANDCOVER_CONFIG = TrainConfig(
    name="landcover",
    bands=("R", "G", "B", "N"),
    response="lc",
    kernel_size=256,
    kernel_buffer=128,
    batch_size=8,
    epochs=30,
    learning_rate=9e-4,
    train_size=4000,
    eval_size=1000,
    shuffle_buffer=4000,
    loss="weighted_categorical_crossentropy",
    num_classes=8,
    monitor="mean_iou",
    family="hybrid",
    n_time=6,
)

# Wetland mapping (README capability; the reference's azure/
# train_wetland.py driver is absent from its snapshot). S1+S2 timeseries
# through the ConvLSTM branch and terrain/soil planes through the U-Net
# branch of the hybrid model, binary wetland response. The same 256² as
# landcover, so the hybrid fails to build at it, as in JAX.
WETLAND_CONFIG = TrainConfig(
    name="wetland",
    bands=("VV", "VH", "B02", "B03", "B04", "B08"),
    response="wetland",
    kernel_size=256,
    kernel_buffer=128,
    batch_size=8,
    epochs=30,
    learning_rate=9e-4,
    train_size=4000,
    eval_size=1000,
    shuffle_buffer=4000,
    loss="weighted_categorical_crossentropy",
    num_classes=2,  # not-wetland / wetland via the hybrid's softmax head
    threshold=0.5,
    family="hybrid",
    n_time=6,
)

CONFIGS = {
    "solar": SOLAR_CONFIG,
    "parking": PARKING_CONFIG,
    "change": CHANGE_CONFIG,
    "timeseries": TIMESERIES_CONFIG,
    "landcover": LANDCOVER_CONFIG,
    "wetland": WETLAND_CONFIG,
}
