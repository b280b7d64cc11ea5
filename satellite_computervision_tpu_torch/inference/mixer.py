"""Earth Engine "mixer" metadata and patch reassembly.

Reference: callback_predictions / make_array_predictions
(utils/prediction_tools.py:245-373). An EE export is a row-major stream of
(kernel + buffer)^2 patches plus a mixer JSON carrying ``totalPatches``,
``patchesPerRow``, ``patchDimensions`` and the projection (affine
doubleMatrix + crs). Reassembly crops each patch's buffer and lays central
windows on the kernel grid — done here as one NumPy reshape/transpose
instead of the reference's per-patch ``np.append`` loop (which is O(n^2)
in copies).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MixerInfo:
    total_patches: int
    patches_per_row: int
    patch_dimensions: Tuple[int, int]  # (x, y) size of the *central* patch
    affine: Tuple[float, float, float, float, float, float]
    crs: str

    @property
    def rows(self) -> int:
        return self.total_patches // self.patches_per_row

    @property
    def scene_shape(self) -> Tuple[int, int]:
        return (
            self.rows * self.patch_dimensions[1],
            self.patches_per_row * self.patch_dimensions[0],
        )


def read_mixer(path_or_dict) -> MixerInfo:
    """Parse an EE mixer JSON file/dict (utils/prediction_tools.py:644-652)."""
    if isinstance(path_or_dict, dict):
        mixer = path_or_dict
    else:
        with open(path_or_dict) as f:
            mixer = json.load(f)
    proj = mixer.get("projection", {})
    affine = tuple(proj.get("affine", {}).get("doubleMatrix", (1, 0, 0, 0, 1, 0)))
    dims = tuple(mixer.get("patchDimensions", (256, 256)))
    return MixerInfo(
        total_patches=mixer["totalPatches"],
        patches_per_row=mixer["patchesPerRow"],
        patch_dimensions=(dims[0], dims[1]),
        affine=affine,
        crs=proj.get("crs", ""),
    )


def write_mixer(path: str, mixer: MixerInfo) -> None:
    """Serialize a MixerInfo back to EE's JSON schema (fixtures/tests)."""
    payload = {
        "totalPatches": mixer.total_patches,
        "patchesPerRow": mixer.patches_per_row,
        "patchDimensions": list(mixer.patch_dimensions),
        "projection": {
            "affine": {"doubleMatrix": list(mixer.affine)},
            "crs": mixer.crs,
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def reassemble_patches(
    predictions: np.ndarray,
    mixer: MixerInfo,
    kernel_buffer: Sequence[int] = (128, 128),
    channels: Optional[slice] = None,
) -> np.ndarray:
    """(N, side, side, C) patch predictions -> (H, W, C) scene array.

    Crops ``buffer/2`` from every edge of each patch and tiles the central
    windows row-major, matching utils/prediction_tools.py:293-373. Patches
    with no halo (side == kernel) pass through uncropped.
    """
    predictions = np.asarray(predictions)
    if predictions.ndim == 3:
        predictions = predictions[..., None]
    if channels is not None:
        predictions = predictions[..., channels]

    kx, ky = mixer.patch_dimensions
    xb = int(kernel_buffer[0]) // 2
    yb = int(kernel_buffer[1]) // 2
    n, side_y, side_x, c = predictions.shape
    if n != mixer.total_patches:
        raise ValueError(
            f"got {n} patches, mixer declares {mixer.total_patches}"
        )
    if side_y != ky + 2 * yb or side_x != kx + 2 * xb:
        # allow unbuffered patches
        if side_y == ky and side_x == kx:
            xb = yb = 0
        else:
            raise ValueError(
                f"patch shape {(side_y, side_x)} inconsistent with kernel "
                f"{(ky, kx)} + buffer {kernel_buffer}"
            )

    central = predictions[:, yb : yb + ky, xb : xb + kx, :]
    rows, cols = mixer.rows, mixer.patches_per_row
    return (
        central.reshape(rows, cols, ky, kx, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rows * ky, cols * kx, c)
    )
