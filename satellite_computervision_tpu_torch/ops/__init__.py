"""Image math on tensors (channels last): normalization, augmentation with
explicit draws, class handling, derived bands (``bands``) and densities
(``stats``)."""

from satellite_computervision_tpu_torch.ops.augment import (
    apply_morph,
    aug_color,
    aug_morph,
    draw_color_params,
    draw_morph_params,
)
from satellite_computervision_tpu_torch.ops.bands import calc_ndvi
from satellite_computervision_tpu_torch.ops.classes import merge_classes, one_hot
from satellite_computervision_tpu_torch.ops.normalize import (
    normalize_image,
    normalize_timeseries,
    rescale_image,
)

__all__ = [
    "normalize_image",
    "rescale_image",
    "normalize_timeseries",
    "aug_color",
    "draw_color_params",
    "aug_morph",
    "draw_morph_params",
    "apply_morph",
    "merge_classes",
    "one_hot",
    "calc_ndvi",
]
