"""Image math on tensors (channels last): normalization, augmentation with
explicit draws (the HSV pair too), class handling, harmonics, chip
geometry (``chips``), derived bands (``bands``) and densities
(``stats``)."""

from satellite_computervision_tpu_torch.ops.augment import (
    apply_morph,
    aug_color,
    aug_color_hsv,
    aug_morph,
    draw_color_params,
    draw_hsv_params,
    draw_morph_params,
    hsv_to_rgb,
    rgb_to_hsv,
)
from satellite_computervision_tpu_torch.ops.bands import calc_ndvi
from satellite_computervision_tpu_torch.ops.chips import (
    center_crop,
    extract_chips,
    generate_chip_indices,
    stitch_chips,
)
from satellite_computervision_tpu_torch.ops.classes import merge_classes, one_hot
from satellite_computervision_tpu_torch.ops.harmonics import add_harmonic, make_harmonics, sin_cos
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
    "aug_color_hsv",
    "draw_hsv_params",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "aug_morph",
    "draw_morph_params",
    "apply_morph",
    "merge_classes",
    "one_hot",
    "sin_cos",
    "make_harmonics",
    "add_harmonic",
    "generate_chip_indices",
    "extract_chips",
    "center_crop",
    "stitch_chips",
    "calc_ndvi",
]
