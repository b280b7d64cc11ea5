"""Scene inference: the tiled engine, its geometry tuner, EE patch
batches, mixer reassembly and prediction writers."""

from satellite_computervision_tpu_torch.inference.mixer import (
    MixerInfo,
    read_mixer,
    reassemble_patches,
)
from satellite_computervision_tpu_torch.inference.tiles import TiledInferenceEngine
from satellite_computervision_tpu_torch.inference.tune import (
    GeometryTiming,
    candidate_geometries,
    tune_engine_geometry,
)
from satellite_computervision_tpu_torch.inference.writers import (
    predictions_to_examples,
    write_tfrecord_predictions,
)

__all__ = [
    "TiledInferenceEngine",
    "GeometryTiming",
    "candidate_geometries",
    "tune_engine_geometry",
    "MixerInfo",
    "read_mixer",
    "reassemble_patches",
    "write_tfrecord_predictions",
    "predictions_to_examples",
]
