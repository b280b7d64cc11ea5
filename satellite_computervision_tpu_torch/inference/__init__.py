"""Scene inference: the tiled engine, EE patch batches, mixer reassembly
and prediction writers."""

from satellite_computervision_tpu_torch.inference.mixer import (
    MixerInfo,
    read_mixer,
    reassemble_patches,
)
from satellite_computervision_tpu_torch.inference.tiles import TiledInferenceEngine
from satellite_computervision_tpu_torch.inference.writers import (
    predictions_to_examples,
    write_tfrecord_predictions,
)

__all__ = [
    "TiledInferenceEngine",
    "MixerInfo",
    "read_mixer",
    "reassemble_patches",
    "write_tfrecord_predictions",
    "predictions_to_examples",
]
