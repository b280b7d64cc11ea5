"""Tiled scene inference."""

from satellite_computervision_tpu_torch.inference.tiles import TiledInferenceEngine

__all__ = ["TiledInferenceEngine"]
