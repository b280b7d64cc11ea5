"""Cloud acquisition and its array math, ported from
``satellite_computervision_tpu/cloud`` (reference: utils/ee_tools.py,
utils/calibration.py, utils/pc_tools.py):

- ``masking``     — the per-pixel math of the EE ops (cloud/water/shadow
                    scores, QA masks, TOA conversion) as torch functions,
                    run on the device the band tensors live on;
- ``compositing`` — NaN-median composites and per-pixel normalization on
                    the device (stacking and mosaicking on the host);
- ``calibration`` — histogram-matching cross-scene calibration in NumPy
                    (the EE random-forest CDF-matching pipeline's array
                    equivalent);
- ``ee``          — thin Earth Engine client builders (the ``ee`` package
                    is imported inside the functions);
- ``pc``          — Planetary Computer STAC acquisition (pystac-client and
                    planetary-computer imported inside the functions) and
                    scene inference through the tiled engine;
- ``blob``        — Azure-blob/https object IO with a stdlib fallback.
"""

from satellite_computervision_tpu_torch.cloud import blob, calibration, masking

__all__ = ["masking", "calibration", "blob", "ee", "pc"]
