"""Self-contained geospatial utilities (the port's own copies; no
GDAL/rasterio): the GeoTIFF/COG codec, affine transforms, CRS transforms
(``geo.crs``) and chip assembly (``geo.assembly``)."""

from satellite_computervision_tpu_torch.geo.geotiff import (
    GeoTiffCogStreamWriter,
    GeoTiffScene,
    GeoTiffStreamWriter,
    read_geotiff,
    write_cog,
    write_geotiff,
)
from satellite_computervision_tpu_torch.geo.transforms import (
    Affine,
    array_bounds,
    convert_poly_coords,
    convert_yolo_bbox,
    geo_to_pixel,
    geo_transform_from_mixer,
    make_jittered_window,
    make_window,
    pixel_to_geo,
    win_jitter,
)

__all__ = [
    "write_geotiff",
    "write_cog",
    "read_geotiff",
    "GeoTiffScene",
    "GeoTiffStreamWriter",
    "GeoTiffCogStreamWriter",
    "Affine",
    "geo_transform_from_mixer",
    "pixel_to_geo",
    "geo_to_pixel",
    "convert_poly_coords",
    "convert_yolo_bbox",
    "make_window",
    "win_jitter",
    "make_jittered_window",
    "array_bounds",
]
