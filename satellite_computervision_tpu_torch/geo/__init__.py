"""Self-contained GeoTIFF codec (the port's own copy; no GDAL/rasterio)."""

from satellite_computervision_tpu_torch.geo.geotiff import (
    GeoTiffCogStreamWriter,
    GeoTiffScene,
    GeoTiffStreamWriter,
    read_geotiff,
    write_cog,
    write_geotiff,
)

__all__ = [
    "write_geotiff",
    "write_cog",
    "read_geotiff",
    "GeoTiffScene",
    "GeoTiffStreamWriter",
    "GeoTiffCogStreamWriter",
]
