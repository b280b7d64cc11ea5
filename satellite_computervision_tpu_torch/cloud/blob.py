"""Remote object IO: chips and checkpoints over https/Azure blob.

The port's own copy of ``satellite_computervision_tpu/cloud/blob.py``.
Reference: export_blob (utils/pc_tools.py:83-88), load_numpy_url
(utils/processing.py:527-537), get_blob_weights/get_blob_model
(utils/model_tools.py:1178-1269). The Azure SDK is optional — plain https
GET works against SAS-signed blob URLs with stdlib urllib, which is how
the reference's generators read chips anyway.
"""

from __future__ import annotations

import io
import os
import urllib.request
from typing import Optional

import numpy as np


def load_numpy(path_or_url: str) -> np.ndarray:
    """np.load from a local path or an http(s) URL
    (utils/processing.py:527-537)."""
    if path_or_url.startswith(("http://", "https://")):
        with urllib.request.urlopen(path_or_url) as resp:
            return np.load(io.BytesIO(resp.read()), allow_pickle=False)
    return np.load(path_or_url, allow_pickle=False)


def save_numpy(array: np.ndarray, destination: str, container=None):
    """np.save to a local path, or upload to an Azure container client when
    one is supplied (utils/pc_tools.py:83-88)."""
    if container is not None:
        buf = io.BytesIO()
        np.save(buf, array)
        buf.seek(0)
        container.upload_blob(name=destination, data=buf, overwrite=True)
        return
    os.makedirs(os.path.dirname(destination) or ".", exist_ok=True)
    np.save(destination, array)


def fetch_bytes(url: str) -> bytes:
    """https GET -> bytes (model/weight blobs,
    utils/model_tools.py:1178-1202)."""
    with urllib.request.urlopen(url) as resp:
        return resp.read()


def get_container_client(connection_string: Optional[str] = None, container: str = ""):
    """Azure ContainerClient when the SDK is installed; informative error
    otherwise (the SDK is optional)."""
    try:
        from azure.storage.blob import ContainerClient
    except ImportError as e:
        raise ImportError(
            "azure-storage-blob is not installed; pass SAS-signed https URLs "
            "to load_numpy/fetch_bytes instead"
        ) from e
    connection_string = connection_string or os.environ["AZURE_STORAGE_CONNECTION_STRING"]
    return ContainerClient.from_connection_string(connection_string, container)
