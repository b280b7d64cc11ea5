"""PyTorch / CUDA port of satellite_computervision_tpu for one NVIDIA H100.

The JAX package beside this one is the reference: every module here is
held against its JAX counterpart by the ``tests/test_torch_*.py`` tests.
This package imports ``torch``, never JAX, and nothing of the JAX package.
Entry points run on the GPU (``device="cuda"``) unless the caller asks for
the CPU, and raise when CUDA is absent.
"""

from satellite_computervision_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
