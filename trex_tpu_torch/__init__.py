"""trex_tpu_torch: the PyTorch + CUDA port of trex_tpu.

The JAX package ``trex_tpu`` is the reference; this package imports
neither it nor JAX. Module layout mirrors ``trex_tpu`` so each
counterpart is easy to find (``trex_tpu_torch/ops/runcc.py`` mirrors
``trex_tpu/ops/runcc.py``, and so on).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
