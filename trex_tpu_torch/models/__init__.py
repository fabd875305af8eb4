"""The visual-identification networks of the port (counterpart of
``trex_tpu/models``): the zoo, its weights in the JAX package's layout
and the ``VITrainer`` that trains and predicts."""
from .training import VITrainer
from .vi_network import VERSIONS, V118_3, V119, V200, SmallMLP, ViT, build

__all__ = ["VITrainer", "VERSIONS", "V118_3", "V119", "V200", "SmallMLP",
           "ViT", "build"]
