"""Machine-learning side of the port (counterpart of ``trex_tpu/ml``):
the apply half of the visual identification (``VINetwork``, uniqueness,
auto-correction) and the category label store that ``.results`` files
carry (``categorize.py``). Training (``Accumulation``, ``Categorizer``)
is the training slice's (ROADMAP.md A item 3b)."""
from .auto_correct import (
    Corrections,
    TrackletPrediction,
    assign_identities,
    check_tracklets_identities,
    predict_tracklets,
)
from .categorize import DataStore, RangedLabel
from .uniqueness import calculate_uniqueness, good_uniqueness
from .vi_facade import TrainingMode, VINetwork

__all__ = [
    "Corrections", "TrackletPrediction", "assign_identities",
    "check_tracklets_identities", "predict_tracklets", "DataStore",
    "RangedLabel", "calculate_uniqueness", "good_uniqueness",
    "TrainingMode", "VINetwork",
]
