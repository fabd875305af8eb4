"""Machine-learning side of the port (counterpart of ``trex_tpu/ml``):
the visual identification (``VINetwork``, the accumulation curriculum,
uniqueness, auto-correction) and categorization (``Categorizer`` and
the label store that ``.results`` files carry)."""
from .accumulation import (
    Accumulation,
    AccumulationReason,
    AccumulationResult,
    AccumulationStatus,
)
from .auto_correct import (
    Corrections,
    TrackletPrediction,
    assign_identities,
    check_tracklets_identities,
    predict_tracklets,
)
from .categorize import Categorizer, DataStore, RangedLabel
from .uniqueness import calculate_uniqueness, good_uniqueness
from .vi_facade import TrainingMode, VINetwork

__all__ = [
    "Accumulation", "AccumulationReason", "AccumulationResult",
    "AccumulationStatus", "Corrections", "TrackletPrediction",
    "assign_identities", "check_tracklets_identities", "predict_tracklets",
    "Categorizer", "DataStore", "RangedLabel", "calculate_uniqueness",
    "good_uniqueness", "TrainingMode", "VINetwork",
]
