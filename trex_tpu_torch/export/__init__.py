from .export import export_data, export_posture
from .library import EvalContext, column_title, evaluate
from .results import load_results, save_results

__all__ = ["export_data", "export_posture", "EvalContext", "column_title",
           "evaluate", "load_results", "save_results"]
