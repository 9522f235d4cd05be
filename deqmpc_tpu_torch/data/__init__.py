"""Expert-trajectory data pipeline (numpy only)."""
from .datagen import expert_data_path, get_gt_data, merge_gt_data, sample_trajectory

__all__ = ["expert_data_path", "get_gt_data", "merge_gt_data", "sample_trajectory"]
