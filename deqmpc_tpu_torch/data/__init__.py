"""Expert-trajectory data pipeline and its noise augmentation (numpy only)."""
from .datagen import expert_data_path, get_gt_data, merge_gt_data, sample_trajectory
from .noise_utils import add_data_noise

__all__ = ["add_data_noise", "expert_data_path", "get_gt_data", "merge_gt_data",
           "sample_trajectory"]
