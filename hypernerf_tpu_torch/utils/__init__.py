"""Utilities of the port (numpy only)."""

from hypernerf_tpu_torch.utils.visualization import visualize_depth
