"""Utilities of the port: the depth visualization and the metrics logger
(``logging.MetricsLogger``)."""

from hypernerf_tpu_torch.utils.visualization import visualize_depth
