"""L1 data layer: dataset registry (parity with reference datasets/__init__.py)."""

from hypernerf_tpu_torch.datasets.blender import BlenderDataset
from hypernerf_tpu_torch.datasets.llff import LLFFDataset

dataset_dict = {
    'blender': BlenderDataset,
    'llff': LLFFDataset,
}
