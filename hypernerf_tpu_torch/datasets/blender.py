"""Blender (NeRF-synthetic) dataset loader.

Capability parity with reference datasets/blender.py: transforms_*.json,
focal from camera_angle_x at the 800px reference resolution, near=2 far=6,
RGBA blended onto white, white background. Pure numpy; the train split is one
flat (N, 8|9) ray buffer for the device-resident pipeline. ``include_idx``
(metadata image ids) is supported here too, which the reference's Blender
loader lacks despite train.py passing it (train.py:82 would crash — fixed by
accepting it).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image

from hypernerf_tpu_torch.datasets.rays import (get_ray_directions, get_rays,
                                         make_ray_tensor)


def _load_rgba(path: str, img_wh):
    img = Image.open(path)
    img = img.resize(img_wh, Image.Resampling.LANCZOS)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 4, axis=-1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], axis=-1)
    arr = arr.reshape(-1, 4)
    rgb = arr[:, :3] * arr[:, -1:] + (1.0 - arr[:, -1:])  # blend A onto white
    valid_mask = arr[:, 3] > 0
    return rgb.astype(np.float32), valid_mask


class BlenderDataset:
    """NeRF-synthetic loader with the reference's constructor surface."""

    def __init__(self, root_dir, split='train', img_wh=(800, 800),
                 include_idx=False, **_unused):
        assert img_wh[0] == img_wh[1], 'image width must equal image height!'
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.include_idx = include_idx
        self.white_back = True
        self._read_meta()

    def _read_meta(self):
        with open(os.path.join(self.root_dir,
                               f'transforms_{self.split}.json')) as f:
            self.meta = json.load(f)

        w, h = self.img_wh
        self.focal = 0.5 * 800 / np.tan(0.5 * self.meta['camera_angle_x'])
        self.focal *= self.img_wh[0] / 800

        self.near, self.far = 2.0, 6.0
        self.bounds = np.array([self.near, self.far])
        self.directions = get_ray_directions(h, w, self.focal)
        self.num_instance = len(self.meta['frames'])

        if self.split == 'train':
            all_rays, all_rgbs = [], []
            self.image_paths, self.poses = [], []
            for i, frame in enumerate(self.meta['frames']):
                pose = np.array(frame['transform_matrix'])[:3, :4]
                self.poses.append(pose)
                image_path = os.path.join(self.root_dir,
                                          f"{frame['file_path']}.png")
                self.image_paths.append(image_path)
                rgb, _ = _load_rgba(image_path, self.img_wh)
                all_rgbs.append(rgb)
                rays_o, rays_d = get_rays(self.directions,
                                          pose.astype(np.float32))
                all_rays.append(make_ray_tensor(
                    rays_o, rays_d, self.near, self.far,
                    idx=i if self.include_idx else None))
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)

    def __len__(self):
        if self.split == 'train':
            return len(self.all_rays)
        if self.split == 'val':
            return min(8, len(self.meta['frames']))
        return len(self.meta['frames'])

    def __getitem__(self, idx):
        if self.split == 'train':
            return {'rays': self.all_rays[idx], 'rgbs': self.all_rgbs[idx]}
        frame = self.meta['frames'][idx]
        c2w = np.array(frame['transform_matrix'], np.float32)[:3, :4]
        image_path = os.path.join(self.root_dir, f"{frame['file_path']}.png")
        rgb, valid_mask = _load_rgba(image_path, self.img_wh)
        rays_o, rays_d = get_rays(self.directions, c2w)
        rays = make_ray_tensor(rays_o, rays_d, self.near, self.far,
                               idx=idx if self.include_idx else None)
        return {'rays': rays, 'rgbs': rgb, 'c2w': c2w,
                'valid_mask': valid_mask}
