"""LLFF dataset: poses_bounds.npy + images -> flat device-ready ray buffers.

Capability parity with reference datasets/llff.py, as pure numpy
host-side preprocessing. The train split materializes ALL rays for ALL images
into one flat (N, 8|9) buffer (llff.py:225-268) — which is exactly the right
shape for the TPU design: the whole buffer (a few tens of MB) is
`device_put` once and random ray batches are gathered on device inside the
jitted train step (no dataloader workers, no H2D copies per step).

Pose math preserved: "down right back" -> "right up back" axis flip
(llff.py:206), pose centering about the average pose (llff.py:18-81), scale so
the nearest depth sits at ~1.33 (near*0.75, llff.py:213-219), NDC rays with
near plane 1.0 for forward-facing scenes, spheric near/far from the bounds,
spiral/spheric test paths (llff.py:84-157).
"""

from __future__ import annotations

import glob
import os

import numpy as np
from PIL import Image

from hypernerf_tpu_torch.datasets.rays import (get_ndc_rays, get_ray_directions,
                                         get_rays, make_ray_tensor)


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """Average pose (llff.py:18-54): mean center, mean z, y via x = y' x z."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray):
    """Center poses about the average pose so NDC is usable (llff.py:57-81)."""
    pose_avg = average_poses(poses)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = np.linalg.inv(pose_avg_homo) @ poses_homo
    return poses_centered[:, :3], np.linalg.inv(pose_avg_homo)


def create_spiral_poses(radii, focus_depth, n_poses: int = 120) -> np.ndarray:
    """Spiral render path for forward-facing scenes (llff.py:84-116)."""
    poses_spiral = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        y_ = np.array([0, 1.0, 0])
        x = normalize(np.cross(y_, z))
        y = np.cross(z, x)
        poses_spiral.append(np.stack([x, y, z, center], 1))
    return np.stack(poses_spiral, 0)


def create_spheric_poses(radius, n_poses: int = 120) -> np.ndarray:
    """Circular render path around the z axis (llff.py:119-157)."""
    def spheric_pose(theta, phi, radius):
        trans_t = lambda t: np.array([
            [1, 0, 0, 0], [0, 1, 0, -0.9 * t], [0, 0, 1, t], [0, 0, 0, 1.0]])
        rot_phi = lambda p: np.array([
            [1, 0, 0, 0],
            [0, np.cos(p), -np.sin(p), 0],
            [0, np.sin(p), np.cos(p), 0],
            [0, 0, 0, 1.0]])
        rot_theta = lambda th: np.array([
            [np.cos(th), 0, -np.sin(th), 0],
            [0, 1, 0, 0],
            [np.sin(th), 0, np.cos(th), 0],
            [0, 0, 0, 1.0]])
        c2w = rot_theta(theta) @ rot_phi(phi) @ trans_t(radius)
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                        [0, 1, 0, 0], [0, 0, 0, 1.0]]) @ c2w
        return c2w[:3]

    return np.stack([spheric_pose(th, -np.pi / 5, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]], 0)


def _load_image(path: str, img_wh) -> np.ndarray:
    img = Image.open(path).convert('RGB')
    assert img.size[1] * img_wh[0] == img.size[0] * img_wh[1], (
        f'{path} has different aspect ratio than img_wh, check your data!')
    img = img.resize(img_wh, Image.Resampling.LANCZOS)
    return (np.asarray(img, np.float32) / 255.0).reshape(-1, 3)


class LLFFDataset:
    """LLFF scene loader.

    Same constructor surface and split semantics as the reference
    (llff.py:160-349): ``split`` in {'train','val','test','test_train'};
    train = flat ray/rgb buffers over all images except the val image (the one
    nearest the center pose); val = that held-out image, repeated ``val_num``
    times; test = spiral (forward-facing) or spheric path.

    ``__getitem__`` returns numpy dicts; for training use the flat
    ``all_rays``/``all_rgbs`` buffers directly (the TPU path).
    """
    def __init__(self, root_dir, split='train', img_wh=(504, 378),
                 spheric_poses=False, val_num=1, include_idx=False):
        self.root_dir = root_dir
        self.split = split
        self.img_wh = tuple(img_wh)
        self.spheric_poses = spheric_poses
        self.val_num = max(1, val_num)
        self.include_idx = include_idx
        self.white_back = False
        self._read_meta()

    def _read_meta(self):
        poses_bounds = np.load(os.path.join(self.root_dir, 'poses_bounds.npy'))
        self.image_paths = sorted(
            glob.glob(os.path.join(self.root_dir, 'images/*')))
        self.num_instance = len(self.image_paths)
        if self.split in ('train', 'val'):
            assert len(poses_bounds) == len(self.image_paths), (
                'Mismatch between number of images and number of poses! '
                'Please rerun COLMAP!')

        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        self.bounds = poses_bounds[:, -2:]

        h, w, self.focal = poses[0, :, -1]
        assert h * self.img_wh[0] == w * self.img_wh[1], (
            f'You must set img_wh to have the same aspect ratio as ({w}, {h})!')
        self.focal *= self.img_wh[0] / w

        # "down right back" -> "right up back" (llff.py:206).
        poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        self.poses, self.pose_avg = center_poses(poses)
        distances = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(distances))

        near_original = self.bounds.min()
        scale_factor = near_original * 0.75
        self.bounds = self.bounds / scale_factor
        self.poses[..., 3] /= scale_factor

        self.directions = get_ray_directions(
            self.img_wh[1], self.img_wh[0], self.focal)

        if self.spheric_poses:
            self.near = float(self.bounds.min())
            self.far = float(min(8 * self.near, self.bounds.max()))
        else:
            self.near, self.far = 0.0, 1.0

        if self.split == 'train':
            all_rays, all_rgbs = [], []
            for i, image_path in enumerate(self.image_paths):
                if i == self.val_idx:
                    continue
                all_rgbs.append(_load_image(image_path, self.img_wh))
                all_rays.append(self._rays_for_pose(
                    self.poses[i], idx=i if self.include_idx else None))
            self.all_rays = np.concatenate(all_rays, 0)
            self.all_rgbs = np.concatenate(all_rgbs, 0)
        elif self.split == 'val':
            self.c2w_val = self.poses[self.val_idx]
            self.image_path_val = self.image_paths[self.val_idx]
        else:
            if self.split.endswith('train'):
                self.poses_test = self.poses
            elif not self.spheric_poses:
                focus_depth = 3.5
                radii = np.percentile(np.abs(self.poses[..., 3]), 90, axis=0)
                self.poses_test = create_spiral_poses(radii, focus_depth)
            else:
                radius = 1.1 * self.bounds.min()
                self.poses_test = create_spheric_poses(radius)

    def _rays_for_pose(self, c2w, idx=None) -> np.ndarray:
        rays_o, rays_d = get_rays(self.directions, np.asarray(c2w, np.float32))
        if not self.spheric_poses:
            # NDC with the near plane at 1.0 (llff.py:245-251).
            rays_o, rays_d = get_ndc_rays(
                self.img_wh[1], self.img_wh[0], self.focal, 1.0,
                rays_o, rays_d)
        return make_ray_tensor(rays_o, rays_d, self.near, self.far, idx=idx)

    def __len__(self):
        if self.split == 'train':
            return len(self.all_rays)
        if self.split == 'val':
            return self.val_num
        return len(self.poses_test)

    def __getitem__(self, idx):
        if self.split == 'train':
            return {'rays': self.all_rays[idx], 'rgbs': self.all_rgbs[idx]}
        if self.split == 'val':
            c2w = self.c2w_val
            sample = {
                'rays': self._rays_for_pose(
                    c2w, idx=self.val_idx if self.include_idx else None),
                'c2w': np.asarray(c2w, np.float32),
                'rgbs': _load_image(self.image_path_val, self.img_wh),
            }
            return sample
        c2w = self.poses_test[idx]
        sample = {
            'rays': self._rays_for_pose(
                c2w, idx=idx if self.include_idx else None),
            'c2w': np.asarray(c2w, np.float32),
        }
        if self.split.endswith('train'):
            sample['rgbs'] = _load_image(self.image_paths[idx], self.img_wh)
        return sample
