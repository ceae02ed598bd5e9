"""PFM depth-map I/O (parity with reference datasets/depth_utils.py)."""

from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(filename: str):
    """Read a PFM file -> (data, scale). data is (H, W[, 3]) float."""
    with open(filename, 'rb') as f:
        header = f.readline().decode('utf-8').rstrip()
        if header == 'PF':
            color = True
        elif header == 'Pf':
            color = False
        else:
            raise ValueError('Not a PFM file.')

        dim_match = re.match(r'^(\d+)\s(\d+)\s$', f.readline().decode('utf-8'))
        if not dim_match:
            raise ValueError('Malformed PFM header.')
        width, height = map(int, dim_match.groups())

        scale = float(f.readline().rstrip())
        endian = '<' if scale < 0 else '>'
        scale = abs(scale)

        data = np.fromfile(f, endian + 'f')
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def save_pfm(filename: str, image: np.ndarray, scale: float = 1):
    """Write a float32 (H, W[, 3|1]) image as PFM."""
    if image.dtype.name != 'float32':
        raise ValueError('Image dtype must be float32.')
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError('Image must be HxWx3, HxWx1 or HxW.')

    with open(filename, 'wb') as f:
        f.write(('PF\n' if color else 'Pf\n').encode('utf-8'))
        f.write(f'{image.shape[1]} {image.shape[0]}\n'.encode('utf-8'))
        endian = image.dtype.byteorder
        if endian == '<' or (endian == '=' and sys.byteorder == 'little'):
            scale = -scale
        f.write((f'{scale:f}\n').encode('utf-8'))
        image.tofile(f)
