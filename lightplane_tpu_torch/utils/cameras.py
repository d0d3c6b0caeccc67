"""Cameras and ray generation (counterpart of
``lightplane_tpu/utils/cameras.py``).

A minimal pinhole camera model in numpy, the same arithmetic as the JAX
package's, plus :func:`rays_for_camera`, which builds the port's
:class:`~lightplane_tpu_torch.Rays` on a device.

Convention: the camera-to-world matrix ``c2w`` is ``[3, 4]`` (or
``[4, 4]``), OpenGL-style: the camera looks down ``-z``, ``x`` right, ``y``
up, as in the NeRF-synthetic and LLFF datasets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.rays import Rays


def pixel_ray_directions(
    height: int,
    width: int,
    focal: float,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
) -> np.ndarray:
    """Per-pixel camera-space ray directions ``[H, W, 3]`` (OpenGL: -z
    forward)."""
    cx = (width - 1) * 0.5 if cx is None else cx
    cy = (height - 1) * 0.5 if cy is None else cy
    i, j = np.meshgrid(
        np.arange(width, dtype=np.float32),
        np.arange(height, dtype=np.float32),
        indexing="xy",
    )
    return np.stack(
        [(i - cx) / focal, -(j - cy) / focal, -np.ones_like(i)], axis=-1
    )


def camera_rays(
    c2w: np.ndarray,
    height: int,
    width: int,
    focal: float,
    near: float,
    far: float,
    grid_idx: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """World-space ray ``(origins, directions)``, each ``[H*W, 3]``, for one
    camera, in raster order."""
    dirs_cam = pixel_ray_directions(height, width, focal)
    R = np.asarray(c2w)[:3, :3]
    t = np.asarray(c2w)[:3, 3]
    dirs = dirs_cam.reshape(-1, 3) @ R.T
    origins = np.broadcast_to(t, dirs.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


def rays_for_camera(
    c2w: np.ndarray,
    height: int,
    width: int,
    focal: float,
    near: float,
    far: float,
    grid_idx: int = 0,
    encoding: Optional[torch.Tensor] = None,
    device="cuda",
) -> Rays:
    """A :class:`Rays` batch covering the full image of one camera, on
    ``device`` (the GPU unless the caller asks for ``"cpu"``)."""
    origins, dirs = camera_rays(c2w, height, width, focal, near, far)
    n = origins.shape[0]
    return Rays(
        directions=torch.from_numpy(dirs).to(device),
        origins=torch.from_numpy(np.ascontiguousarray(origins)).to(device),
        grid_idx=torch.full((n,), grid_idx, dtype=torch.int64, device=device),
        near=torch.full((n,), float(near), device=device),
        far=torch.full((n,), float(far), device=device),
        encoding=encoding,
    )


def look_at_c2w(
    eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)
) -> np.ndarray:
    """Camera-to-world matrix looking from ``eye`` toward ``target``."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    # OpenGL convention: camera -z axis = forward
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def sphere_cameras(
    n: int,
    radius: float = 3.0,
    elevation_deg: float = 20.0,
) -> np.ndarray:
    """``[n, 4, 4]`` camera-to-world matrices on a circle around the
    origin, looking at it."""
    cams = []
    el = np.deg2rad(elevation_deg)
    for az in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = radius * np.array(
            [np.cos(az) * np.cos(el), np.sin(el), np.sin(az) * np.cos(el)],
            dtype=np.float32,
        )
        cams.append(look_at_c2w(eye, np.zeros(3)))
    return np.stack(cams)
