"""Posed-image datasets as per-pixel rays (counterpart of the JAX package's
``examples/utils/datasets.py``), in numpy on the port's
``utils/cameras.py``.

The procedural synthetic scene needs no download and is what the fitting
example trains on by default.  The file loaders (NeRF-synthetic, LLFF,
NSVF, CO3D) need image files and PIL or OpenCV and are not ported yet: they
raise ``NotImplementedError`` (ROADMAP, modules to port).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..utils.cameras import camera_rays, sphere_cameras


@dataclasses.dataclass
class RayDataset:
    """Flattened per-pixel rays of ``n_images`` images of ``height x
    width``, with their ground-truth colours."""

    origins: np.ndarray     # [N, 3]
    directions: np.ndarray  # [N, 3]
    gt: np.ndarray          # [N, 3]
    near: float
    far: float
    height: int
    width: int
    n_images: int

    def image(self, i: int):
        """``(origins, directions, gt [H, W, 3])`` of image ``i``."""
        hw = self.height * self.width
        sl = slice(i * hw, (i + 1) * hw)
        return (self.origins[sl], self.directions[sl],
                self.gt[sl].reshape(self.height, self.width, 3))


def make_synthetic_scene(
    n_views: int = 24,
    image_size: int = 64,
    near: float = 1.0,
    far: float = 5.0,
    seed: int = 0,
) -> RayDataset:
    """A procedurally rendered scene: six soft coloured blobs rendered by
    an analytic Emission-Absorption march over a white background, from
    ``n_views`` cameras on a circle of radius 3."""
    rng = np.random.RandomState(seed)
    n_blobs = 6
    centers = rng.uniform(-0.5, 0.5, (n_blobs, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (n_blobs, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.3, (n_blobs,)).astype(np.float32)

    c2ws = sphere_cameras(n_views, radius=3.0)
    focal = image_size * 1.2
    imgs = []
    n_steps = 64
    for c2w in c2ws:
        o, d = camera_rays(c2w, image_size, image_size, focal, near, far)
        ts = np.linspace(near, far, n_steps, dtype=np.float32)
        delta = ts[1] - ts[0]
        pts = o[:, None, :] + ts[None, :, None] * d[:, None, :]
        sigma = np.zeros(pts.shape[:2], np.float32)
        rgb = np.zeros(pts.shape[:2] + (3,), np.float32)
        wsum = np.zeros(pts.shape[:2], np.float32)
        for c, col, r in zip(centers, colors, radii):
            d2 = np.sum((pts - c) ** 2, -1)
            blob = np.exp(-d2 / (2 * r ** 2)).astype(np.float32)
            sigma += 25.0 * blob
            rgb += blob[..., None] * col
            wsum += blob
        rgb = rgb / np.maximum(wsum[..., None], 1e-6)
        nlt = np.cumsum(sigma * delta, -1)
        T = np.exp(-np.concatenate(
            [np.zeros_like(nlt[:, :1]), nlt], axis=-1))
        w = T[:, :-1] - T[:, 1:]
        img = (w[..., None] * rgb).sum(1) + T[:, -1:]  # white background
        imgs.append(img.reshape(image_size, image_size, 3))
    return _build_dataset(imgs, list(c2ws), focal, near, far)


def _build_dataset(imgs, c2ws, focal, near, far) -> RayDataset:
    H, W = imgs[0].shape[:2]
    all_o, all_d, all_gt = [], [], []
    for img, c2w in zip(imgs, c2ws):
        o, d = camera_rays(c2w, H, W, focal, near, far)
        all_o.append(o)
        all_d.append(d)
        all_gt.append(img.reshape(-1, 3).astype(np.float32))
    return RayDataset(
        origins=np.concatenate(all_o),
        directions=np.concatenate(all_d),
        gt=np.concatenate(all_gt),
        near=near,
        far=far,
        height=H,
        width=W,
        n_images=len(imgs),
    )


_LOADERS = ("nerf", "llff", "nsvf", "co3d")


def auto_dataset(root: Optional[str], dataset_type: str = "auto",
                 **kwargs) -> RayDataset:
    """``root=None`` (or ``dataset_type="synthetic"``) gives the synthetic
    scene, with ``kwargs`` passed to :func:`make_synthetic_scene`.  A
    dataset directory is detected as the JAX package detects it, but its
    loader is not ported yet."""
    if root is None or dataset_type == "synthetic":
        return make_synthetic_scene(**kwargs)
    if dataset_type == "auto":
        markers = {"nerf": "transforms_train.json",
                   "llff": "poses_bounds.npy", "nsvf": "intrinsics.txt"}
        found = [k for k, f in markers.items()
                 if os.path.exists(os.path.join(root, f))]
        if not found and any(
            os.path.exists(os.path.join(root, d, "frame_annotations.jgz"))
            for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        ):
            found = ["co3d"]
        if not found:
            raise ValueError(f"cannot detect dataset type under {root}")
        dataset_type = found[0]
    if dataset_type not in _LOADERS:
        raise ValueError(f"unknown dataset type {dataset_type!r}")
    raise NotImplementedError(
        f"the {dataset_type} loader is not ported to lightplane_tpu_torch "
        "yet (ROADMAP: the dataset file loaders); run without a dataset "
        "path for the synthetic scene"
    )
