"""The ``Rays`` data model and ray-encoding helpers (counterpart of
``lightplane_tpu/ops/rays.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Rays:
    """A batch of rendering rays.

    A 3D point along a ray is ``origin + t * direction`` with
    ``t in [near, far]``.  Each ray carries an integer ``grid_idx`` that
    selects the scene (batch element) of the grid-list it samples, and an
    optional per-ray feature ``encoding``.

    Fields (``N`` = number of rays):
        directions: ``(N, 3)`` float
        origins:    ``(N, 3)`` float
        grid_idx:   ``(N,)``   int
        near:       ``(N,)``   float
        far:        ``(N,)``   float
        encoding:   optional ``(N, C)`` float
    """

    directions: torch.Tensor
    origins: torch.Tensor
    grid_idx: torch.Tensor
    near: torch.Tensor
    far: torch.Tensor
    encoding: Optional[torch.Tensor] = None

    def __post_init__(self):
        _validate_rays(
            self.directions, self.origins, self.grid_idx, self.near, self.far,
            self.encoding,
        )

    def __len__(self) -> int:
        return self.directions.shape[0]

    def _map(self, fn) -> "Rays":
        return type(self)(**{
            f.name: (None if getattr(self, f.name) is None
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)
        })

    def __getitem__(self, key) -> "Rays":
        return self._map(lambda v: v[key])

    def pad_to_block_size(self, block_size: int) -> Tuple["Rays", int]:
        """The rays with zero rays appended up to a multiple of
        ``block_size``, and the number appended."""
        n_pad = -len(self) % block_size
        if n_pad == 0:
            return self, 0
        return self._map(lambda v: torch.cat(
            [v, v.new_zeros((n_pad,) + tuple(v.shape[1:]))])), n_pad

    def to(self, device, copy: bool = False) -> "Rays":
        """Place all fields on ``device`` (copied even where they already
        lie there when ``copy``)."""
        return self._map(lambda v: v.to(device, copy=copy))

    def clone(self) -> "Rays":
        """A copy of every field."""
        return self._map(torch.clone)


def calc_harmonic_embedding(
    directions: torch.Tensor, n_harmonic_functions: int
) -> torch.Tensor:
    """NeRF-style harmonic embedding of ray directions:
    ``[sin(2^k d) for k, d], [cos(2^k d) for k, d], d`` concatenated on the
    last axis (sin block, then cos block, each ordered by direction axis
    then frequency); ``n_harmonic_functions == 0`` returns ``directions``."""
    if n_harmonic_functions == 0:
        return directions
    dt, dev = directions.dtype, directions.device
    freqs = 2.0 ** torch.arange(n_harmonic_functions, dtype=dt, device=dev)
    zero_half_pi = torch.tensor([0.0, 0.5 * math.pi], dtype=dt, device=dev)
    embed = directions[..., None] * freqs                   # [..., 3, n]
    embed = embed[..., None, :, :] + zero_half_pi[:, None, None]
    embed = torch.sin(embed).reshape(*directions.shape[:-1], -1)
    return torch.cat([embed, directions], dim=-1)


def calc_harmonic_embedding_dim(n_harmonic_functions: int) -> int:
    """Output dim of ``calc_harmonic_embedding``: 3 + 2*3*n."""
    return 3 + 2 * 3 * n_harmonic_functions


def jitter_near_far(
    near: torch.Tensor,
    far: torch.Tensor,
    num_samples: int,
    generator: Optional[torch.Generator] = None,
):
    """Jitter near/far by a shared uniform offset in [-delta, delta],
    delta = (far - near) / num_samples, drawn from ``generator``."""
    delta = (far - near) / num_samples
    u = torch.rand(
        near.shape, generator=generator, dtype=near.dtype,
        device=generator.device if generator is not None else near.device,
    ).to(near.device)
    offs = (2.0 * u - 1.0) * delta
    return near + offs, far + offs


def _validate_rays(directions, origins, grid_idx, near, far, encoding):
    n_rays = directions.shape[0]
    if directions.ndim != 2 or directions.shape[1] != 3:
        raise ValueError("directions must be (N, 3)")
    if origins.ndim != 2 or origins.shape[1] != 3:
        raise ValueError("origins must be (N, 3)")
    if grid_idx.ndim != 1 or near.ndim != 1 or far.ndim != 1:
        raise ValueError("grid_idx, near and far must be 1-D")
    if grid_idx.dtype.is_floating_point or grid_idx.dtype == torch.bool:
        raise ValueError("grid_idx must be an integer tensor")
    for vn, v in zip(
        ["origins", "near", "far", "grid_idx"], [origins, near, far, grid_idx]
    ):
        if v.shape[0] != n_rays:
            raise ValueError(
                f"Unexpected number of elements in {vn} "
                f"({v.shape[0]}, expected {n_rays})"
            )
    if encoding is not None and (
        encoding.ndim != 2 or encoding.shape[0] != n_rays
    ):
        raise ValueError("encoding must be (N, C)")


def default_tile(height: int, width: int):
    """Pixel-tile shape for :func:`tile_ray_order` (the JAX package's
    choice, kept so that tile-ordered noise streams agree)."""
    m = min(height, width)
    if m >= 256:
        return (8, 32)
    if m >= 96:
        return (8, 16)
    return (8, 8)


def tile_ray_order(height: int, width: int, tile=None):
    """Permutation putting the rays of a raster-order image in tile-major
    order.  Returns ``(order, inverse)`` numpy index arrays; the identity
    when the tile does not divide the image."""
    th, tw = tile if tile is not None else default_tile(height, width)
    n = height * width
    if height % th or width % tw:
        idx = np.arange(n)
        return idx, idx
    idx = np.arange(n).reshape(height, width)
    order = (
        idx.reshape(height // th, th, width // tw, tw)
        .transpose(0, 2, 1, 3)
        .reshape(-1)
    )
    return order, np.argsort(order)
