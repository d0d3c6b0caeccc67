"""Trilinear/bilinear sampling of flattened grid-lists (counterpart of
``lightplane_tpu/ops/grid_sample.py``).

One sampler handles voxel grids and planes: a singleton spatial axis maps
its coordinate to index 0, so a ``[B, 1, H, W, C]`` plane is sampled
bilinearly in (x, y).  A point ``p = (x, y, z)`` in ``[-1, 1]^3`` indexes
``x -> W, y -> H, z -> D`` with the ``align_corners=False`` mapping
``i = ((p + 1) / 2) * S - 0.5``.  Out-of-bounds corners get weight 0 and
clamped indices (zeros padding); the sub-grids' samples are summed.

Sampling is a gather of the corner rows, so everything here is
differentiable by ordinary autograd.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .misc_utils import GridSizes, flatten_grid, is_in_bounds


def grid_row_offsets(grid_sizes: GridSizes):
    """Row offset of each sub-grid inside the flattened ``[V_total, C]``."""
    offs = [0]
    for gs in grid_sizes:
        offs.append(offs[-1] + int(np.prod(gs[:-1])))
    return tuple(offs)


def _corner_rows_and_weights(size, points, batch_idx, mode: str):
    """Flat row indices and interpolation weights of the sampling corners of
    one sub-grid, each ``[..., K]`` (K = 8 linear, 1 nearest)."""
    _, D, H, W, _ = size
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    zero = torch.zeros_like(x)
    fx = ((x + 1.0) * 0.5) * W - 0.5 if W > 1 else zero
    fy = ((y + 1.0) * 0.5) * H - 0.5 if H > 1 else zero
    fz = ((z + 1.0) * 0.5) * D - 0.5 if D > 1 else zero

    if mode == "nearest":
        corners = [
            (torch.round(fx), torch.round(fy), torch.round(fz),
             torch.ones_like(fx))
        ]
    elif mode in ("linear", "bilinear"):
        x0, y0, z0 = torch.floor(fx), torch.floor(fy), torch.floor(fz)
        tx, ty, tz = fx - x0, fy - y0, fz - z0
        corners = []
        for dz in (0.0, 1.0):
            wz = tz if dz else (1.0 - tz)
            for dy in (0.0, 1.0):
                wy = ty if dy else (1.0 - ty)
                for dx in (0.0, 1.0):
                    wx = tx if dx else (1.0 - tx)
                    corners.append((x0 + dx, y0 + dy, z0 + dz, wx * wy * wz))
    else:
        raise ValueError(f"unknown sampling mode {mode!r}")

    rows, weights = [], []
    for cx, cy, cz, w in corners:
        valid = (
            (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H) & (cz >= 0) & (cz < D)
        )
        cxi = torch.clamp(cx, 0, W - 1).to(torch.int64)
        cyi = torch.clamp(cy, 0, H - 1).to(torch.int64)
        czi = torch.clamp(cz, 0, D - 1).to(torch.int64)
        rows.append(((batch_idx * D + czi) * H + cyi) * W + cxi)
        weights.append(torch.where(valid, w, torch.zeros_like(w)))
    return torch.stack(rows, dim=-1), torch.stack(weights, dim=-1)


def sample_grid_rep(
    grid_flat: torch.Tensor,
    grid_sizes: GridSizes,
    points: torch.Tensor,
    grid_idx: torch.Tensor,
    mask_out_of_bounds_samples: bool = False,
    mode: str = "linear",
) -> torch.Tensor:
    """Sample the summed grid-list at ``points``.

    Args:
        grid_flat: flattened grid-list ``[V_total, C]``.
        grid_sizes: per-grid shapes ``((B, D, H, W, C), ...)``.
        points: ``[R, ..., 3]`` in ``[-1, 1]``.
        grid_idx: ``[R]`` integer batch index per leading row of ``points``.
        mask_out_of_bounds_samples: zero the samples of points outside the
            [-1, 1] cube.
        mode: "linear" (tri/bi-linear) or "nearest".

    Returns:
        ``[R, ..., C]``: the sum of the samples of every sub-grid.
    """
    offsets = grid_row_offsets(grid_sizes)
    bshape = points.shape[:-1]
    bidx = grid_idx.to(torch.int64).reshape(
        (grid_idx.shape[0],) + (1,) * (len(bshape) - 1)
    ).expand(bshape)

    out = None
    for gs, off in zip(grid_sizes, offsets[:-1]):
        rows, weights = _corner_rows_and_weights(gs, points, bidx, mode)
        vals = grid_flat[(rows + off).reshape(-1)].reshape(
            rows.shape + (grid_flat.shape[-1],)
        )                                                    # [..., K, C]
        sampled = torch.einsum("...k,...kc->...c", weights, vals)
        out = sampled if out is None else out + sampled

    if mask_out_of_bounds_samples:
        out = out * is_in_bounds(points).to(out.dtype)
    return out


def sample_grid_list(
    grid: Sequence[torch.Tensor],
    points: torch.Tensor,
    grid_idx: torch.Tensor,
    mask_out_of_bounds_samples: bool,
    mode: str = "linear",
) -> torch.Tensor:
    """Sample a grid-list of ``[B, D, H, W, C]`` tensors."""
    grid_flat, grid_sizes = flatten_grid(list(grid))
    return sample_grid_rep(
        grid_flat, grid_sizes, points, grid_idx, mask_out_of_bounds_samples,
        mode,
    )
