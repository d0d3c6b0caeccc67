"""Grid-list regularizers, up-sampling and initialization (counterpart of
``lightplane_tpu/utils/grid_utils.py``): the fitting workflow's TV and L1
losses and its coarse-to-fine up-sampling, on ``[B, D, H, W, C]``
grid-lists."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F


def init_3d_representation(
    generator: Optional[torch.Generator],
    representation: str,
    resolution: int,
    channels: int,
    batch_size: int = 1,
    init_scale: float = 0.1,
    device="cuda",
) -> List[torch.Tensor]:
    """A randomly initialized grid-list, ``"voxel_grid"`` or ``"triplane"``,
    drawn on the CPU from ``generator`` and moved to ``device`` (the GPU
    unless the caller asks for ``"cpu"``)."""
    r = resolution
    if representation == "voxel_grid":
        shapes = [(batch_size, r, r, r, channels)]
    elif representation == "triplane":
        shapes = [
            (batch_size, 1, r, r, channels),
            (batch_size, r, 1, r, channels),
            (batch_size, r, r, 1, channels),
        ]
    else:
        raise ValueError(f"unknown representation {representation!r}")
    return [
        (torch.randn(s, generator=generator) * init_scale).to(device)
        for s in shapes
    ]


def _tv_one(g: torch.Tensor) -> torch.Tensor:
    """Mean squared forward difference over the non-singleton spatial
    dims."""
    terms = [torch.mean(torch.diff(g, dim=axis) ** 2)
             for axis in (1, 2, 3) if g.shape[axis] > 1]
    return sum(terms) / max(len(terms), 1)


def grid_tv_loss(grid: Sequence[torch.Tensor]) -> torch.Tensor:
    """Total-variation regularizer over a grid-list."""
    return sum(_tv_one(g) for g in grid) / len(grid)


def grid_l1_loss(grid: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean absolute value of the grid features."""
    return sum(torch.mean(torch.abs(g)) for g in grid) / len(grid)


_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def grid_up_sample(
    grid: Sequence[torch.Tensor], factor: int = 2
) -> List[torch.Tensor]:
    """Linear up-sampling of each grid by ``factor`` along its non-singleton
    spatial dims, with half-pixel centres (``align_corners=False``, as
    ``jax.image.resize(..., "linear")`` samples)."""
    out = []
    for g in grid:
        B, D, H, W, C = g.shape
        axes = [a for a, n in zip((1, 2, 3), (D, H, W)) if n > 1]
        if not axes:
            out.append(g.clone())
            continue
        # [B, D, H, W, C] -> [B, C, *non-singleton dims]
        x = g.permute(0, 4, 1, 2, 3).reshape(
            (B, C) + tuple(g.shape[a] for a in axes))
        x = F.interpolate(x, scale_factor=factor, mode=_MODES[len(axes)],
                          align_corners=False)
        new = [B, D, H, W, C]
        for a in axes:
            new[a] *= factor
        out.append(x.reshape(B, C, *new[1:4]).permute(0, 2, 3, 4, 1)
                   .contiguous())
    return out


# aliases mirroring the reference naming
grid_TV_loss = grid_tv_loss
grid_L1_loss = grid_l1_loss
