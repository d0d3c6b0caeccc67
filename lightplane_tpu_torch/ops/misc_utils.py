"""Grid-list utilities: flatten/unflatten, shape checks.

A "grid-list" is a list of 5-D channels-last feature grids
``[B, D_i, H_i, W_i, C]``.  The fused renderer consumes one flattened 2-D
tensor ``[sum_i B*D_i*H_i*W_i, C]`` plus the per-grid shapes as Python
tuples.  Counterpart of ``lightplane_tpu/ops/misc_utils.py``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

GridList = Sequence[torch.Tensor]
GridSizes = Tuple[Tuple[int, int, int, int, int], ...]


def assert_shape(x, shape):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"expected shape {tuple(shape)}, got {tuple(x.shape)}"
        )


def flatten_grid(grid: GridList) -> Tuple[torch.Tensor, GridSizes]:
    """Flatten a grid-list into one 2-D ``[V_total, C]`` tensor + sizes."""
    grid_sizes = tuple(tuple(int(s) for s in g.shape) for g in grid)
    grid_flat = torch.cat([g.reshape(-1, g.shape[-1]) for g in grid], dim=0)
    return grid_flat, grid_sizes


def unflatten_grid(
    grid: torch.Tensor, grid_sizes: GridSizes
) -> Tuple[torch.Tensor, ...]:
    """Inverse of :func:`flatten_grid`."""
    rows = [int(np.prod(gs[:-1])) for gs in grid_sizes]
    parts = torch.split(grid, rows, dim=0)
    return tuple(p.reshape(*gs) for p, gs in zip(parts, grid_sizes))


def if_not_none_else(x: Any, y: Any) -> Any:
    """Return ``x`` if it is not None, else ``y``."""
    return x if x is not None else y


def pad_feature_to_block_size(feature: torch.Tensor, block_size: int):
    """Zero-pad the leading (ray) dim of a feature tensor to a multiple of
    ``block_size``."""
    n_pad = -feature.shape[0] % block_size
    if n_pad > 0:
        feature = torch.cat(
            [feature, feature.new_zeros((n_pad,) + tuple(feature.shape[1:]))])
    return feature


def is_in_bounds(points: torch.Tensor) -> torch.Tensor:
    """True where a point lies inside the [-1, 1] cube (all dims)."""
    return torch.all(points.abs() <= 1.0, dim=-1, keepdim=True)


def _normalize_grid_sizes(grid_sizes) -> GridSizes:
    return tuple(tuple(int(s) for s in gs) for gs in grid_sizes)


def _check_list_grid_sizes(grid: GridList, grid_sizes):
    for g, gs in zip(grid, grid_sizes):
        assert_shape(g, gs)


def check_grid(
    grid: Union[GridList, torch.Tensor],
    grid_sizes: Optional[Sequence[Sequence[int]]] = None,
):
    """Validate a grid-list, or a flat 2-D grid with its sizes."""
    if isinstance(grid, (list, tuple)):
        if grid_sizes is not None:
            _check_list_grid_sizes(grid, grid_sizes)
    elif isinstance(grid, torch.Tensor):
        if grid_sizes is None:
            raise ValueError(
                "grid_sizes cannot be None when grid is a flat tensor"
            )
        total = sum(int(np.prod(gs)) for gs in grid_sizes)
        if total != grid.numel():
            raise ValueError(
                "grid_sizes has to be compatible with the grid tensor shape!"
            )
    else:
        raise NotImplementedError("grid should be either a tensor or a list")
    return grid, grid_sizes


def check_grid_and_color_grid(
    grid,
    color_grid,
    grid_sizes=None,
    color_grid_sizes=None,
):
    """Joint validation of ``grid`` and the optional ``color_grid``."""
    is_listlike = isinstance(grid, (list, tuple))
    if color_grid is not None and (
        isinstance(color_grid, (list, tuple)) != is_listlike
    ):
        raise ValueError("grid and color_grid should have the same type")
    if is_listlike:
        if color_grid is not None:
            if any(cg.shape[0] != g.shape[0]
                   for cg, g in zip(color_grid, grid)):
                raise ValueError("color_grid's batch size should match grid's")
            if any(cg.shape[-1] != g.shape[-1]
                   for cg, g in zip(color_grid, grid)):
                raise ValueError(
                    "color_grid's feature dimension should match grid's"
                )
            if color_grid_sizes is not None:
                _check_list_grid_sizes(color_grid, color_grid_sizes)
        if grid_sizes is not None:
            _check_list_grid_sizes(grid, grid_sizes)
    else:
        check_grid(grid, grid_sizes)
        if color_grid is not None:
            if color_grid_sizes is None:
                raise ValueError(
                    "color_grid_sizes cannot be None when color_grid is a"
                    " tensor"
                )
            total = sum(int(np.prod(gs)) for gs in color_grid_sizes)
            if total != color_grid.numel():
                raise ValueError(
                    "color_grid_sizes has to be compatible with color_grid"
                )
    return grid, color_grid, grid_sizes, color_grid_sizes


def process_and_flatten_grid(
    grid,
    color_grid,
    grid_sizes=None,
    color_grid_sizes=None,
):
    """Flatten grid-lists to 2-D tensors + sizes; flat inputs pass through
    with normalized sizes."""
    if isinstance(grid, (list, tuple)):
        grid, grid_sizes = flatten_grid(grid)
        if color_grid is not None:
            color_grid, color_grid_sizes = flatten_grid(color_grid)
        else:
            color_grid, color_grid_sizes = None, None
    elif isinstance(grid, torch.Tensor):
        grid_sizes = _normalize_grid_sizes(grid_sizes)
        if color_grid is not None:
            color_grid_sizes = _normalize_grid_sizes(color_grid_sizes)
    else:
        raise NotImplementedError("grid should be either a tensor or a list")
    return grid, color_grid, grid_sizes, color_grid_sizes
