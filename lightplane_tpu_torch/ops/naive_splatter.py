"""Materializing PyTorch splatter: the numerics oracle of the 2D -> 3D
operator (counterpart of ``lightplane_tpu/ops/naive_splatter.py``).

Marches the renderer's ray samples and pushes per-ray features into a
zero-initialized grid-list, normalized by a splatted weight (collision)
grid.  With an MLP and an ``input_grid``, each sample first gathers a prior
feature, adds the ray's encoding and maps the sum through the MLP before
splatting.  Every ``[num_rays, num_samples, ...]`` intermediate is
materialized and gradients come from autograd; ``checkpointing=True`` wraps
the per-sample MLP in ``torch.utils.checkpoint``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .grid_sample import sample_grid_rep, splat_grid_rep
from .misc_utils import (
    check_grid_and_color_grid,
    process_and_flatten_grid,
    unflatten_grid,
)
from .mlp_utils import SplatterParams, _flattened_one_mlp_params_to_list
from .naive_renderer import _contract_pi, _eval_mlp, _ray_depths_and_deltas
from .rays import Rays

# clamp of the normalization's denominator
WEIGHT_GRID_EPS = 1e-5


def _normalize_output_grid_size(output_grid_size):
    return tuple(tuple(int(s) for s in gs) for gs in output_grid_size)


def lightplane_splatter_naive(
    rays: Rays,
    output_grid_size,
    num_samples: int,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    return_list: bool = True,
    checkpointing: bool = False,
):
    """Splat ``rays.encoding`` along each ray into a zero grid-list of
    ``output_grid_size`` and normalize by the splatted weights."""
    return _lightplane_splatter_naive_impl(
        rays, output_grid_size, None, None, None, num_samples,
        num_samples_inf, mask_out_of_bounds_samples, contract_coords,
        disparity_at_inf, return_list, checkpointing,
    )


def lightplane_mlp_splatter_naive(
    rays: Rays,
    output_grid_size,
    mlp_params: SplatterParams,
    input_grid: Union[Sequence[torch.Tensor], torch.Tensor],
    num_samples: int,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    input_grid_sizes=None,
    return_list: bool = True,
    checkpointing: bool = False,
):
    """Splatter with a prior ``input_grid`` and an MLP applied to the fused
    (sampled + encoding) feature of each sample."""
    check_grid_and_color_grid(input_grid, None, input_grid_sizes, None)
    input_grid_flat, _, input_grid_sizes, _ = process_and_flatten_grid(
        input_grid, None, input_grid_sizes, None
    )
    return _lightplane_splatter_naive_impl(
        rays, output_grid_size, mlp_params, input_grid_flat,
        input_grid_sizes, num_samples, num_samples_inf,
        mask_out_of_bounds_samples, contract_coords, disparity_at_inf,
        return_list, checkpointing,
    )


def _lightplane_splatter_naive_impl(
    rays: Rays,
    output_grid_size,
    mlp_params: Optional[SplatterParams],
    input_grid_flat: Optional[torch.Tensor],
    input_grid_sizes,
    num_samples: int,
    num_samples_inf: int,
    mask_out_of_bounds_samples: bool,
    contract_coords: bool,
    disparity_at_inf: float,
    return_list: bool,
    checkpointing: bool,
):
    output_grid_size = _normalize_output_grid_size(output_grid_size)
    tot_num_samples = num_samples + num_samples_inf
    depths, _ = _ray_depths_and_deltas(
        rays, num_samples, num_samples_inf, disparity_at_inf
    )
    samples = depths[..., None] * rays.directions[:, None]
    samples = samples + rays.origins[..., None, :]
    if contract_coords:
        samples = _contract_pi(samples)

    enc = rays.encoding
    splatting_feature = enc[:, None, :].expand(
        enc.shape[0], tot_num_samples, enc.shape[-1]
    )
    if mlp_params is not None:
        weights, biases = _flattened_one_mlp_params_to_list(
            mlp_params.mlp_params, mlp_params.n_hidden
        )
        n_w = len(weights)

        def _fused(samples, splatting_feature, input_grid_flat, *wb):
            sampled = sample_grid_rep(
                input_grid_flat, input_grid_sizes, samples, rays.grid_idx,
                mask_out_of_bounds_samples,
            )
            return _eval_mlp(sampled + splatting_feature, wb[:n_w], wb[n_w:])

        args = (samples, splatting_feature, input_grid_flat, *weights,
                *biases)
        if checkpointing:
            feature_sampled = checkpoint(_fused, *args, use_reentrant=False)
        else:
            feature_sampled = _fused(*args)
    else:
        feature_sampled = splatting_feature

    v_total = sum(int(np.prod(gs[:-1])) for gs in output_grid_size)
    feature_grid = splat_grid_rep(
        feature_sampled, v_total, output_grid_size, samples, rays.grid_idx,
        mask_out_of_bounds_samples,
    )
    weight_grid = splat_grid_rep(
        torch.ones_like(feature_sampled[..., :1]), v_total,
        tuple(gs[:-1] + (1,) for gs in output_grid_size), samples,
        rays.grid_idx, mask_out_of_bounds_samples,
    )
    grid_flat = feature_grid / torch.clamp(weight_grid, min=WEIGHT_GRID_EPS)
    if return_list:
        return list(unflatten_grid(grid_flat, output_grid_size))
    return grid_flat
