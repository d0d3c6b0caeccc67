"""Materializing PyTorch renderer: the numerics oracle of the port
(counterpart of ``lightplane_tpu/ops/naive_renderer.py``).

Every ``[num_rays, num_samples, ...]`` intermediate is materialized and
gradients come from autograd.  ``checkpointing=True`` wraps the per-point
decoder in ``torch.utils.checkpoint``.

Emission-Absorption model:

    sigma_i = gain * softplus(opacity_mlp(...) + noise)
    nlt_i   = sum_{j<=i} sigma_j * delta_j          (negative log transmittance)
    T_i     = exp(-nlt_i),   w_i = T_{i-1} - T_i
    depth   = sum_i w_i * t_i,   feature = sum_i w_i * c_i
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .grid_sample import sample_grid_rep
from .misc_utils import check_grid_and_color_grid, process_and_flatten_grid
from .mlp_utils import DecoderParams, flattened_decoder_params_to_list
from .rand import get_sample_randn
from .rays import Rays


def _contract_pi(x: torch.Tensor) -> torch.Tensor:
    """MeRF coordinate contraction mapping R^3 into the [-1, 1] cube."""
    n = torch.amax(x.abs(), dim=-1, keepdim=True)
    x_abs = x.abs()
    one = torch.ones_like(x)
    safe_abs = torch.where(x_abs > 0, x_abs, one)
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    x_contract = torch.where(
        n <= 1.0,
        x,
        torch.where(
            (x_abs - n).abs() <= 1e-7,
            (2.0 - 1.0 / safe_abs) * (x / safe_abs),
            x / safe_n,
        ),
    )
    return x_contract / 2.0


def _depth_inv_sphere(far, disparity_at_inf, n, step):
    """Disparity-spaced background depth: ``far / (disp*f + (1-f))`` with
    ``f = (step + 1) / n``, written to avoid the cancellation near f=1."""
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(float(step), dtype=torch.float32)
    frac_step = (step.to(torch.float32) + 1.0) / n
    n_disp = disparity_at_inf * frac_step + (1.0 - frac_step)
    return far * (1.0 / n_disp)


def _depth_lin(near, far, n, step):
    """Linear depth schedule."""
    return near + (far - near) * (step / (n - 1)) if n > 1 else near


def _eval_mlp(vec, weights, biases):
    """Right-multiplying MLP with relu between layers, none at the end."""
    n_l = len(weights)
    for l in range(n_l):
        vec = vec @ weights[l] + biases[l]
        if l < n_l - 1:
            vec = F.relu(vec)
    return vec


def lightplane_eval_mlp(
    points: torch.Tensor,  # [R, N, 3]
    grid_flat: torch.Tensor,
    grid_sizes,
    ray_grid_idx: torch.Tensor,
    decoder_params: DecoderParams,
    rays_encoding: torch.Tensor,
    gain: float,
    mask_out_of_bounds_samples: bool = False,
    inject_opacity_noise: Optional[torch.Tensor] = None,
    scaffold: Optional[torch.Tensor] = None,
    color_grid_flat: Optional[torch.Tensor] = None,
    color_grid_sizes=None,
    checkpointing: bool = False,
    contract_coords: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the decoder (grid sample + trunk/opacity/color MLPs) at
    ``points``; returns ``(opacity [R, N], color [R, N, C])``.

    Two decoder topologies:
      * single grid: grid -> trunk -> (opacity head, +ray_enc -> color head)
      * separate color grid ("relu-field"): relu(grid) -> opacity head,
        relu(color_grid) + ray_enc -> color head; no trunk.
    """
    if contract_coords:
        points = _contract_pi(points)

    def _decoder(points, grid_flat, color_grid_flat, rays_encoding,
                 inject_opacity_noise, mlp_params):
        (w_t, b_t, w_o, b_o, w_c, b_c) = flattened_decoder_params_to_list(
            mlp_params,
            decoder_params.n_hidden_trunk,
            decoder_params.n_hidden_opacity,
            decoder_params.n_hidden_color,
        )
        feature_sampled = sample_grid_rep(
            grid_flat, grid_sizes, points, ray_grid_idx,
            mask_out_of_bounds_samples,
        )
        if color_grid_flat is None:
            feature_trunk = F.relu(_eval_mlp(feature_sampled, w_t, b_t))
            opacity_raw = _eval_mlp(feature_trunk, w_o, b_o)
            log_color = _eval_mlp(
                feature_trunk + rays_encoding[:, None], w_c, b_c
            )
        else:
            if len(w_t):
                raise ValueError("a separate color grid takes no trunk MLP")
            feature_sampled = F.relu(feature_sampled)
            color_sampled = F.relu(
                sample_grid_rep(
                    color_grid_flat, color_grid_sizes, points, ray_grid_idx,
                    mask_out_of_bounds_samples,
                )
            )
            opacity_raw = _eval_mlp(feature_sampled, w_o, b_o)
            log_color = _eval_mlp(
                color_sampled + rays_encoding[:, None], w_c, b_c
            )
        opacity_raw = opacity_raw[..., 0]
        if inject_opacity_noise is not None:
            opacity_raw = opacity_raw + inject_opacity_noise
        return gain * F.softplus(opacity_raw), torch.sigmoid(log_color)

    args = (points, grid_flat, color_grid_flat, rays_encoding,
            inject_opacity_noise, decoder_params.mlp_params)
    if checkpointing:
        opacity, color = checkpoint(_decoder, *args, use_reentrant=False)
    else:
        opacity, color = _decoder(*args)

    if scaffold is not None:
        scaffold_value = sample_grid_rep(
            scaffold.reshape(-1, 1),
            (tuple(scaffold.shape) + (1,),),
            points,
            ray_grid_idx,
            True,
            mode="nearest",
        )
        opacity = opacity * scaffold_value[..., 0]
        color = color * scaffold_value
    return opacity, color


def lightplane_eval_mlp_opacity_only(
    points: torch.Tensor,
    grid_flat: torch.Tensor,
    grid_sizes,
    ray_grid_idx: torch.Tensor,
    decoder_params: DecoderParams,
    gain: float,
    mask_out_of_bounds_samples: bool = False,
    inject_opacity_noise: Optional[torch.Tensor] = None,
    scaffold: Optional[torch.Tensor] = None,
    checkpointing: bool = False,
    contract_coords: bool = False,
) -> torch.Tensor:
    """Opacity-only decoder evaluation ``[R, N]``; ``checkpointing`` as in
    :func:`lightplane_eval_mlp`."""
    if contract_coords:
        points = _contract_pi(points)

    def _decoder(points, grid_flat, inject_opacity_noise, mlp_params):
        (w_t, b_t, w_o, b_o, _wc, _bc) = flattened_decoder_params_to_list(
            mlp_params,
            decoder_params.n_hidden_trunk,
            decoder_params.n_hidden_opacity,
            decoder_params.n_hidden_color,
        )
        feature_sampled = sample_grid_rep(
            grid_flat, grid_sizes, points, ray_grid_idx,
            mask_out_of_bounds_samples,
        )
        feature_trunk = F.relu(_eval_mlp(feature_sampled, w_t, b_t))
        opacity_raw = _eval_mlp(feature_trunk, w_o, b_o)[..., 0]
        if inject_opacity_noise is not None:
            opacity_raw = opacity_raw + inject_opacity_noise
        return gain * F.softplus(opacity_raw)

    args = (points, grid_flat, inject_opacity_noise, decoder_params.mlp_params)
    if checkpointing:
        opacity = checkpoint(_decoder, *args, use_reentrant=False)
    else:
        opacity = _decoder(*args)
    if scaffold is not None:
        scaffold_value = sample_grid_rep(
            scaffold.reshape(-1, 1),
            (tuple(scaffold.shape) + (1,),),
            points,
            ray_grid_idx,
            True,
            mode="nearest",
        )
        opacity = opacity * scaffold_value[..., 0]
    return opacity


def _ray_depths_and_deltas(
    rays: Rays, num_samples: int, num_samples_inf: int, disparity_at_inf: float
):
    """Per-ray sample depths and step sizes: ``num_samples`` equispaced in
    [near, far], then ``num_samples_inf`` disparity-spaced beyond far."""
    lsp = torch.linspace(0.0, 1.0, num_samples, device=rays.near.device)
    depths = rays.near[:, None] + lsp[None, :] * (rays.far - rays.near)[:, None]
    if num_samples_inf > 0:
        sph = torch.stack(
            [
                _depth_inv_sphere(
                    rays.far, disparity_at_inf, num_samples_inf, step
                )
                for step in range(num_samples_inf)
            ],
            dim=-1,
        )
        depths = torch.cat([depths, sph], dim=-1)
    delta_one = (
        (rays.far - rays.near) / (num_samples - 1)
        if num_samples > 1
        else torch.ones_like(rays.near)
    )
    delta = torch.cat([delta_one[:, None], torch.diff(depths, dim=-1)], dim=-1)
    return depths, delta


def lightplane_renderer_naive(
    rays: Rays,
    grid: Union[Sequence[torch.Tensor], torch.Tensor],
    decoder_params: DecoderParams,
    num_samples: int,
    gain: float,
    mask_out_of_bounds_samples: bool = False,
    num_samples_inf: int = 0,
    contract_coords: bool = False,
    inject_noise_sigma: float = 0.0,
    inject_noise_seed: Optional[int] = None,
    disparity_at_inf: float = 1e-5,
    scaffold: Optional[torch.Tensor] = None,
    color_grid: Union[Sequence[torch.Tensor], torch.Tensor, None] = None,
    grid_sizes=None,
    color_grid_sizes=None,
    checkpointing: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Naive (materializing) renderer with the fused path's numerics;
    O(num_samples) memory.  Returns ``(expected depth, negative log
    transmittance, rendered features)`` per ray."""
    check_grid_and_color_grid(grid, color_grid, grid_sizes, color_grid_sizes)
    grid_flat, color_grid_flat, grid_sizes, color_grid_sizes = (
        process_and_flatten_grid(grid, color_grid, grid_sizes, color_grid_sizes)
    )
    num_rays = rays.directions.shape[0]
    tot_num_samples = num_samples + num_samples_inf

    inject_opacity_noise = None
    if inject_noise_sigma > 0.0:
        if inject_noise_seed is None:
            raise ValueError(
                "inject_noise_seed must be given when inject_noise_sigma > 0"
            )
        inject_opacity_noise = get_sample_randn(
            tot_num_samples, num_rays, inject_noise_seed,
            device=rays.directions.device,
        ) * inject_noise_sigma

    depths, delta = _ray_depths_and_deltas(
        rays, num_samples, num_samples_inf, disparity_at_inf
    )
    points = depths[..., None] * rays.directions[:, None]
    points = points + rays.origins[..., None, :]

    rays_encoding = rays.encoding
    if rays_encoding is None:
        rays_encoding = torch.zeros(
            (num_rays, decoder_params.n_hidden_color[0]),
            dtype=grid_flat.dtype, device=grid_flat.device,
        )

    opacity, color = lightplane_eval_mlp(
        points,
        grid_flat,
        grid_sizes,
        rays.grid_idx,
        decoder_params,
        rays_encoding,
        gain,
        mask_out_of_bounds_samples=mask_out_of_bounds_samples,
        inject_opacity_noise=inject_opacity_noise,
        scaffold=scaffold,
        color_grid_flat=color_grid_flat,
        color_grid_sizes=color_grid_sizes,
        checkpointing=checkpointing,
        contract_coords=contract_coords,
    )

    delta_opacity = F.pad(opacity * delta, (1, 0))
    negative_log_transmittances = torch.cumsum(delta_opacity, dim=-1)
    transmittance = torch.exp(-negative_log_transmittances)
    rweights = -torch.diff(transmittance, dim=-1)

    ray_length_render = torch.sum(depths * rweights, dim=-1)
    feature_render = torch.sum(color * rweights[..., None], dim=-2)
    negative_log_transmittance = negative_log_transmittances[..., -1]
    if decoder_params.color_chn < feature_render.shape[-1]:
        feature_render = feature_render[..., : decoder_params.color_chn]
    return ray_length_render, negative_log_transmittance, feature_render
