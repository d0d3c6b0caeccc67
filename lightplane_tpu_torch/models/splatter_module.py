"""``LightplaneSplatter`` and ``LightplaneMLPSplatter`` (counterpart of
``lightplane_tpu/models/splatter_module.py``).

``LightplaneSplatter`` has no parameters: it splats ``rays.encoding``
straight into a zero-initialized output grid-list.  ``LightplaneMLPSplatter``
owns the splatter MLP's flat ``mlp_params`` and splats ``MLP(input_grid[x] +
rays.encoding)``.  Both add near/far jitter (drawn from an explicit
``torch.Generator``) and the naive/fused switch around the functional
splatter.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.misc_utils import if_not_none_else
from ..ops.mlp_utils import SplatterParams, init_splatter_params
from ..ops.naive_splatter import (
    lightplane_mlp_splatter_naive,
    lightplane_splatter_naive,
)
from ..ops.rays import Rays, jitter_near_far
from ..ops.splatter import lightplane_mlp_splatter, lightplane_splatter


def _check_splatter_ray_encoding_input(ray_encoding, ray_encoding_dim):
    if ray_encoding is None:
        raise ValueError(
            "The encoding field of input rays is None."
            " However, the Splatter requires an encoding for input rays."
        )
    if ray_encoding.shape[1] != ray_encoding_dim:
        raise ValueError(
            f"Ray encoding has a wrong dimension."
            f" Expected: {ray_encoding_dim}, got: {ray_encoding.shape[1]}"
        )


class _SplatterBase(nn.Module):
    """The configuration both splatter modules share, and the per-call
    overrides and jitter."""

    def __init__(self, num_samples, grid_chn, num_samples_inf,
                 mask_out_of_bounds_samples, contract_coords,
                 disparity_at_inf, rays_jitter_near_far, use_naive_impl):
        super().__init__()
        self.num_samples = num_samples
        self.grid_chn = grid_chn
        self.num_samples_inf = num_samples_inf
        self.mask_out_of_bounds_samples = mask_out_of_bounds_samples
        self.contract_coords = contract_coords
        self.disparity_at_inf = disparity_at_inf
        self.rays_jitter_near_far = rays_jitter_near_far
        self.use_naive_impl = use_naive_impl

    def _call_kwargs(self, rays: Rays, encoding_dim, num_samples,
                     num_samples_inf, mask_out_of_bounds_samples,
                     contract_coords, disparity_at_inf, rays_jitter_near_far,
                     generator):
        """The rays (jittered when asked) and the splatter's keyword
        arguments, with every None taking the module's default."""
        num_samples = if_not_none_else(num_samples, self.num_samples)
        _check_splatter_ray_encoding_input(rays.encoding, encoding_dim)
        if if_not_none_else(rays_jitter_near_far, self.rays_jitter_near_far):
            near, far = jitter_near_far(rays.near, rays.far, num_samples,
                                        generator)
            rays = Rays(rays.directions, rays.origins, rays.grid_idx, near,
                        far, rays.encoding)
        return rays, dict(
            num_samples=num_samples,
            num_samples_inf=if_not_none_else(num_samples_inf,
                                             self.num_samples_inf),
            mask_out_of_bounds_samples=if_not_none_else(
                mask_out_of_bounds_samples, self.mask_out_of_bounds_samples),
            contract_coords=if_not_none_else(contract_coords,
                                             self.contract_coords),
            disparity_at_inf=if_not_none_else(disparity_at_inf,
                                              self.disparity_at_inf),
        )


class LightplaneSplatter(_SplatterBase):
    """Parameter-free splatter module: splats ``rays.encoding`` (``grid_chn``
    channels) into a zero-initialized grid-list of ``grid_size``.
    ``use_naive_impl`` switches to the materializing oracle."""

    def __init__(
        self,
        num_samples: int,
        grid_chn: int,
        num_samples_inf: int = 0,
        mask_out_of_bounds_samples: bool = False,
        contract_coords: bool = False,
        disparity_at_inf: float = 1e-5,
        rays_jitter_near_far: bool = False,
        use_naive_impl: bool = False,
    ):
        super().__init__(num_samples, grid_chn, num_samples_inf,
                         mask_out_of_bounds_samples, contract_coords,
                         disparity_at_inf, rays_jitter_near_far,
                         use_naive_impl)

    def get_splatter_params(self) -> Optional[SplatterParams]:
        return None

    def forward(
        self,
        rays: Rays,
        grid_size,
        num_samples: Optional[int] = None,
        num_samples_inf: Optional[int] = None,
        mask_out_of_bounds_samples: Optional[bool] = None,
        contract_coords: Optional[bool] = None,
        disparity_at_inf: Optional[float] = None,
        rays_jitter_near_far: Optional[bool] = None,
        return_list: bool = True,
        generator: Optional[torch.Generator] = None,
        impl: str = "auto",
    ):
        """Splat; arguments set to None take the module's defaults.
        ``generator`` drives the near/far jitter; ``impl`` is passed to
        :func:`lightplane_splatter`."""
        rays, kw = self._call_kwargs(
            rays, self.grid_chn, num_samples, num_samples_inf,
            mask_out_of_bounds_samples, contract_coords, disparity_at_inf,
            rays_jitter_near_far, generator,
        )
        if self.use_naive_impl:
            return lightplane_splatter_naive(rays, grid_size,
                                             return_list=return_list, **kw)
        return lightplane_splatter(rays, grid_size, return_list=return_list,
                                   impl=impl, **kw)


class LightplaneMLPSplatter(_SplatterBase):
    """Splatter with a learnable MLP and a prior ``input_grid``: each sample
    splats ``MLP(input_grid[x] + rays.encoding)``.  The MLP maps
    ``input_grid_chn`` channels through ``mlp_n_layers`` layers of
    ``mlp_hidden_chn`` to ``grid_chn``; its flat ``mlp_params`` is an
    ``nn.Parameter`` initialized from ``generator`` on ``device`` (the GPU
    unless the caller asks for ``"cpu"``)."""

    def __init__(
        self,
        num_samples: int,
        grid_chn: int,
        input_grid_chn: int = 32,
        mlp_hidden_chn: int = 32,
        mlp_n_layers: int = 2,
        num_samples_inf: int = 0,
        mask_out_of_bounds_samples: bool = False,
        contract_coords: bool = False,
        disparity_at_inf: float = 1e-5,
        rays_jitter_near_far: bool = False,
        use_naive_impl: bool = False,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__(num_samples, grid_chn, num_samples_inf,
                         mask_out_of_bounds_samples, contract_coords,
                         disparity_at_inf, rays_jitter_near_far,
                         use_naive_impl)
        sp = init_splatter_params(
            generator, n_layers=mlp_n_layers, input_chn=input_grid_chn,
            hidden_chn=mlp_hidden_chn, out_chn=grid_chn, device=device,
        )
        self._n_hidden = sp.n_hidden
        self.mlp_params = nn.Parameter(sp.mlp_params)
        self.rays_encoding_dim = input_grid_chn

    def get_splatter_params(self) -> SplatterParams:
        return SplatterParams(self.mlp_params, self._n_hidden)

    def forward(
        self,
        rays: Rays,
        grid_size,
        input_grid,
        num_samples: Optional[int] = None,
        num_samples_inf: Optional[int] = None,
        mask_out_of_bounds_samples: Optional[bool] = None,
        contract_coords: Optional[bool] = None,
        disparity_at_inf: Optional[float] = None,
        input_grid_sizes=None,
        rays_jitter_near_far: Optional[bool] = None,
        return_list: bool = True,
        generator: Optional[torch.Generator] = None,
        impl: str = "auto",
    ):
        """Splat through the MLP; arguments as
        :meth:`LightplaneSplatter.forward`, plus ``input_grid`` (a grid-list,
        or a flat tensor with ``input_grid_sizes``)."""
        if input_grid is None:
            raise ValueError("input_grid must be provided")
        rays, kw = self._call_kwargs(
            rays, self.rays_encoding_dim, num_samples, num_samples_inf,
            mask_out_of_bounds_samples, contract_coords, disparity_at_inf,
            rays_jitter_near_far, generator,
        )
        if self.use_naive_impl:
            return lightplane_mlp_splatter_naive(
                rays, grid_size, self.get_splatter_params(), input_grid,
                input_grid_sizes=input_grid_sizes, return_list=return_list,
                **kw,
            )
        return lightplane_mlp_splatter(
            rays, grid_size, self.get_splatter_params(), input_grid,
            input_grid_sizes=input_grid_sizes, return_list=return_list,
            impl=impl, **kw,
        )
