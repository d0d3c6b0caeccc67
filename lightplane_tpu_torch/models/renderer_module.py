"""``LightplaneRenderer``: the parameter-owning renderer module
(counterpart of ``lightplane_tpu/models/renderer_module.py``).

Owns the flat decoder MLP parameters and the harmonic ray-embedding linear
layer, and adds background-color compositing, near/far jitter, the
naive/fused switch around :func:`lightplane_renderer`, pointwise decoder
evaluation and the occupancy scaffold.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.misc_utils import if_not_none_else, process_and_flatten_grid
from ..ops.mlp_utils import (
    DecoderParams,
    flattened_decoder_params_to_list,
    init_decoder_params,
)
from ..ops.naive_renderer import (
    lightplane_eval_mlp,
    lightplane_eval_mlp_opacity_only,
    lightplane_renderer_naive,
)
from ..ops.rays import (
    Rays,
    calc_harmonic_embedding,
    calc_harmonic_embedding_dim,
    jitter_near_far,
)
from ..ops.renderer import _image_tile_reorder, lightplane_renderer


class LightplaneRenderer(nn.Module):
    """Module wrapping :func:`lightplane_renderer`.

    Construction args match the Flax module's fields; ``use_naive_impl``
    switches to the materializing oracle.  ``generator`` seeds the decoder
    initialization; at call time an explicit ``generator`` drives near/far
    jitter and draws a noise seed when none is given.  The parameters live
    on ``device``: the GPU unless the caller asks for ``"cpu"``.
    """

    def __init__(
        self,
        num_samples: int,
        color_chn: int,
        grid_chn: int,
        mlp_hidden_chn: int,
        mlp_n_layers_opacity: int = 2,
        mlp_n_layers_trunk: int = 2,
        mlp_n_layers_color: int = 2,
        use_separate_color_grid: bool = False,
        opacity_init_bias: float = -5.0,
        gain: float = 1.0,
        bg_color: Union[Tuple[float, ...], float] = 0.0,
        enable_direction_dependent_colors: bool = True,
        ray_embedding_num_harmonics: Optional[int] = 3,
        num_samples_inf: int = 0,
        mask_out_of_bounds_samples: bool = False,
        contract_coords: bool = False,
        disparity_at_inf: float = 1e-5,
        inject_noise_sigma: float = 0.0,
        inject_noise_seed: Optional[int] = None,
        rays_jitter_near_far: bool = False,
        return_log_transmittance: bool = False,
        use_naive_impl: bool = False,
        generator: Optional[torch.Generator] = None,
        device="cuda",
    ):
        super().__init__()
        self.num_samples = num_samples
        self.color_chn = color_chn
        self.gain = gain
        self.bg_color = bg_color
        self.enable_direction_dependent_colors = (
            enable_direction_dependent_colors
        )
        self.ray_embedding_num_harmonics = ray_embedding_num_harmonics
        self.num_samples_inf = num_samples_inf
        self.mask_out_of_bounds_samples = mask_out_of_bounds_samples
        self.contract_coords = contract_coords
        self.disparity_at_inf = disparity_at_inf
        self.inject_noise_sigma = inject_noise_sigma
        self.inject_noise_seed = inject_noise_seed
        self.rays_jitter_near_far = rays_jitter_near_far
        self.return_log_transmittance = return_log_transmittance
        self.use_naive_impl = use_naive_impl

        dp = init_decoder_params(
            generator,
            n_layers_opacity=mlp_n_layers_opacity,
            n_layers_trunk=0 if use_separate_color_grid else mlp_n_layers_trunk,
            n_layers_color=mlp_n_layers_color,
            input_chn=grid_chn,
            hidden_chn=mlp_hidden_chn,
            color_chn=color_chn,
            opacity_init_bias=opacity_init_bias,
            pad_color_channels_to_min_block_size=True,
            use_separate_color_grid=use_separate_color_grid,
            device=device,
        )
        self._n_hidden_trunk = dp.n_hidden_trunk
        self._n_hidden_opacity = dp.n_hidden_opacity
        self._n_hidden_color = dp.n_hidden_color
        self.rays_encoding_dim = int(dp.n_hidden_color[0])
        self.mlp_params = nn.Parameter(dp.mlp_params)

        self.harmonic_ray_embedding_linear = None
        if ray_embedding_num_harmonics is not None:
            if not enable_direction_dependent_colors:
                raise ValueError(
                    "LightplaneRenderer's viewpoint dependent colors are"
                    " disabled (enable_direction_dependent_colors=False), but"
                    " `ray_embedding_num_harmonics` is set. Set"
                    " ray_embedding_num_harmonics=None if you intended to"
                    " disable viewpoint dependent colors."
                )
            lin = nn.Linear(
                calc_harmonic_embedding_dim(ray_embedding_num_harmonics),
                self.rays_encoding_dim,
            )
            with torch.no_grad():
                bound = (6.0 / (lin.in_features + lin.out_features)) ** 0.5
                u = torch.rand(lin.weight.shape, generator=generator)
                lin.weight.copy_((2.0 * u - 1.0) * bound)
                lin.bias.zero_()
            self.harmonic_ray_embedding_linear = lin.to(device)

    def get_decoder_params(self) -> DecoderParams:
        return DecoderParams(
            self.mlp_params,
            self._n_hidden_trunk,
            self._n_hidden_opacity,
            self._n_hidden_color,
            color_chn=self.color_chn,
        )

    def get_decoder_params_list(self):
        """``(w_trunk, b_trunk, w_opacity, b_opacity, w_color, b_color)``
        of the flat ``mlp_params``."""
        return flattened_decoder_params_to_list(
            self.mlp_params,
            self._n_hidden_trunk,
            self._n_hidden_opacity,
            self._n_hidden_color,
        )

    def _process_bg_color(self, bg_color) -> torch.Tensor:
        if bg_color is None:
            bg_color = self.bg_color
        device = self.mlp_params.device
        if isinstance(bg_color, (int, float)):
            bg_color = torch.full((self.color_chn,), float(bg_color),
                                  device=device)
        else:
            bg_color = torch.as_tensor(bg_color, dtype=torch.float32,
                                       device=device)
        if bg_color.shape[-1] != self.color_chn:
            raise ValueError(
                f"bg_color has {bg_color.shape[-1]} channels, expected "
                f"{self.color_chn}"
            )
        return bg_color

    def _get_ray_encoding(self, ray_encoding, directions):
        if ray_encoding is not None:
            return ray_encoding
        return self._get_ray_embedding(directions)

    def _get_ray_embedding(self, ray_directions):
        if not self.enable_direction_dependent_colors:
            return ray_directions.new_zeros(
                (ray_directions.shape[0], self.rays_encoding_dim)
            )
        normed = ray_directions / torch.clamp(
            torch.linalg.norm(ray_directions, dim=-1, keepdim=True), min=1e-12
        )
        harmonic_embed = calc_harmonic_embedding(
            normed, self.ray_embedding_num_harmonics
        )
        return self.harmonic_ray_embedding_linear(harmonic_embed)

    def eval_decoder_at_points(
        self,
        pts: torch.Tensor,
        pts_to_grid_idx: torch.Tensor,
        rays_encoding: Optional[torch.Tensor],
        feature_grid,
        color_feature_grid=None,
        scaffold: Optional[torch.Tensor] = None,
        gain: Optional[float] = None,
        mask_out_of_bounds_samples: Optional[bool] = None,
        contract_coords: Optional[bool] = None,
        directions: Optional[torch.Tensor] = None,
    ):
        """The decoder at points ``[n_rays, n_pts, 3]``: returns ``(opacity
        [n_rays, n_pts], color [n_rays, n_pts, C])``.  Without
        ``rays_encoding`` the harmonic embedding of ``directions``
        ``[n_rays, 3]`` is used."""
        if pts.dim() != 3 or pts.shape[-1] != 3:
            raise ValueError(f"pts must be [n_rays, n_pts, 3], got "
                             f"{tuple(pts.shape)}")
        if rays_encoding is None and directions is None:
            raise ValueError("Must pass one of (rays_encoding, directions)")
        grid_flat, color_grid_flat, grid_sizes, color_grid_sizes = (
            process_and_flatten_grid(feature_grid, color_feature_grid)
        )
        return lightplane_eval_mlp(
            points=pts,
            grid_flat=grid_flat,
            grid_sizes=grid_sizes,
            ray_grid_idx=pts_to_grid_idx,
            decoder_params=self.get_decoder_params(),
            rays_encoding=self._get_ray_encoding(rays_encoding, directions),
            gain=if_not_none_else(gain, self.gain),
            mask_out_of_bounds_samples=if_not_none_else(
                mask_out_of_bounds_samples, self.mask_out_of_bounds_samples
            ),
            scaffold=scaffold,
            color_grid_flat=color_grid_flat,
            color_grid_sizes=color_grid_sizes,
            contract_coords=if_not_none_else(
                contract_coords, self.contract_coords
            ),
        )

    def eval_opacity_at_points(
        self,
        pts: torch.Tensor,
        pts_to_grid_idx: torch.Tensor,
        feature_grid,
        scaffold: Optional[torch.Tensor] = None,
        gain: Optional[float] = None,
        mask_out_of_bounds_samples: Optional[bool] = None,
        grid_sizes=None,
    ) -> torch.Tensor:
        """Opacity ``[n_rays, n_pts]`` at points ``[n_rays, n_pts, 3]``."""
        grid_flat, _, grid_sizes, _ = process_and_flatten_grid(
            feature_grid, None, grid_sizes, None
        )
        return lightplane_eval_mlp_opacity_only(
            points=pts,
            grid_flat=grid_flat,
            grid_sizes=grid_sizes,
            ray_grid_idx=pts_to_grid_idx,
            decoder_params=self.get_decoder_params(),
            gain=if_not_none_else(gain, self.gain),
            mask_out_of_bounds_samples=if_not_none_else(
                mask_out_of_bounds_samples, self.mask_out_of_bounds_samples
            ),
            scaffold=scaffold,
        )

    def calculate_scaffold(
        self,
        feature_grid,
        scaffold_size: Tuple[int, int, int, int],
        threshold: float = 1e-7,
        grid_sizes=None,
        dilate_scaffold: int = 2,
    ) -> torch.Tensor:
        """A binary occupancy scaffold ``[B, D, H, W]`` float32: the opacity
        evaluated at the ``D x H x W`` lattice spanning the ``[-1, 1]`` cube
        (corners included), dilated by a ``(2 * dilate_scaffold + 1)^3`` max
        (a window that reaches past the edge sees only the cells inside) and
        thresholded at ``threshold``.  Evaluated without autograd."""
        B, D, H, W = (int(s) for s in scaffold_size)
        device = self.mlp_params.device
        zs, ys, xs = (torch.linspace(0.0, 1.0, n, device=device)
                      for n in (D, H, W))
        gz, gy, gx = torch.meshgrid(zs, ys, xs, indexing="ij")
        dense_xyz = (torch.stack([gx, gy, gz], dim=-1) * 2.0 - 1.0).reshape(
            D, H * W, 3)
        with torch.no_grad():
            scaffold = torch.stack([
                self.eval_opacity_at_points(
                    dense_xyz,
                    torch.full((D,), b, dtype=torch.int64, device=device),
                    feature_grid,
                    gain=self.gain,
                    mask_out_of_bounds_samples=self.mask_out_of_bounds_samples,
                    grid_sizes=grid_sizes,
                ).reshape(D, H, W)
                for b in range(B)
            ])
            if dilate_scaffold > 0:
                # max_pool3d pads with -inf: jax.lax.reduce_window's padding
                scaffold = F.max_pool3d(
                    scaffold[:, None], kernel_size=2 * dilate_scaffold + 1,
                    stride=1, padding=dilate_scaffold,
                )[:, 0]
            return (scaffold > threshold).float()

    def forward(
        self,
        rays: Rays,
        feature_grid,
        color_feature_grid=None,
        scaffold: Optional[torch.Tensor] = None,
        grid_sizes=None,
        color_grid_sizes=None,
        bg_color=None,
        num_samples: Optional[int] = None,
        gain: Optional[float] = None,
        num_samples_inf: Optional[int] = None,
        mask_out_of_bounds_samples: Optional[bool] = None,
        contract_coords: Optional[bool] = None,
        disparity_at_inf: Optional[float] = None,
        inject_noise_sigma: Optional[float] = None,
        inject_noise_seed: Optional[int] = None,
        rays_jitter_near_far: Optional[bool] = None,
        return_log_transmittance: Optional[bool] = None,
        image_size: Optional[Tuple[int, int]] = None,
        w3_budget: Optional[Tuple[int, int, int]] = None,
        generator: Optional[torch.Generator] = None,
        impl: str = "auto",
    ):
        """Render; returns ``(ray_length, alpha, feature_render)``.

        Arguments set to None take the module's defaults.  ``image_size``
        declares raster-order image rays, rendered in the JAX package's tile
        order with outputs in the input order.  ``generator`` drives the
        near/far jitter and, when noise is on and no seed is given, the
        noise seed.  ``impl`` is passed to :func:`lightplane_renderer`;
        ``w3_budget`` plans TPU kernels and is ignored.
        """
        del w3_budget
        num_samples = if_not_none_else(num_samples, self.num_samples)
        gain = if_not_none_else(gain, self.gain)
        num_samples_inf = if_not_none_else(
            num_samples_inf, self.num_samples_inf
        )
        mask_out_of_bounds_samples = if_not_none_else(
            mask_out_of_bounds_samples, self.mask_out_of_bounds_samples
        )
        contract_coords = if_not_none_else(
            contract_coords, self.contract_coords
        )
        disparity_at_inf = if_not_none_else(
            disparity_at_inf, self.disparity_at_inf
        )
        inject_noise_sigma = if_not_none_else(
            inject_noise_sigma, self.inject_noise_sigma
        )
        inject_noise_seed = if_not_none_else(
            inject_noise_seed, self.inject_noise_seed
        )
        rays_jitter_near_far = if_not_none_else(
            rays_jitter_near_far, self.rays_jitter_near_far
        )
        return_log_transmittance = if_not_none_else(
            return_log_transmittance, self.return_log_transmittance
        )

        bg_color = self._process_bg_color(bg_color)
        _check_renderer_ray_encoding_input(
            rays.encoding,
            self.ray_embedding_num_harmonics,
            self.rays_encoding_dim,
            self.enable_direction_dependent_colors,
        )
        encoding = self._get_ray_encoding(rays.encoding, rays.directions)
        near, far = rays.near, rays.far
        if rays_jitter_near_far:
            near, far = jitter_near_far(near, far, num_samples, generator)
        rays_p = Rays(
            directions=rays.directions, origins=rays.origins,
            grid_idx=rays.grid_idx, near=near, far=far, encoding=encoding,
        )

        inv = None
        if image_size is not None and not self.use_naive_impl:
            _, _, sizes, color_sizes = process_and_flatten_grid(
                feature_grid, color_feature_grid, grid_sizes, color_grid_sizes
            )
            rays_p, inv = _image_tile_reorder(
                rays_p, len(rays_p), image_size, sizes, color_sizes
            )

        if inject_noise_sigma > 0.0 and inject_noise_seed is None:
            inject_noise_seed = int(
                torch.randint(0, 1000000, (), generator=generator)
            )

        kwargs = dict(
            num_samples=num_samples,
            gain=gain,
            num_samples_inf=num_samples_inf,
            mask_out_of_bounds_samples=mask_out_of_bounds_samples,
            contract_coords=contract_coords,
            disparity_at_inf=disparity_at_inf,
            inject_noise_sigma=inject_noise_sigma,
            inject_noise_seed=inject_noise_seed,
            scaffold=scaffold,
            color_grid=color_feature_grid,
            grid_sizes=grid_sizes,
            color_grid_sizes=color_grid_sizes,
        )
        if self.use_naive_impl:
            ray_length, nlt, feature_render = lightplane_renderer_naive(
                rays_p, feature_grid, self.get_decoder_params(), **kwargs
            )
        else:
            ray_length, nlt, feature_render = lightplane_renderer(
                rays_p, feature_grid, self.get_decoder_params(), impl=impl,
                **kwargs,
            )

        if inv is not None:
            ray_length, nlt, feature_render = (
                ray_length[inv], nlt[inv], feature_render[inv]
            )
        inverted_mask = torch.exp(-nlt)
        feature_render = feature_render + inverted_mask[..., None] * bg_color
        if return_log_transmittance:
            alpha = -nlt
        else:
            alpha = 1.0 - inverted_mask
        return ray_length, alpha, feature_render


def _check_renderer_ray_encoding_input(
    ray_encoding,
    ray_embedding_num_harmonics,
    ray_encoding_dim: int,
    enable_direction_dependent_colors: bool,
):
    """Reject inconsistent ray-encoding settings."""
    if ray_encoding is not None and ray_encoding.shape[1] != ray_encoding_dim:
        raise ValueError(
            f"Ray encoding has a wrong dimension."
            f" Expected: {ray_encoding_dim}, got: {ray_encoding.shape[1]}"
        )
    if not enable_direction_dependent_colors:
        if ray_encoding is not None:
            raise ValueError(
                "Viewpoint dependent colors are disabled but rays.encoding is"
                " set; set rays.encoding=None."
            )
        if ray_embedding_num_harmonics is not None:
            raise ValueError(
                "Viewpoint dependent colors are disabled but"
                " ray_embedding_num_harmonics is set; set it to None."
            )
        return
    if (ray_embedding_num_harmonics is None) == (ray_encoding is None):
        if ray_encoding is None:
            raise ValueError(
                "rays.encoding is unset, but the module is not configured to"
                " compute harmonic ray embeddings"
                " (ray_embedding_num_harmonics is None). Set one of the two."
            )
        raise ValueError(
            "rays.encoding is set, but the module is also configured to"
            " compute harmonic ray embeddings"
            " (ray_embedding_num_harmonics is set). Set only one of the two."
        )
