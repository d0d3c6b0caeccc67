"""Fused Lightplane renderer (counterpart of
``lightplane_tpu/ops/renderer.py``).

The main march is a ``torch.autograd.Function`` (:class:`_RenderCore`, the
port of the JAX ``_render_core`` custom VJP).  Its forward runs the
hand-written CUDA kernel ``csrc/renderer_fw.cu`` for CUDA tensors and its
plain PyTorch version for CPU tensors, and saves only the inputs and the
final negative log transmittance.  Its backward recomputes the march far to
near, in ``csrc/renderer_bw.cu`` or its plain version.  Both passes keep
memory O(R), independent of ``num_samples``: no ``[R, S, ...]`` tensor is
made (the plain versions take a bounded chunk of steps at a time,
:func:`_chunk_steps`).  The background samples (``num_samples_inf``) are split off the main
march and run as a plain PyTorch loop under ordinary autograd, chained from
its negative log transmittance, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from . import guards
from .const import MIN_BLOCK_SIZE
from .grid_sample import sample_grid_rep
from .misc_utils import check_grid_and_color_grid, process_and_flatten_grid
from .mlp_utils import DecoderParams, flattened_decoder_params_to_list
from .naive_renderer import _contract_pi, _depth_inv_sphere, _depth_lin
from .rand import _wrap32, int_to_randn
from .rays import Rays, default_tile, tile_ray_order

# The JAX package's image tiling (renderer_pallas.MAX_CELLS_PER_GRID and
# renderer_w3.W3_TILE at its default 256-ray block).  The tile order decides
# which noise counter each pixel draws, so the port keeps the same choice.
MAX_CELLS_PER_GRID = 8192
W3_TILE = (16, 16)


@dataclasses.dataclass(frozen=True)
class _RenderCfg:
    """Static render configuration."""

    num_samples: int
    num_samples_inf: int
    gain: float
    mask_out_of_bounds_samples: bool
    contract_coords: bool
    disparity_at_inf: float
    inject_noise_sigma: float
    grid_sizes: tuple
    color_grid_sizes: Optional[tuple]
    n_hidden_trunk: tuple
    n_hidden_opacity: tuple
    n_hidden_color: tuple
    scaffold_size: Optional[tuple]
    num_rays_noise: int  # R used in the noise counter scheme
    # Rendered feature channels to return (the color MLP output is
    # zero-padded past them).
    out_chn: int
    # Stride of the per-(ray, step) noise counters.  Normally the total
    # sample count; pinned when the background tail is split off so the
    # main march draws the same noise as the unsplit march.
    noise_sample_stride: Optional[int] = None

    @property
    def tot_num_samples(self):
        return self.num_samples + self.num_samples_inf

    @property
    def noise_stride(self):
        return self.noise_sample_stride or self.tot_num_samples


def _step_depth_delta(cfg: _RenderCfg, near, far, s: int):
    """Depth t_s and step size delta_s at step ``s``: equispaced in
    [near, far] for s < num_samples, then disparity-spaced to
    1/disparity_at_inf; delta_0 = (far - near) / (num_samples - 1)."""
    ns, ni = cfg.num_samples, cfg.num_samples_inf
    s_f = torch.tensor(float(s), dtype=torch.float32)

    def depth(si):
        if ni > 0 and not bool(si < ns):
            return _depth_inv_sphere(far, cfg.disparity_at_inf, ni, si - ns)
        return _depth_lin(near, far, ns, si)

    t = depth(s_f)
    if s < 1:
        delta = (far - near) / (ns - 1) if ns > 1 else torch.ones_like(near)
    else:
        delta = t - depth(s_f - 1.0)
    return t, delta


def _step_noise(cfg: _RenderCfg, s: int, num_rays: int, seed: int, device):
    """Injected opacity noise of step ``s`` for every ray, with the counter
    scheme of ``rand.get_sample_randn``."""
    S = cfg.noise_stride
    num_rays_pad = max(cfg.num_rays_noise, MIN_BLOCK_SIZE)
    ray = torch.arange(num_rays, dtype=torch.int64, device=device)
    i1 = _wrap32(S * ray + s + 1)
    i2 = _wrap32(i1 + num_rays_pad * S)
    return int_to_randn(i1, i2, seed) * cfg.inject_noise_sigma


def _relu(k: int, x):
    return F.relu(x)


def _step_decoder(
    cfg: _RenderCfg,
    pts,                # [R, 3] or a chunk's [R, K, 3] (contracted)
    grid_flat,
    color_grid_flat,
    mlp_params,
    rays_encoding,      # [R, C_enc]
    grid_idx,           # [R]
    scaffold,           # [B*D*H*W, 1] flat or None
    noise,              # [R] ([R, K]) or None
    relu=_relu,
):
    """Sample and decode one march step: returns (sigma [R], color [R, C]);
    for a chunk of K steps (``pts`` [R, K, 3]) sigma [R, K] and color [R,
    K, C], each sample as its step alone gives it.

    ``relu(k, x)`` computes the decoder's k-th relu'd vector (``F.relu`` by
    default).  They are numbered in order: the trunk's layers (with no
    trunk, the relu of the feature), the opacity head's hidden layers, the
    colour head's hidden layers, and last, with a colour grid, the relu of
    its sample: the order of the backward kernel's recorded masks
    (``kernels/renderer_bw.py``)."""
    (w_t, b_t, w_o, b_o, w_c, b_c) = flattened_decoder_params_to_list(
        mlp_params, cfg.n_hidden_trunk, cfg.n_hidden_opacity,
        cfg.n_hidden_color,
    )
    feat = sample_grid_rep(
        grid_flat, cfg.grid_sizes, pts, grid_idx,
        cfg.mask_out_of_bounds_samples,
    )
    k = 0
    if color_grid_flat is None:
        x = feat
        for l in range(len(w_t)):
            x = x @ w_t[l] + b_t[l]
            if l < len(w_t) - 1:
                x = relu(k, x)
                k += 1
        trunk = relu(k, x)
        k += 1
        opacity_in, color_in = trunk, trunk
    else:
        # relu-field: separate color grid, no trunk MLP
        opacity_in = relu(k, feat)
        k += 1
        color_in = relu(
            len(w_o) + len(w_c) - 1,  # the last vector
            sample_grid_rep(
                color_grid_flat, cfg.color_grid_sizes, pts, grid_idx,
                cfg.mask_out_of_bounds_samples,
            ),
        )
    x = opacity_in
    for l in range(len(w_o)):
        x = x @ w_o[l] + b_o[l]
        if l < len(w_o) - 1:
            x = relu(k, x)
            k += 1
    opacity_raw = x[..., 0]
    x = color_in + _per_ray(rays_encoding, pts)
    for l in range(len(w_c)):
        x = x @ w_c[l] + b_c[l]
        if l < len(w_c) - 1:
            x = relu(k, x)
            k += 1
    log_color = x

    if noise is not None:
        opacity_raw = opacity_raw + noise
    sigma = cfg.gain * F.softplus(opacity_raw)
    color = torch.sigmoid(log_color)

    if scaffold is not None:
        sc = sample_grid_rep(
            scaffold, (cfg.scaffold_size + (1,),), pts, grid_idx, True,
            mode="nearest",
        )
        sigma = sigma * sc[..., 0]
        color = color * sc
    return sigma, color


def _step_points(cfg: _RenderCfg, origins, directions, t):
    """The sample points at depths ``t`` [R] (or a chunk's [R, K]): [R, 3]
    (or [R, K, 3]), contracted if asked."""
    if t.dim() == 2:
        origins, directions = origins[:, None], directions[:, None]
    pts = origins + t[..., None] * directions
    if cfg.contract_coords:
        pts = _contract_pi(pts)
    return pts


def _per_ray(x, pts):
    """A per-ray ``x`` [R, C] shaped to broadcast against the samples of
    ``pts`` ([R, 3], or a chunk's [R, K, 3])."""
    return x[:, None] if pts.dim() == 3 else x


# The plain versions march a chunk of steps at a time: one sampling and
# decoder call over a chunk's [R, K] samples in place of K calls over [R]
# (the same arithmetic sample by sample; the per-step host work, not the
# card, is what bounds a plain march of a few thousand rays).  A chunk has
# at most PLAIN_CHUNK_STEPS steps and at most PLAIN_CHUNK_FLOATS floats in
# an activation of the widest layer (PLAIN_CHUNK_FLOATS_CARD on a CUDA
# device, whose memory is larger), so memory stays O(R).
PLAIN_CHUNK_STEPS = 32
PLAIN_CHUNK_FLOATS = 1 << 22
PLAIN_CHUNK_FLOATS_CARD = 1 << 26


def _chunk_steps(steps, num_rays: int, width: int, on_card: bool = False):
    """``steps`` in consecutive runs (chunks) of at most PLAIN_CHUNK_STEPS
    steps and PLAIN_CHUNK_FLOATS (``on_card``: PLAIN_CHUNK_FLOATS_CARD)
    floats of a ``width``-wide activation over ``num_rays`` rays."""
    steps = list(steps)
    budget = PLAIN_CHUNK_FLOATS_CARD if on_card else PLAIN_CHUNK_FLOATS
    k = max(1, min(PLAIN_CHUNK_STEPS, budget // max(1, num_rays * width)))
    return [steps[i:i + k] for i in range(0, len(steps), k)]


def _plain_width(cfg: _RenderCfg, diff) -> int:
    """The widest of a march's grid channels and decoder layers."""
    widths = [t.shape[-1] for t in diff[:2] if t is not None]
    return max(widths + list(cfg.n_hidden_trunk + cfg.n_hidden_opacity
                             + cfg.n_hidden_color))


def _chunk_depth_delta(cfg: _RenderCfg, near, far, steps):
    """``_step_depth_delta`` of each of ``steps``, stacked: t, delta [R,
    K]."""
    td = [_step_depth_delta(cfg, near, far, s) for s in steps]
    return (torch.stack([t for t, _ in td], 1),
            torch.stack([d for _, d in td], 1))


def _chunk_noise(cfg: _RenderCfg, steps, num_rays: int, seed, device):
    """``_step_noise`` of each of ``steps``, stacked [R, K] (None without
    noise)."""
    if cfg.inject_noise_sigma <= 0.0:
        return None
    return torch.stack([_step_noise(cfg, s, num_rays, seed, device)
                        for s in steps], 1)


def _march(cfg: _RenderCfg, geom, diff, steps, nlt):
    """Plain PyTorch EA march over ``steps``, starting from the negative
    log transmittance ``nlt``: returns ``(depth, nlt, feat)`` with the
    features cropped to ``cfg.out_chn``."""
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    grid_flat, color_grid_flat, mlp_params, rays_encoding = diff
    R = directions.shape[0]
    depth = torch.zeros_like(nlt)
    feat = nlt.new_zeros((R, cfg.out_chn))
    for chunk in _chunk_steps(steps, R, _plain_width(cfg, diff),
                              directions.is_cuda):
        t, delta = _chunk_depth_delta(cfg, near, far, chunk)
        pts = _step_points(cfg, origins, directions, t)
        noise = _chunk_noise(cfg, chunk, R, noise_seed, directions.device)
        sigma, color = _step_decoder(
            cfg, pts, grid_flat, color_grid_flat, mlp_params, rays_encoding,
            grid_idx, scaffold, noise,
        )
        # the accumulation step by step, as one step at a time makes it
        for j in range(len(chunk)):
            nlt_new = nlt + sigma[:, j] * delta[:, j]
            w = torch.exp(-nlt) - torch.exp(-nlt_new)
            depth = depth + w * t[:, j]
            feat = feat + w[:, None] * color[:, j, : cfg.out_chn]
            nlt = nlt_new
    return depth, nlt, feat


class _RenderCore(torch.autograd.Function):
    """The main march with the O(1)-in-samples recompute backward.

    ``apply(cfg, impl, directions, origins, near, far, grid_idx, scaffold,
    noise_seed, grid_flat, color_grid_flat, mlp_params, rays_encoding)``
    returns ``(depth, nlt, feat)``.  The ray geometry gets no gradient, as
    in the JAX package.
    """

    @staticmethod
    def forward(ctx, cfg, impl, directions, origins, near, far, grid_idx,
                scaffold, noise_seed, grid_flat, color_grid_flat, mlp_params,
                rays_encoding):
        from .kernels.renderer_fw import render_fwd

        geom = (directions, origins, near, far, grid_idx, scaffold,
                noise_seed)
        diff = (grid_flat, color_grid_flat, mlp_params, rays_encoding)
        depth, nlt, feat = render_fwd(cfg, geom, diff, impl)
        ctx.cfg, ctx.impl, ctx.noise_seed = cfg, impl, noise_seed
        ctx.save_for_backward(directions, origins, near, far, grid_idx,
                              scaffold, *diff, nlt)
        return depth, nlt, feat

    @staticmethod
    @once_differentiable
    def backward(ctx, g_depth, g_nlt, g_feat):
        from .kernels.renderer_bw import render_bwd

        (directions, origins, near, far, grid_idx, scaffold, grid_flat,
         color_grid_flat, mlp_params, rays_encoding, nlt) = ctx.saved_tensors
        geom = (directions, origins, near, far, grid_idx, scaffold,
                ctx.noise_seed)
        diff = (grid_flat, color_grid_flat, mlp_params, rays_encoding)
        g_out = tuple(g.contiguous() for g in (g_depth, g_nlt, g_feat))
        grads = render_bwd(ctx.cfg, geom, diff, nlt, g_out, ctx.impl)
        label = "renderer(cuda)" if directions.is_cuda else "renderer(torch)"
        guards.assert_grads_finite(grads, label)
        return (None,) * 9 + tuple(grads)


def _render_core(cfg: _RenderCfg, geom, diff, impl: str):
    return _RenderCore.apply(cfg, impl, *geom, *diff)


def _render_tail(cfg: _RenderCfg, geom, diff, nlt_mid):
    """Background-sample tail: steps ``[num_samples, num_samples +
    num_samples_inf)``, chained from the main march's final negative log
    transmittance.  Background depths reach ``t ~ 1/disparity_at_inf``,
    where a transmittance rewind is ill-conditioned, so the tail is
    accumulated forward only.  Ray geometry carries no gradient."""
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    geom = (
        directions.detach(), origins.detach(), near.detach(), far.detach(),
        grid_idx, None if scaffold is None else scaffold.detach(), noise_seed,
    )
    return _march(
        cfg, geom, diff, range(cfg.num_samples, cfg.tot_num_samples), nlt_mid
    )


def _image_tile_reorder(rays, R, image_size, grid_sizes, color_grid_sizes):
    """Tile-reorder a raster-order image ray batch.  Returns
    ``(rays, inverse_permutation_or_None)``."""
    if image_size is None:
        return rays, None
    h, w = int(image_size[0]), int(image_size[1])
    if R != h * w:
        raise ValueError(
            f"image_size {image_size} does not match the ray count "
            f"({R} != {h * w})"
        )
    tile = default_tile(h, w)
    all_sizes = list(grid_sizes) + list(color_grid_sizes or ())
    if any(int(np.prod(gs[:-1])) > MAX_CELLS_PER_GRID for gs in all_sizes):
        if h % W3_TILE[0] == 0 and w % W3_TILE[1] == 0:
            tile = W3_TILE
    order_np, inv_np = tile_ray_order(h, w, tile=tile)
    if np.array_equal(order_np, np.arange(R)):
        return rays, None
    device = rays.directions.device
    rays = rays[torch.as_tensor(order_np, device=device)]
    return rays, torch.as_tensor(inv_np, device=device)


def _march_inputs(
    rays: Rays,
    grid_flat,
    color_grid_flat,
    grid_sizes,
    color_grid_sizes,
    decoder_params: DecoderParams,
    num_samples: int,
    gain: float,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    inject_noise_sigma: float = 0.0,
    inject_noise_seed: Optional[int] = None,
    scaffold: Optional[torch.Tensor] = None,
):
    """``(cfg, geom, diff)`` of the whole march over ``rays`` (background
    samples included), from :func:`lightplane_renderer`'s arguments and the
    flattened grid-lists."""
    if inject_noise_sigma > 0.0 and inject_noise_seed is None:
        raise ValueError(
            "inject_noise_seed must be given when inject_noise_sigma > 0"
        )
    R = rays.directions.shape[0]
    cfg = _RenderCfg(
        num_samples=int(num_samples),
        num_samples_inf=int(num_samples_inf),
        gain=float(gain),
        mask_out_of_bounds_samples=bool(mask_out_of_bounds_samples),
        contract_coords=bool(contract_coords),
        disparity_at_inf=float(disparity_at_inf),
        inject_noise_sigma=float(inject_noise_sigma),
        grid_sizes=grid_sizes,
        color_grid_sizes=color_grid_sizes,
        n_hidden_trunk=decoder_params.n_hidden_trunk,
        n_hidden_opacity=decoder_params.n_hidden_opacity,
        n_hidden_color=decoder_params.n_hidden_color,
        scaffold_size=(
            tuple(int(x) for x in scaffold.shape)
            if scaffold is not None
            else None
        ),
        num_rays_noise=R,
        out_chn=int(decoder_params.color_chn),
    )
    rays_encoding = rays.encoding
    if rays_encoding is None:
        rays_encoding = grid_flat.new_zeros((R, cfg.n_hidden_color[0]))
    # the scaffold gates the march and gets no gradient
    geom = (
        rays.directions, rays.origins, rays.near, rays.far,
        rays.grid_idx.to(torch.int32),
        scaffold.detach().reshape(-1, 1) if scaffold is not None else None,
        int(inject_noise_seed) if inject_noise_seed is not None else 0,
    )
    diff = (grid_flat, color_grid_flat, decoder_params.mlp_params,
            rays_encoding)
    return cfg, geom, diff


def lightplane_renderer(
    rays: Rays,
    grid: Union[Sequence[torch.Tensor], torch.Tensor],
    decoder_params: DecoderParams,
    num_samples: int,
    gain: float,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    inject_noise_sigma: float = 0.0,
    inject_noise_seed: Optional[int] = None,
    scaffold: Optional[torch.Tensor] = None,
    color_grid: Union[Sequence[torch.Tensor], torch.Tensor, None] = None,
    grid_sizes=None,
    color_grid_sizes=None,
    impl: str = "auto",
    tile_rays: Optional[int] = None,
    image_size: Optional[Tuple[int, int]] = None,
    w3_budget: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Emission-Absorption renderer, differentiable with respect to
    the grid-list, the decoder's ``mlp_params`` and ``rays.encoding``.

    Same arguments and numerics as
    ``lightplane_tpu.lightplane_renderer`` (see
    :func:`lightplane_renderer_naive` for their meaning).

    ``impl``: ``"auto"`` runs the CUDA kernels (forward and backward) for
    CUDA tensors and the plain PyTorch marches for CPU tensors; ``"cuda"``
    demands the kernels and raises for CPU tensors; ``"torch"`` runs the
    plain marches on any device.
    ``tile_rays`` and ``w3_budget`` plan TPU kernels and are ignored.

    ``image_size=(height, width)`` declares that ``rays`` are the raster
    pixels of one image: they are rendered in the JAX package's tile order
    (so the noise stream matches it) and the outputs come back in raster
    order.

    Returns:
        ray_length_render: ``[R]`` expected ray-termination length.
        negative_log_transmittance: ``[R]``.
        feature_render: ``[R, color_chn]`` rendered features.
    """
    del tile_rays, w3_budget
    check_grid_and_color_grid(grid, color_grid, grid_sizes, color_grid_sizes)
    grid_flat, color_grid_flat, grid_sizes, color_grid_sizes = (
        process_and_flatten_grid(grid, color_grid, grid_sizes, color_grid_sizes)
    )
    R = rays.directions.shape[0]
    rays, inv = _image_tile_reorder(
        rays, R, image_size, grid_sizes, color_grid_sizes
    )
    cfg, geom, diff = _march_inputs(
        rays, grid_flat, color_grid_flat, grid_sizes, color_grid_sizes,
        decoder_params, num_samples, gain, num_samples_inf,
        mask_out_of_bounds_samples, contract_coords, disparity_at_inf,
        inject_noise_sigma, inject_noise_seed, scaffold,
    )

    if cfg.num_samples_inf > 0 and cfg.num_samples > 0:
        # the main march keeps the unsplit noise counters; the tail is a
        # plain forward-accumulated loop
        cfg_main = dataclasses.replace(
            cfg, num_samples_inf=0, noise_sample_stride=cfg.tot_num_samples,
        )
        depth, nlt_mid, feat = _render_core(cfg_main, geom, diff, impl)
        depth_t, nlt, feat_t = _render_tail(cfg, geom, diff, nlt_mid)
        depth = depth + depth_t
        feat = feat + feat_t
    else:
        depth, nlt, feat = _render_core(cfg, geom, diff, impl)

    if decoder_params.color_chn < feat.shape[-1]:
        feat = feat[..., : decoder_params.color_chn]
    if inv is not None:
        depth, nlt, feat = depth[inv], nlt[inv], feat[inv]
    return depth, nlt, feat


def suggest_w3_budget(
    rays: Rays,
    grid,
    decoder_params: DecoderParams,
    num_samples: int,
    num_samples_inf: int = 0,
    disparity_at_inf: float = 1e-5,
    contract_coords: bool = False,
    color_grid=None,
    grid_sizes=None,
    color_grid_sizes=None,
    tile_rays: Optional[int] = None,
    image_size: Optional[Tuple[int, int]] = None,
    candidates=None,
) -> None:
    """Always ``None``.  The JAX package's function picks a window budget
    for its TPU kernel's big-grid sampler (``w3_budget``), which moves
    tiles of the grid into the TPU core's local memory.  The CUDA kernels
    read the grid where it lies and take no budget, and ``None`` is what
    the JAX function returns for a configuration that needs none; the
    arguments are the JAX function's, accepted and not read."""
    return None
