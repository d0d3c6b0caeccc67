"""The renderer's recompute-backward kernel: its wrapper, its plain PyTorch
version and the dispatch between them.

``render_bwd_cuda`` launches ``csrc/renderer_bw.cu`` (which replaces
``lightplane_tpu/ops/kernels/renderer_pallas.py::_build_bw_kernel``);
``render_bwd_torch`` is the same reverse march as a plain PyTorch loop over
steps (the port of the JAX scan core's ``_render_bwd``).  ``render_bwd``
sends CUDA tensors to the kernel and CPU tensors to the plain version; there
is no fallback from one to the other.

Both walk the steps far to near from the forward's final negative log
transmittance, rewind it one step at a time (``nlt_prev = nlt - sigma *
delta``), form the Emission-Absorption adjoint with a running suffix sum and
pull ``(g_sigma, g_color)`` back through the recomputed step decoder.  No
per-sample activation is kept: memory is O(R), independent of the number of
samples.  Every function takes ``(cfg, geom, diff, nlt_final, g_out)`` with
``geom`` and ``diff`` as in ``renderer_fw``, ``g_out = (g_depth [R], g_nlt
[R], g_feat [R, cfg.out_chn])``, and returns ``(g_grid_flat, g_color_grid_flat,
g_mlp_params, g_rays_encoding)``.
"""

from __future__ import annotations

import torch

from ..mlp_utils import _mlp_numel
from ..renderer import (
    _RenderCfg,
    _step_decoder,
    _step_depth_delta,
    _step_noise,
    _step_points,
)
from .renderer_fw import MAX_SMEM_BYTES, _check, check_impl, launch_args

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it.
LAUNCHES = 0

# Rays per block the kernel may take, widest first: the block keeps every
# ray's activations in shared memory, so wide or deep MLPs take fewer rays.
RAYS_PER_BLOCK = (128, 64, 32)


def render_bwd_torch(cfg: _RenderCfg, geom, diff, nlt_final, g_out):
    """Plain PyTorch reverse march; each step's decoder is differentiated by
    ``torch.autograd.grad`` (the per-step ``jax.vjp``)."""
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    g_depth, g_nlt, g_feat = g_out
    R = directions.shape[0]
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in diff]
    wrt = [t for t in leaves if t is not None]
    grads = [torch.zeros_like(t) for t in wrt]

    nlt_run = nlt_final
    suffix = torch.zeros_like(nlt_final)
    for s in reversed(range(cfg.tot_num_samples)):
        t, delta = _step_depth_delta(cfg, near, far, s)
        pts = _step_points(cfg, origins, directions, t)
        noise = (
            _step_noise(cfg, s, R, noise_seed, directions.device)
            if cfg.inject_noise_sigma > 0.0
            else None
        )
        with torch.enable_grad():
            sigma, color = _step_decoder(cfg, pts, *leaves, grid_idx,
                                         scaffold, noise)
            color = color[:, : cfg.out_chn]

        # transmittance rewind + EA adjoint
        nlt_prev = nlt_run - sigma.detach() * delta
        T = torch.exp(-nlt_run)          # T_s (includes step s)
        w = torch.exp(-nlt_prev) - T     # T_{s-1} - T_s
        g_w = g_depth * t + (g_feat * color.detach()).sum(-1)
        g_s = g_w * T - suffix + g_nlt
        d = torch.autograd.grad(
            (sigma, color), wrt, (g_s * delta, w[:, None] * g_feat),
            allow_unused=True,
        )
        for acc, di in zip(grads, d):
            if di is not None:
                acc += di
        suffix = suffix + g_w * w
        nlt_run = nlt_prev

    it = iter(grads)
    return tuple(None if t is None else next(it) for t in leaves)


def render_bwd_cuda(cfg: _RenderCfg, geom, diff, nlt_final, g_out,
                    defines=()):
    """Launch the recompute-backward kernel on the current CUDA stream.
    ``defines`` pick a variant build of the kernel (``_build.library``)."""
    global LAUNCHES
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    grid_flat, color_grid_flat, mlp_params, rays_encoding = diff
    a = launch_args(cfg, geom, diff, "render_bwd_cuda")
    g_depth, g_nlt, g_feat = g_out
    f32 = torch.float32
    _check(nlt_final, "nlt_final", f32, (a.R,), a.device)
    _check(g_depth, "g_depth", f32, (a.R,), a.device)
    _check(g_nlt, "g_nlt", f32, (a.R,), a.device)
    _check(g_feat, "g_feat", f32, (a.R, a.color_chn), a.device)

    from ._build import library

    lib = library(defines)
    for rays_per_block in RAYS_PER_BLOCK:
        smem = lib.lightplane_render_bw_smem_bytes(
            a.width, rays_per_block, a.n_layers, a.color_chn,
            int(color_grid_flat is not None))
        if smem <= MAX_SMEM_BYTES:
            break
    else:
        raise ValueError(
            f"the backward kernel needs {smem} bytes of shared memory per "
            f"block of {rays_per_block} rays at these MLP widths, more than "
            f"the {MAX_SMEM_BYTES} a Hopper block can have"
        )

    n_blocks = -(-a.R // rays_per_block)
    padded_layer = a.width * a.width + a.width
    n_params = sum(map(_mlp_numel, (cfg.n_hidden_trunk, cfg.n_hidden_opacity,
                                    cfg.n_hidden_color)))
    g_grid = torch.zeros_like(grid_flat)
    g_color_grid = (None if color_grid_flat is None
                    else torch.zeros_like(color_grid_flat))
    g_mlp = torch.empty((n_params,), dtype=f32, device=a.device)
    g_enc = torch.empty_like(rays_encoding)
    # per-block partial sums of the padded MLP weight gradients; each block
    # initialises its own row, and a second kernel sums the rows into g_mlp
    partials = torch.empty((max(n_blocks, 1), a.n_layers * padded_layer),
                           dtype=f32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.lightplane_render_bw(
        origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
        far.data_ptr(), grid_idx.data_ptr(), rays_encoding.data_ptr(),
        grid_flat.data_ptr(), mlp_params.data_ptr(),
        nlt_final.data_ptr(), g_depth.data_ptr(), g_nlt.data_ptr(),
        g_feat.data_ptr(),
        g_grid.data_ptr(), g_mlp.data_ptr(), g_enc.data_ptr(),
        partials.data_ptr(),
        a.R, len(cfg.grid_sizes), a.grid_meta, a.C,
        a.n_t, a.n_o, a.n_c, a.mlp_widths,
        a.C_enc, a.color_chn, a.width, rays_per_block,
        cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf, cfg.gain,
        int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
        cfg.inject_noise_sigma, int(noise_seed), cfg.noise_stride,
        cfg.num_rays_noise,
        *a.extras(scaffold, color_grid_flat),
        None if g_color_grid is None else g_color_grid.data_ptr(),
        stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(f"renderer_bw kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return g_grid, g_color_grid, g_mlp, g_enc


def render_bwd(cfg: _RenderCfg, geom, diff, nlt_final, g_out,
               impl: str = "auto"):
    """Recompute backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, with ``impl`` as in ``renderer_fw.render_fwd``."""
    if check_impl(impl, geom[0].is_cuda, geom[0].device):
        return render_bwd_torch(cfg, geom, diff, nlt_final, g_out)
    return render_bwd_cuda(cfg, geom, diff, nlt_final, g_out)
