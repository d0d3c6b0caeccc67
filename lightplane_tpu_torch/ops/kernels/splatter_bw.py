"""The splatter's adjoint kernel (S2): its wrapper, its plain PyTorch version
and the dispatch between them.

``splat_bwd_cuda`` launches ``csrc/splatter_bw.cu`` (which replaces
``lightplane_tpu/ops/kernels/splatter_pallas.py::_build_bw_kernel``);
``splat_bwd_torch`` is the same march as a plain PyTorch loop over steps
(the port of the JAX scan core's ``_splat_bwd``).  ``splat_bwd`` sends CUDA
tensors to the kernel and CPU tensors to the plain version; there is no
fallback from one to the other.

The adjoint of a splat is a gather: each step samples the incoming
gradient of the feature grid at the ray's point (``g_vec``).  Without an
MLP the encoding's gradient is the sum of ``g_vec`` over the steps; with
one, each step's MLP is recomputed and differentiated, and its input
gradient is summed into the encoding's and splatted into the input grid's.
No per-sample activation is kept: memory is independent of the number of
samples.  Every function takes ``(cfg, geom, diff, g_feat_grid)`` with
``geom`` and ``diff`` as in ``splatter_fw`` and returns ``(g_encoding,
g_input_grid_flat, g_mlp_params)``, the last two None without an MLP.

The relu masks, as R2's (``renderer_bw.py``).  Where a relu's input lies
within rounding of 0, the kernel and the plain version may take opposite
branches and a gradient jumps by a whole term.  The kernel's recording
build (``splat_bwd_cuda_relu_masks``; the same build as R2's) writes the
branch of every unit of every hidden layer's output at every (ray, step) as
one bit, into an int32 tensor ``[R, steps, layers - 1, width // 32]``
(``mask_shape``), and ``splat_bwd_torch(..., relu_masks=)`` replays them:
``x * mask`` in place of ``relu(x)``.  ``relu_masks_torch`` records the
plain forward's own.
"""

from __future__ import annotations

import torch

from ..grid_sample import sample_grid_rep
from ..splatter import _march_points, _SplatCfg, _step_fused_feature
from .renderer_bw import RELU_MASKS_BUILD, pack_masks, unpack_masks
from .renderer_fw import MAX_SMEM_BYTES, WIDTHS, _check, check_impl
from .splatter_fw import _ptr, aligned, splat_launch_args

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it.
LAUNCHES = 0

# Rays per block the MLP adjoint may take, widest first: the block keeps
# every ray's layer inputs in shared memory.
RAYS_PER_BLOCK = (128, 64, 32)


def mask_shape(cfg: _SplatCfg, R: int):
    """Shape of the relu masks of ``R`` rays through the splatter MLP:
    ``[R, steps, layers - 1, words]`` with one bit per unit of the kernel's
    padded width (32 or 64)."""
    width = next(w for w in WIDTHS if max(cfg.n_hidden) <= w)
    return (R, cfg.tot_num_samples, len(cfg.n_hidden) - 2, width // 32)


def relu_masks_torch(cfg: _SplatCfg, geom, diff):
    """The relu masks that the plain forward takes, in the kernel's layout
    (``mask_shape``)."""
    grid_idx = geom[4]
    shape = mask_shape(cfg, geom[0].shape[0])
    out = torch.zeros(shape, dtype=torch.int32, device=geom[0].device)
    for s in range(cfg.tot_num_samples):
        pts = _march_points(cfg, geom, s)

        def relu(k, x):
            out[:, s, k] = pack_masks(x > 0, shape[3])
            return torch.relu(x)

        _step_fused_feature(cfg, pts, *diff, grid_idx, relu=relu)
    return out


def splat_bwd_torch(cfg: _SplatCfg, geom, diff, g_feat_grid,
                    relu_masks=None):
    """Plain PyTorch adjoint march; with an MLP each step is differentiated
    by ``torch.autograd.grad`` (the per-step ``jax.vjp``).  Given
    ``relu_masks`` (``mask_shape``), each step's MLP applies them in place
    of its relus."""
    grid_idx = geom[4]
    encoding = diff[0]
    if not cfg.n_hidden:
        g_enc = torch.zeros_like(encoding)
        for s in range(cfg.tot_num_samples):
            pts = _march_points(cfg, geom, s)
            g_enc += sample_grid_rep(g_feat_grid, cfg.output_grid_sizes, pts,
                                     grid_idx, cfg.mask_out_of_bounds_samples)
        return g_enc, None, None

    leaves = [t.detach().requires_grad_(True) for t in diff]
    grads = [torch.zeros_like(t) for t in leaves]
    for s in range(cfg.tot_num_samples):
        pts = _march_points(cfg, geom, s)
        g_vec = sample_grid_rep(g_feat_grid, cfg.output_grid_sizes, pts,
                                grid_idx, cfg.mask_out_of_bounds_samples)
        relu = {}
        if relu_masks is not None:
            m = unpack_masks(relu_masks[:, s]).to(encoding.dtype)
            relu = dict(relu=lambda k, x, m=m: x * m[:, k, : x.shape[-1]])
        with torch.enable_grad():
            vec = _step_fused_feature(cfg, pts, *leaves, grid_idx, **relu)
        for acc, d in zip(grads, torch.autograd.grad(vec, leaves, g_vec)):
            acc += d
    return tuple(grads)


def _launch_bw(cfg: _SplatCfg, geom, diff, g_feat_grid, defines,
               relu_masks):
    global LAUNCHES
    directions, origins, near, far, grid_idx = geom
    a = splat_launch_args(cfg, geom, diff, "splat_bwd_cuda")
    _check(g_feat_grid, "g_feat_grid", torch.float32, (cfg.v_total, a.C),
           a.device)
    encoding, input_grid_flat, mlp_params = (aligned(t) for t in diff)
    g_feat_grid = aligned(g_feat_grid)

    from ._build import library

    lib = library(defines)
    rays_per_block = 0
    f32 = torch.float32
    g_enc = torch.empty_like(encoding)
    g_igrid = g_mlp = partials = None
    if a.n_layers:
        for rays_per_block in RAYS_PER_BLOCK:
            smem = lib.lightplane_splat_bw_smem_bytes(a.width, rays_per_block,
                                                      a.n_layers)
            if smem <= MAX_SMEM_BYTES:
                break
        else:
            raise ValueError(
                f"the splatter's adjoint needs {smem} bytes of shared memory "
                f"per block of {rays_per_block} rays at these MLP widths, "
                f"more than the {MAX_SMEM_BYTES} a Hopper block can have")
        n_blocks = -(-a.R // rays_per_block)
        padded_layer = a.width * a.width + a.width
        g_igrid = torch.zeros_like(input_grid_flat)
        g_mlp = torch.empty((a.n_params,), dtype=f32, device=a.device)
        # per-block partial sums of the padded MLP weight gradients; each
        # block initialises its own row, and a second kernel sums the rows
        partials = torch.empty((max(n_blocks, 1), a.n_layers * padded_layer),
                               dtype=f32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.lightplane_splat_bw(
        origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
        far.data_ptr(), grid_idx.data_ptr(), encoding.data_ptr(),
        _ptr(input_grid_flat), _ptr(mlp_params), g_feat_grid.data_ptr(),
        g_enc.data_ptr(), _ptr(g_igrid), _ptr(g_mlp), _ptr(partials),
        a.R, len(cfg.output_grid_sizes), a.out_meta, a.C,
        len(cfg.input_grid_sizes or ()), a.in_meta, a.C_in,
        a.n_layers, a.mlp_widths, a.width, rays_per_block,
        cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf,
        int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
        _ptr(relu_masks), stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(f"splatter_bw kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return g_enc, g_igrid, g_mlp


def splat_bwd_cuda(cfg: _SplatCfg, geom, diff, g_feat_grid):
    """Launch the splat adjoint kernel on the current CUDA stream."""
    return _launch_bw(cfg, geom, diff, g_feat_grid, (), None)


def splat_bwd_cuda_relu_masks(cfg: _SplatCfg, geom, diff, g_feat_grid):
    """The kernel's recording build (``RELU_MASKS_BUILD``), with an MLP:
    returns its gradients, as ``splat_bwd_cuda``'s, and the relu masks its
    recomputed forward took (``mask_shape``; zero at steps that the whole
    block skipped, where every ray's g_vec is 0)."""
    if not cfg.n_hidden:
        raise ValueError("the relu masks need the splatter MLP")
    masks = torch.zeros(mask_shape(cfg, geom[0].shape[0]), dtype=torch.int32,
                        device=geom[0].device)
    grads = _launch_bw(cfg, geom, diff, g_feat_grid, RELU_MASKS_BUILD, masks)
    return grads, masks


def splat_bwd(cfg: _SplatCfg, geom, diff, g_feat_grid, impl: str = "auto"):
    """Splat adjoint: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors, with ``impl`` as in ``splatter_fw.splat_fwd``."""
    if check_impl(impl, geom[0].is_cuda, geom[0].device):
        return splat_bwd_torch(cfg, geom, diff, g_feat_grid)
    return splat_bwd_cuda(cfg, geom, diff, g_feat_grid)
