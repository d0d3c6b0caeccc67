"""The splatter's adjoint kernel (S2): its wrapper, its plain PyTorch
versions and the dispatch between them.

``splat_bwd_cuda`` launches ``csrc/splatter_bw.cu`` (which replaces
``lightplane_tpu/ops/kernels/splatter_pallas.py::_build_bw_kernel``):
without the MLP one gather (a launch a slice of at most 512 channels);
with it, slice by slice of the rays
(``adjoint_slices``), the gather staging every step's ``g_vec``, pass A (a
warp per ray: the recomputed MLP and its backward, the MLP input gradient
``g_in`` of every step staged; at widths 96 to 768 a block's warps in
lockstep over the layers staged once a block, ``wide_a_plan``) and pass B
(S1's planned splat of the
staged ``g_in`` over the input grid-list,
``splatter_fw.splat_by_plan_cuda``), then the sum of the per-block weight
gradients.  ``splat_bwd_torch`` is the same adjoint as a plain PyTorch loop
over steps (the port of the JAX scan core's ``_splat_bwd``), the
reference; ``splat_bwd_two_pass_torch`` is the kernel's two-pass design in
plain PyTorch, for the tests.  ``splat_bwd`` sends CUDA tensors to the
kernel and CPU tensors to ``splat_bwd_torch``; there is no fallback from
one to the other.

The adjoint of a splat is a gather: each step samples the incoming
gradient of the feature grid at the ray's point (``g_vec``).  Without an
MLP the encoding's gradient is the sum of ``g_vec`` over the steps; with
one, each step's MLP is recomputed and differentiated, and its input
gradient is summed into the encoding's and splatted into the input grid's.
No per-sample activation is kept by ``splat_bwd_torch``; the kernel's
staging buffer and run lists are capped by ``splatter_fw.PLAN_MAX_RUNS``, so
its memory stops growing with the rays and the samples.  Every function takes ``(cfg, geom, diff, g_feat_grid)`` with
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

import ctypes

import torch

from ..grid_sample import sample_grid_rep
from ..splatter import (
    _chunk_points,
    _march_points,
    _splat_chunks,
    _SplatCfg,
    _step_fused_feature,
)
from . import splatter_fw as sfw
from .renderer_bw import RELU_MASKS_BUILD, pack_masks, unpack_masks
from .renderer_fw import (
    MAX_SMEM_BYTES,
    WIDE_CHUNK,
    _check,
    check_impl,
    wide_layers,
    wide_pack_bytes,
    wide_ring_bytes,
)

# Number of adjoints launched in this process: the kernel path adds one per
# adjoint (its passes, slices and sums together) and nothing else changes
# it.  MLP_LAUNCHES counts the adjoints with the splatter MLP, in the same
# way.
LAUNCHES = 0
MLP_LAUNCHES = 0

# The wide pass A (csrc/splatter_wide.cuh, widths 96-768): the most warps
# a block, and a flag each in shared memory
WIDE_A_MAX_WARPS = 8
WIDE_A_FLAG_BYTES = 4 * WIDE_A_MAX_WARPS


def mask_shape(cfg: _SplatCfg, R: int):
    """Shape of the relu masks of ``R`` rays through the splatter MLP:
    ``[R, steps, layers - 1, words]`` with one bit per unit of the kernel's
    padded width (``splatter_fw.MLP_WIDTHS``)."""
    width = next(w for w in sfw.MLP_WIDTHS if max(cfg.n_hidden) <= w)
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
    """Plain PyTorch adjoint march, a chunk of steps at a time
    (``splatter._splat_chunks``); with an MLP each step is differentiated
    by ``torch.autograd.grad`` (the per-step ``jax.vjp``; one call a
    chunk).  Given
    ``relu_masks`` (``mask_shape``), each step's MLP applies them in place
    of its relus."""
    grid_idx = geom[4]
    encoding = diff[0]
    chunks = _splat_chunks(cfg, geom, diff)
    if not cfg.n_hidden:
        g_enc = torch.zeros_like(encoding)
        for chunk in chunks:
            pts = _chunk_points(cfg, geom, chunk)
            g = sample_grid_rep(g_feat_grid, cfg.output_grid_sizes, pts,
                                grid_idx, cfg.mask_out_of_bounds_samples)
            for j in range(len(chunk)):   # summed step by step
                g_enc += g[:, j]
        return g_enc, None, None

    leaves = [t.detach().requires_grad_(True) for t in diff]
    grads = [torch.zeros_like(t) for t in leaves]
    for chunk in chunks:
        pts = _chunk_points(cfg, geom, chunk)
        g_vec = sample_grid_rep(g_feat_grid, cfg.output_grid_sizes, pts,
                                grid_idx, cfg.mask_out_of_bounds_samples)
        relu = {}
        if relu_masks is not None:
            m = unpack_masks(relu_masks[:, chunk[0]:chunk[-1] + 1]).to(
                encoding.dtype)
            relu = dict(relu=lambda k, x, m=m: x * m[:, :, k, : x.shape[-1]])
        with torch.enable_grad():
            vec = _step_fused_feature(cfg, pts, *leaves, grid_idx, **relu)
        for acc, d in zip(grads, torch.autograd.grad(vec, leaves, g_vec)):
            acc += d
    return tuple(grads)


def adjoint_slices(cfg: _SplatCfg, bricks, n_rays: int):
    """The slices ``(start, stop)`` of the rays that the MLP adjoint runs
    pass B over: each slice's staged ``g_in`` ([rays, steps, C_in] f32) and
    each of its run lists over an input sub-grid (``splatter_fw.plan_shape``,
    8 bytes a run, ``bricks`` per input sub-grid) within ``PLAN_MAX_RUNS``
    runs' bytes; each slice but the last a multiple of 32 rays."""
    steps, C_in = cfg.tot_num_samples, cfg.n_hidden[0]
    runs = max(sfw.plan_shape(cfg, (b,), 1, (gs,)).capacity
               for gs, b in zip(cfg.input_grid_sizes, bricks))
    return sfw.byte_slices(0, n_rays, max(4 * steps * C_in, 8 * runs))


def gvec_slices(cfg: _SplatCfg, lo: int, hi: int):
    """The slices of ``[lo, hi)`` (a slice of ``adjoint_slices``) that the
    gather and pass A run over: each one's staged ``g_vec`` ([rays, steps,
    C] f32) within ``PLAN_MAX_RUNS`` runs' bytes."""
    return sfw.byte_slices(lo, hi, 4 * cfg.tot_num_samples * cfg.out_chn)


def wide_a_stride(d: int) -> int:
    """Floats of a row of the wide pass A's tile of a layer input (or
    g_vec) of ``d`` channels: rounded up to 16 (the weight gradient's
    M-tiles), plus 4 (``csrc/splatter_bw.cu::wide_stride``)."""
    return -(-d // 16) * 16 + 4


def wide_a_plan(width: int, n_hidden):
    """The wide pass A's ``(warps, shared-memory bytes)`` at ``width``
    (96-768) for the MLP ``n_hidden``: per warp a [WIDE_CHUNK, stride] f32
    tile for each layer's input and one for g_vec (``wide_a_stride``), then
    the ring and a flag per warp; the most warps, up to
    ``WIDE_A_MAX_WARPS``, that fit in a block's shared memory, in whole
    warpgroups past 4 (``wide_a_warps``).  Raises where one warp does not
    fit."""
    per_warp = 4 * WIDE_CHUNK * sum(wide_a_stride(d) for d in n_hidden)

    def smem(warps):
        return warps * per_warp + wide_ring_bytes(width) + WIDE_A_FLAG_BYTES

    fits = [w for w in range(1, WIDE_A_MAX_WARPS + 1)
            if smem(w) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(f"the splatter's adjoint needs {smem(1)} bytes of "
                         f"shared memory for one warp at these MLP widths, "
                         f"more than the {MAX_SMEM_BYTES} a Hopper block has")
    warps = fits[-1] if fits[-1] <= 4 else fits[-1] // 4 * 4
    return warps, smem(warps)


def splat_bwd_two_pass_torch(cfg: _SplatCfg, geom, diff, g_feat_grid,
                             relu_masks=None):
    """The kernel's two-pass design in plain PyTorch, slice by slice of the
    rays (``adjoint_slices``): pass A differentiates each step's MLP
    (``torch.autograd.grad``), sums the encoding's and the MLP's gradients
    and stages each step's MLP input gradient ``g_in``; pass B splats the
    staged rows run by run of the plan over each input sub-grid
    (``splatter_fw.splat_steps_torch``), as the kernel's pass B does.
    ``relu_masks`` as ``splat_bwd_torch``'s.  Without the MLP it is
    ``splat_bwd_torch``."""
    if not cfg.n_hidden:
        return splat_bwd_torch(cfg, geom, diff, g_feat_grid)
    encoding, input_grid_flat, mlp_params = diff
    steps, C_in = cfg.tot_num_samples, cfg.n_hidden[0]
    in_sizes = cfg.input_grid_sizes
    mask = cfg.mask_out_of_bounds_samples
    bricks = sfw.pick_bricks(cfg, grid_sizes=in_sizes)
    g_enc = torch.zeros_like(encoding)
    g_grid = torch.zeros_like(input_grid_flat)
    g_mlp = torch.zeros_like(mlp_params)
    mlp = mlp_params.detach().requires_grad_(True)
    for lo, hi in adjoint_slices(cfg, bricks, encoding.shape[0]):
        geom_s = tuple(t[lo:hi] for t in geom)
        enc = encoding[lo:hi].detach().requires_grad_(True)
        stage = encoding.new_zeros((hi - lo, steps, C_in))
        for s in range(steps):  # pass A
            pts = _march_points(cfg, geom_s, s)
            g_vec = sample_grid_rep(g_feat_grid, cfg.output_grid_sizes, pts,
                                    geom_s[4], mask)
            relu = {}
            if relu_masks is not None:
                m = unpack_masks(relu_masks[lo:hi, s]).to(encoding.dtype)
                relu = dict(relu=lambda k, x, m=m: x * m[:, k, : x.shape[-1]])
            with torch.enable_grad():
                vec = _step_fused_feature(cfg, pts, enc, input_grid_flat,
                                          mlp, geom_s[4], **relu)
            g_in, d_mlp = torch.autograd.grad(vec, (enc, mlp), g_vec)
            stage[:, s] = g_in
            g_mlp += d_mlp
        g_enc[lo:hi] = stage.sum(1)
        sfw.splat_steps_torch(cfg, geom_s, stage, g_grid, in_sizes,
                              bricks)  # pass B
    return g_enc, g_grid, g_mlp


def _launch_bw(cfg: _SplatCfg, geom, diff, g_feat_grid, defines,
               relu_masks):
    global LAUNCHES, MLP_LAUNCHES
    a = sfw.splat_launch_args(cfg, geom, diff, "splat_bwd_cuda")
    _check(g_feat_grid, "g_feat_grid", torch.float32, (cfg.v_total, a.C),
           a.device)
    encoding, input_grid_flat, mlp_params = (sfw.aligned(t) for t in diff)
    g_feat_grid = sfw.aligned(g_feat_grid)

    from ._build import library

    lib = library(defines)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    f32 = torch.float32
    ptr = sfw._ptr

    def run(part, geom_s, enc, g_enc=None, rows=0, stage=None,
            partial=None, g_mlp=None, masks=None, g_vec=None,
            workspace=None):
        directions, origins, near, far, grid_idx = geom_s
        rc = lib.lightplane_splat_bw(
            origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
            far.data_ptr(), grid_idx.data_ptr(), enc.data_ptr(),
            ptr(input_grid_flat), ptr(mlp_params), g_feat_grid.data_ptr(),
            ptr(g_enc), ptr(g_mlp), ptr(partial), ptr(stage), ptr(g_vec),
            directions.shape[0], len(cfg.output_grid_sizes), a.out_meta,
            a.C, len(cfg.input_grid_sizes or ()), a.in_meta, a.C_in,
            a.n_layers, a.mlp_widths, a.width, rows,
            cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf,
            int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
            part, ptr(masks), ptr(workspace), stream,
        )
        if rc != 0:
            msg = lib.lightplane_cuda_error_string(rc).decode()
            raise RuntimeError(
                f"splatter_bw kernel launch (part {part}) failed: {msg} "
                f"({rc})")

    if not a.n_layers:
        # the gather, in slices of at most 512 channels past 512
        # (csrc/splatter_bw.cu, kEncSliceChn)
        g_enc = torch.empty_like(encoding)
        run(0, geom, encoding, g_enc)
        LAUNCHES += 1
        return g_enc, None, None

    workspace = None
    if a.width > 64:
        # raises where one warp does not fit
        warps, smem = wide_a_plan(a.width, cfg.n_hidden)
        layers = wide_layers(a.n_layers, 0, 0, list(cfg.n_hidden))
        ws_bytes = wide_pack_bytes(sfw.splat_products(layers, True))
        workspace = torch.empty((ws_bytes // 4,), dtype=torch.int32,
                                device=a.device)
    conf = (ctypes.c_int * 5)()
    rc = lib.lightplane_splat_bw_mlp_config(a.width, a.n_layers,
                                            a.mlp_widths, conf)
    if rc != 0:
        raise ValueError(
            f"the splatter's adjoint needs {conf[3]} bytes of shared memory "
            f"for one warp at these MLP widths, more than a Hopper block "
            f"has ({lib.lightplane_cuda_error_string(rc).decode()})")
    if a.width > 64 and (conf[0], conf[3], conf[4]) != (warps, smem,
                                                         ws_bytes):
        raise RuntimeError(f"the wide pass A's plan {tuple(conf)} is not "
                           f"the wrapper's {(warps, smem, ws_bytes)}")
    rows, row_floats = conf[1], conf[2]
    g_enc = torch.empty_like(encoding)
    g_grid = torch.zeros_like(input_grid_flat)
    g_mlp = torch.empty((a.n_params,), dtype=f32, device=a.device)
    # the blocks' rows of weight-gradient sums, added to by every slice
    partial = torch.zeros((rows, row_floats), dtype=f32, device=a.device)
    in_sizes = cfg.input_grid_sizes
    bricks = sfw.pick_bricks(cfg, grid_sizes=in_sizes)
    b_args = sfw.list_args(cfg, a, input_grid_flat.shape[0])
    limit = sfw.batch_limit(cfg)
    for lo, hi in adjoint_slices(cfg, bricks, a.R):
        geom_s = tuple(t[lo:hi] for t in geom)
        stage = torch.empty((hi - lo, cfg.tot_num_samples, a.C_in),
                            dtype=f32, device=a.device)
        g_vec = None
        for glo, ghi in gvec_slices(cfg, lo, hi):
            if g_vec is None:
                g_vec = torch.empty((ghi - glo, cfg.tot_num_samples, a.C),
                                    dtype=f32, device=a.device)
            run(1, tuple(t[glo:ghi] for t in geom), encoding[glo:ghi],
                g_enc[glo:ghi], rows, stage[glo - lo:ghi - lo], partial,
                masks=None if relu_masks is None else relu_masks[glo:ghi],
                g_vec=g_vec, workspace=workspace)
        del g_vec
        for g, brick in enumerate(bricks):
            sfw.splat_by_plan_cuda(lib, cfg, geom_s, (stage, None, None),
                                   b_args, g, brick, g_grid, None, in_sizes,
                                   limit)
        del stage
    run(2, geom, encoding, rows=rows, partial=partial, g_mlp=g_mlp)
    LAUNCHES += 1
    MLP_LAUNCHES += 1
    return g_enc, g_grid, g_mlp


def splat_bwd_cuda(cfg: _SplatCfg, geom, diff, g_feat_grid, defines=()):
    """Launch the splat adjoint on the current CUDA stream; ``defines``
    pick a variant build (``_build.library``)."""
    return _launch_bw(cfg, geom, diff, g_feat_grid, tuple(defines), None)


def splat_bwd_cuda_relu_masks(cfg: _SplatCfg, geom, diff, g_feat_grid):
    """The kernel's recording build (``RELU_MASKS_BUILD``), with an MLP:
    returns its gradients, as ``splat_bwd_cuda``'s, and the relu masks its
    recomputed forward took (``mask_shape``; zero in the chunks of 32
    steps, 16 at widths above 64, where a ray's g_vec is 0 at every
    step)."""
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
