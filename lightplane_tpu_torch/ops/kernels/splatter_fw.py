"""The splatter's forward kernel (S1): its wrapper, its plain PyTorch version
and the dispatch between them.

``splat_fwd_cuda`` launches ``csrc/splatter_fw.cu`` (which replaces
``lightplane_tpu/ops/kernels/splatter_pallas.py::_build_fw_kernel``);
``splat_fwd_torch`` is the same march as a plain PyTorch loop over steps
(the port of the JAX scan core ``_splat_fwd_impl``).  ``splat_fwd`` sends
CUDA tensors to the kernel and CPU tensors to the plain version; there is no
fallback from one to the other.

Every function takes ``(cfg, geom, diff)``: ``geom = (directions, origins,
near, far, grid_idx)`` and ``diff = (encoding, input_grid_flat,
mlp_params)`` (the last two None without an MLP), and returns the raw
accumulators ``(feat [V, C], w [V, 1])``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import guards
from ..grid_sample import grid_row_offsets, splat_grid_rep
from ..mlp_utils import _mlp_numel
from ..splatter import _march_points, _SplatCfg, _step_fused_feature
from .renderer_fw import (
    MAX_GRIDS,
    MAX_LAYERS,
    MAX_SMEM_BYTES,
    WIDTHS,
    _check,
    check_impl,
)

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it, so a caller can reset it and show that
# a run went through the kernel.
LAUNCHES = 0


def splat_fwd_torch(cfg: _SplatCfg, geom, diff):
    """Plain PyTorch splat over all steps: ``[vec | 1]`` into one
    ``[V, C + 1]`` accumulator updated in place, split at the end; memory
    O(V + R)."""
    directions, _, _, _, grid_idx = geom
    encoding, input_grid_flat, mlp_params = diff
    C = cfg.out_chn
    acc = encoding.new_zeros((cfg.v_total, C + 1))
    ones = encoding.new_ones((directions.shape[0], 1))
    for s in range(cfg.tot_num_samples):
        pts = _march_points(cfg, geom, s)
        vec = _step_fused_feature(cfg, pts, encoding, input_grid_flat,
                                  mlp_params, grid_idx)
        splat_grid_rep(torch.cat([vec, ones], -1), acc, cfg.output_grid_sizes,
                       pts, grid_idx, cfg.mask_out_of_bounds_samples,
                       inplace=True)
    return acc[:, :C].contiguous(), acc[:, C:].contiguous()


def _grid_meta(grid_sizes, rows: int, chn: int, name: str):
    """The host table ``(row offset, B, D, H, W)`` per sub-grid of a
    grid-list that must have ``rows`` rows of ``chn`` channels."""
    if not 1 <= len(grid_sizes) <= MAX_GRIDS:
        raise ValueError(f"the CUDA splatter takes 1..{MAX_GRIDS} sub-grids "
                         f"per grid-list, got {len(grid_sizes)} in {name}")
    offsets = grid_row_offsets(grid_sizes)
    if offsets[-1] != rows or any(gs[-1] != chn for gs in grid_sizes):
        raise ValueError(f"{name}'s sizes do not match its flat tensor")
    if rows * chn >= 2**31 or rows >= 2**31:
        raise ValueError(f"{name} too large for int32 row offsets")
    meta = []
    for gs, off in zip(grid_sizes, offsets):
        meta += [off, gs[0], gs[1], gs[2], gs[3]]
    return (ctypes.c_int * len(meta))(*meta)


def aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (the
    kernels read and reduce rows as float4)."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


@dataclasses.dataclass(frozen=True)
class SplatLaunchArgs:
    """What both splat kernels take besides the tensors: sizes, the padded
    MLP width and the host-side tables of grid shapes and MLP widths."""

    device: torch.device
    R: int
    C: int           # output channels
    C_in: int        # MLP input channels (the encoding's), 0 without an MLP
    n_layers: int    # 0 without an MLP
    n_params: int
    width: int       # 32 or 64 with an MLP, 0 without
    out_meta: ctypes.Array
    in_meta: object  # ctypes.Array, or None without an MLP
    mlp_widths: object


def splat_launch_args(cfg: _SplatCfg, geom, diff, kernel: str):
    """Check that the splat kernels take these inputs (device, types,
    shapes, grid and MLP layout) and raise on what they do not run.  As
    ``renderer_fw.launch_args``, nothing is read back from the device: an
    out-of-range ``grid_idx`` splats nothing, and
    ``LIGHTPLANE_CHECK_GRID_IDX=1`` raises for it."""
    directions, origins, near, far, grid_idx = geom
    encoding, input_grid_flat, mlp_params = diff
    device = directions.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {device}")
    R = directions.shape[0]
    C = cfg.out_chn
    f32, i32 = torch.float32, torch.int32
    _check(directions, "directions", f32, (R, 3), device)
    _check(origins, "origins", f32, (R, 3), device)
    _check(near, "near", f32, (R,), device)
    _check(far, "far", f32, (R,), device)
    _check(grid_idx, "grid_idx", i32, (R,), device)
    out_meta = _grid_meta(cfg.output_grid_sizes, cfg.v_total, C,
                          "the output grid-list")
    batches = [gs[0] for gs in cfg.output_grid_sizes]

    n_layers = len(cfg.n_hidden) - 1 if cfg.n_hidden else 0
    C_in = n_params = width = 0
    in_meta = widths = None
    if n_layers:
        C_in = cfg.n_hidden[0]
        n_params = _mlp_numel(cfg.n_hidden)
        if not 1 <= n_layers <= MAX_LAYERS:
            raise ValueError(
                f"the CUDA splatter takes MLPs of 1..{MAX_LAYERS} layers")
        widest = max(cfg.n_hidden)
        width = next((w for w in WIDTHS if widest <= w), None)
        if width is None:
            raise ValueError(
                f"the CUDA splatter takes MLP widths up to {WIDTHS[-1]}, "
                f"got {widest}")
        _check(encoding, "encoding", f32, (R, C_in), device)
        V_in = input_grid_flat.shape[0]
        _check(input_grid_flat, "input_grid_flat", f32, (V_in, C_in), device)
        _check(mlp_params, "mlp_params", f32, (n_params,), device)
        in_meta = _grid_meta(cfg.input_grid_sizes, V_in, C_in,
                             "the input grid-list")
        batches += [gs[0] for gs in cfg.input_grid_sizes]
        widths = (ctypes.c_int * len(cfg.n_hidden))(*cfg.n_hidden)
    else:
        _check(encoding, "encoding", f32, (R, C), device)
    guards.check_grid_idx(grid_idx, min(batches), kernel)
    return SplatLaunchArgs(
        device=device, R=R, C=C, C_in=C_in, n_layers=n_layers,
        n_params=n_params, width=width, out_meta=out_meta, in_meta=in_meta,
        mlp_widths=widths,
    )


def _ptr(t):
    return None if t is None else t.data_ptr()


def splat_fwd_cuda(cfg: _SplatCfg, geom, diff, defines=()):
    """Launch the splat forward kernel on the current CUDA stream.
    ``defines`` pick a variant build of the kernel (``_build.library``)."""
    global LAUNCHES
    directions, origins, near, far, grid_idx = geom
    a = splat_launch_args(cfg, geom, diff, "splat_fwd_cuda")
    encoding, input_grid_flat, mlp_params = (aligned(t) for t in diff)

    from ._build import library

    lib = library(defines)
    if a.n_layers:
        smem = lib.lightplane_splat_fw_smem_bytes(a.width, a.n_layers)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(
                f"the splatter MLP needs {smem} bytes of shared memory per "
                f"block, more than the {MAX_SMEM_BYTES} a Hopper block has")
    feat = torch.zeros((cfg.v_total, a.C), dtype=torch.float32,
                       device=a.device)
    w = torch.zeros((cfg.v_total, 1), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.lightplane_splat_fw(
        origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
        far.data_ptr(), grid_idx.data_ptr(), encoding.data_ptr(),
        _ptr(input_grid_flat), _ptr(mlp_params),
        feat.data_ptr(), w.data_ptr(),
        a.R, len(cfg.output_grid_sizes), a.out_meta, a.C,
        len(cfg.input_grid_sizes or ()), a.in_meta, a.C_in,
        a.n_layers, a.mlp_widths, a.width,
        cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf,
        int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
        stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(f"splatter_fw kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return feat, w


def splat_fwd(cfg: _SplatCfg, geom, diff, impl: str = "auto"):
    """Splat forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (``impl="auto"``); ``impl="cuda"`` raises for CPU tensors
    and ``impl="torch"`` asks for the plain version explicitly."""
    if check_impl(impl, geom[0].is_cuda, geom[0].device):
        return splat_fwd_torch(cfg, geom, diff)
    return splat_fwd_cuda(cfg, geom, diff)
