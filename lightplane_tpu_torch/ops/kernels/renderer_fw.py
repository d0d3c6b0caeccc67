"""The renderer's forward-march kernel: its wrapper, its plain PyTorch
version and the dispatch between them.

``render_fwd_cuda`` launches ``csrc/renderer_fw.cu`` (which replaces
``lightplane_tpu/ops/kernels/renderer_pallas.py::_build_fw_kernel``);
``render_fwd_torch`` is the same march as a plain PyTorch loop over steps
(the port of the JAX scan core ``_render_fwd_impl``).  ``render_fwd`` sends
CUDA tensors to the kernel and CPU tensors to the plain version; there is
no fallback from one to the other.

Every function takes ``(cfg, geom, diff)`` as in the JAX package:
``geom = (directions, origins, near, far, grid_idx, scaffold, noise_seed)``
and ``diff = (grid_flat, color_grid_flat, mlp_params, rays_encoding)``, and
returns ``(depth [R], nlt [R], feat [R, cfg.out_chn])``.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid_sample import grid_row_offsets
from ..mlp_utils import _mlp_numel
from ..renderer import _march, _RenderCfg

IMPLS = ("auto", "cuda", "torch")

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it, so a caller can reset it and show that
# a run went through the kernel.
LAUNCHES = 0

MAX_GRIDS = 8          # kMaxGrids in renderer_fw.cu
MAX_LAYERS = 8         # kMaxLayers in renderer_fw.cu (per MLP)
WIDTHS = (32, 64)      # the kernel's compiled activation widths
MAX_SMEM_BYTES = 232448  # 227 KB, a Hopper block's shared-memory limit


def render_fwd_torch(cfg: _RenderCfg, geom, diff):
    """Plain PyTorch forward march over all steps; memory O(R)."""
    nlt = geom[2].new_zeros(geom[0].shape[0])
    return _march(cfg, geom, diff, range(cfg.tot_num_samples), nlt)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_width(cfg: _RenderCfg, grid_chn: int) -> int:
    widest = max(
        (grid_chn,) + cfg.n_hidden_trunk + cfg.n_hidden_opacity
        + cfg.n_hidden_color
    )
    for w in WIDTHS:
        if widest <= w:
            return w
    raise ValueError(
        f"the CUDA renderer takes channel and MLP widths up to {WIDTHS[-1]}, "
        f"got {widest}"
    )


def render_fwd_cuda(cfg: _RenderCfg, geom, diff):
    """Launch the forward-march kernel on the current CUDA stream."""
    global LAUNCHES
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    grid_flat, color_grid_flat, mlp_params, rays_encoding = diff
    if color_grid_flat is not None:
        raise NotImplementedError(
            "the separate color grid (relu-field) branch of the CUDA renderer "
            "is not ported yet (ROADMAP queue 2, R1 relu-field branch)"
        )
    if scaffold is not None:
        raise NotImplementedError(
            "scaffold gating in the CUDA renderer is not ported yet "
            "(ROADMAP queue 2, R3)"
        )
    if torch.is_grad_enabled() and any(
        t.requires_grad
        for t in (directions, origins, near, far, grid_flat, mlp_params,
                  rays_encoding)
    ):
        raise NotImplementedError(
            "the CUDA renderer has no backward yet: the backward kernel (R2) "
            "is a later PR; render under torch.no_grad() or "
            "torch.inference_mode()"
        )

    device = directions.device
    if device.type != "cuda":
        raise ValueError(f"render_fwd_cuda needs CUDA tensors, got {device}")
    R = directions.shape[0]
    V, C = grid_flat.shape
    n_t = max(len(cfg.n_hidden_trunk) - 1, 0)
    n_o = len(cfg.n_hidden_opacity) - 1
    n_c = len(cfg.n_hidden_color) - 1
    C_enc = cfg.n_hidden_color[0]
    color_chn = cfg.out_chn
    f32, i32 = torch.float32, torch.int32
    _check(directions, "directions", f32, (R, 3), device)
    _check(origins, "origins", f32, (R, 3), device)
    _check(near, "near", f32, (R,), device)
    _check(far, "far", f32, (R,), device)
    _check(grid_idx, "grid_idx", i32, (R,), device)
    _check(rays_encoding, "rays_encoding", f32, (R, C_enc), device)
    _check(grid_flat, "grid_flat", f32, (V, C), device)
    _check(mlp_params, "mlp_params", f32, (mlp_params.numel(),), device)

    head_in = cfg.n_hidden_trunk[-1] if n_t else C
    if n_t and cfg.n_hidden_trunk[0] != C:
        raise ValueError("the trunk MLP input width must equal the grid's")
    if cfg.n_hidden_opacity[0] != head_in or C_enc != head_in:
        raise ValueError(
            "the opacity and color MLP inputs must be as wide as the trunk "
            "output"
        )
    if not 1 <= len(cfg.grid_sizes) <= MAX_GRIDS:
        raise ValueError(f"the CUDA renderer takes 1..{MAX_GRIDS} sub-grids")
    if min(n_o, n_c) < 1 or max(n_t, n_o, n_c) > MAX_LAYERS:
        raise ValueError(
            f"the CUDA renderer takes MLPs of 1..{MAX_LAYERS} layers "
            "(0 for the trunk)"
        )
    if not 1 <= color_chn <= cfg.n_hidden_color[-1]:
        raise ValueError(f"bad rendered channel count {color_chn}")
    n_params = sum(map(_mlp_numel, (cfg.n_hidden_trunk, cfg.n_hidden_opacity,
                                    cfg.n_hidden_color)))
    if mlp_params.numel() != n_params:
        raise ValueError(
            f"mlp_params has {mlp_params.numel()} values, the MLP widths "
            f"need {n_params}"
        )
    if V * C >= 2**31:
        raise ValueError("grid too large for int32 offsets")
    width = _kernel_width(cfg, C)

    from ._build import library

    lib = library()
    smem = lib.lightplane_render_fw_smem_bytes(width, n_t + n_o + n_c,
                                               color_chn)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"the MLP weights need {smem} bytes of shared memory per block, "
            f"more than the {MAX_SMEM_BYTES} a Hopper block can have"
        )

    offsets = grid_row_offsets(cfg.grid_sizes)
    if offsets[-1] != V or any(gs[-1] != C for gs in cfg.grid_sizes):
        raise ValueError("grid_sizes do not match the flat grid")
    if R:
        # the kernel gathers rows of sub-grid batch grid_idx[ray]: an index
        # outside every sub-grid's batch would read outside the grid
        lo, hi = (int(v) for v in torch.aminmax(grid_idx))
        if lo < 0 or hi >= min(gs[0] for gs in cfg.grid_sizes):
            raise ValueError(f"grid_idx out of range: [{lo}, {hi}]")
    meta = []
    for gs, off in zip(cfg.grid_sizes, offsets):
        meta += [off, gs[0], gs[1], gs[2], gs[3]]
    meta_c = (ctypes.c_int * len(meta))(*meta)
    widths = cfg.n_hidden_trunk + cfg.n_hidden_opacity + cfg.n_hidden_color
    widths_c = (ctypes.c_int * len(widths))(*widths)

    depth = torch.empty((R,), dtype=f32, device=device)
    nlt = torch.empty((R,), dtype=f32, device=device)
    feat = torch.empty((R, color_chn), dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.lightplane_render_fw(
        origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
        far.data_ptr(), grid_idx.data_ptr(), rays_encoding.data_ptr(),
        grid_flat.data_ptr(), mlp_params.data_ptr(),
        depth.data_ptr(), nlt.data_ptr(), feat.data_ptr(),
        R, len(cfg.grid_sizes), meta_c, C,
        n_t, n_o, n_c, widths_c,
        C_enc, color_chn, width,
        cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf, cfg.gain,
        int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
        cfg.inject_noise_sigma, int(noise_seed), cfg.noise_stride,
        cfg.num_rays_noise,
        stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(f"renderer_fw kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return depth, nlt, feat


def render_fwd(cfg: _RenderCfg, geom, diff, impl: str = "auto"):
    """Forward march: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (``impl="auto"``); ``impl="cuda"`` raises for CPU
    tensors and ``impl="torch"`` asks for the plain version explicitly."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    on_cuda = geom[0].is_cuda
    if impl == "torch" or (impl == "auto" and not on_cuda):
        return render_fwd_torch(cfg, geom, diff)
    if not on_cuda:
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got {geom[0].device}"
        )
    return render_fwd_cuda(cfg, geom, diff)
