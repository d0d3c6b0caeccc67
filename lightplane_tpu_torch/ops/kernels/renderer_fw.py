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
import dataclasses
import math
from typing import Optional

import torch

from .. import guards
from ..grid_sample import grid_row_offsets
from ..mlp_utils import _mlp_numel
from ..renderer import _march, _RenderCfg

IMPLS = ("auto", "cuda", "torch")

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it, so a caller can reset it and show that
# a run went through the kernel.  SCAFFOLD_LAUNCHES counts the launches that
# were passed a scaffold (the occupancy gate), in the same way.
LAUNCHES = 0
SCAFFOLD_LAUNCHES = 0

MAX_GRIDS = 8          # kMaxGrids in march_common.cuh
MAX_LAYERS = 8         # kMaxLayers in march_common.cuh (per MLP)
WIDTHS = (32, 64)      # the kernel's compiled activation widths
MAX_SMEM_BYTES = 232448  # 227 KB, a Hopper block's shared-memory limit
# Warps (one ray each) per block the forward kernel may take, most first:
# each warp keeps two [32, W + 4] tiles in shared memory beside the MLP.
WARPS_PER_BLOCK = (4, 2, 1)


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _grid_table(grid_sizes, V: int, C: int, name: str) -> ctypes.Array:
    """The kernels' table of a flat grid-list's sub-grids: (row offset, B,
    D, H, W) each; raises where the sizes do not describe ``[V, C]``."""
    if not 1 <= len(grid_sizes) <= MAX_GRIDS:
        raise ValueError(f"the CUDA renderer takes 1..{MAX_GRIDS} sub-grids "
                         f"per {name}")
    if V * C >= 2**31:
        raise ValueError(f"{name} too large for int32 offsets")
    offsets = grid_row_offsets(grid_sizes)
    if offsets[-1] != V or any(gs[-1] != C for gs in grid_sizes):
        raise ValueError(f"{name} sizes do not match the flat {name}")
    meta = []
    for gs, off in zip(grid_sizes, offsets):
        meta += [off, gs[0], gs[1], gs[2], gs[3]]
    return (ctypes.c_int * len(meta))(*meta)


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


@dataclasses.dataclass(frozen=True)
class LaunchArgs:
    """What both march kernels take besides the tensors: sizes, the
    padded width and the host-side tables of grid shapes and MLP widths."""

    device: torch.device
    R: int
    C: int
    n_t: int
    n_o: int
    n_c: int
    C_enc: int
    color_chn: int
    width: int
    grid_meta: ctypes.Array
    mlp_widths: ctypes.Array
    # the scaffold's (B, D, H, W), or None
    scaffold_dims: Optional[ctypes.Array]
    # the colour grid-list's sub-grid count and table, or (0, None)
    num_color_grids: int
    color_grid_meta: Optional[ctypes.Array]

    @property
    def n_layers(self) -> int:
        return self.n_t + self.n_o + self.n_c

    def extras(self, scaffold, color_grid_flat):
        """The kernels' trailing arguments: the scaffold and its shape, the
        colour grid-list and its table (null pointers for none)."""
        return (_ptr(scaffold), self.scaffold_dims, _ptr(color_grid_flat),
                self.num_color_grids, self.color_grid_meta)


def launch_args(cfg: _RenderCfg, geom, diff, kernel: str) -> LaunchArgs:
    """Check that the march kernels take these inputs (device, types,
    shapes, MLP and grid layout, the scaffold and the colour grid) and raise
    on what they do not run.  Nothing is read back from the device: a ray
    whose ``grid_idx`` lies outside every grid's batch samples nothing in
    the kernels, and ``LIGHTPLANE_CHECK_GRID_IDX=1`` raises for it
    (``guards.check_grid_idx``)."""
    directions, origins, near, far, grid_idx, scaffold, _ = geom
    grid_flat, color_grid_flat, mlp_params, rays_encoding = diff
    device = directions.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {device}")
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
    # the kernels read grid rows as float4 when C % 4 == 0
    if C % 4 == 0 and any(t is not None and t.data_ptr() % 16
                          for t in (grid_flat, color_grid_flat)):
        raise ValueError("the CUDA renderer needs 16-byte aligned grids")

    head_in = cfg.n_hidden_trunk[-1] if n_t else C
    if n_t and cfg.n_hidden_trunk[0] != C:
        raise ValueError("the trunk MLP input width must equal the grid's")
    if cfg.n_hidden_opacity[0] != head_in or C_enc != head_in:
        raise ValueError(
            "the opacity and color MLP inputs must be as wide as the trunk "
            "output"
        )
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
    width = _kernel_width(cfg, C)
    grid_meta = _grid_table(cfg.grid_sizes, V, C, "grid")
    batches = [gs[0] for gs in cfg.grid_sizes]

    color_meta = None
    if color_grid_flat is not None:
        # relu-field: the colour grid is sampled at the grid's points, with
        # the grid's channel count, and there is no trunk MLP
        if n_t:
            raise ValueError("a separate color grid takes no trunk MLP")
        Vc = color_grid_flat.shape[0]
        _check(color_grid_flat, "color_grid_flat", f32, (Vc, C), device)
        color_meta = _grid_table(cfg.color_grid_sizes, Vc, C, "color grid")
        batches += [gs[0] for gs in cfg.color_grid_sizes]
    scaffold_dims = None
    if scaffold is not None:
        if cfg.scaffold_size is None or len(cfg.scaffold_size) != 4:
            raise ValueError("the scaffold must be [B, D, H, W]")
        _check(scaffold, "scaffold", f32, (math.prod(cfg.scaffold_size), 1),
               device)
        scaffold_dims = (ctypes.c_int * 4)(*cfg.scaffold_size)
        batches.append(cfg.scaffold_size[0])
    guards.check_grid_idx(grid_idx, min(batches), kernel)
    widths = cfg.n_hidden_trunk + cfg.n_hidden_opacity + cfg.n_hidden_color
    return LaunchArgs(
        device=device, R=R, C=C, n_t=n_t, n_o=n_o, n_c=n_c, C_enc=C_enc,
        color_chn=color_chn, width=width, grid_meta=grid_meta,
        mlp_widths=(ctypes.c_int * len(widths))(*widths),
        scaffold_dims=scaffold_dims,
        num_color_grids=0 if color_meta is None else len(cfg.color_grid_sizes),
        color_grid_meta=color_meta,
    )


def pick_warps_per_block(smem_bytes, max_smem: int = MAX_SMEM_BYTES):
    """The forward kernel's warps per block, given ``smem_bytes[w]``, the
    shared memory a block of ``w`` warps needs: the most of
    ``WARPS_PER_BLOCK`` that fit in ``max_smem``, None where none does.
    Four warps fit every MLP of width 32 the kernel takes (24 layers: 127
    KB); width-64 MLPs take four up to 11 layers in all and fewer beyond,
    down to one (14 layers).  More warps were faster on an H100
    (``chip_smoke.py --ablate R1``, PERF.md): at the render headline and
    the trainer's shape four took 8.109 and 0.607 ms, two 9.735 and 0.776,
    one 13.581 and 1.012; eight, on an earlier build, were slower than four
    (12.67 against 10.95 ms at the headline: fewer blocks fit an SM)."""
    return next((w for w in WARPS_PER_BLOCK if smem_bytes[w] <= max_smem),
                None)


def render_fwd_cuda(cfg: _RenderCfg, geom, diff, defines=(),
                    warps_per_block=None):
    """Launch the forward-march kernel on the current CUDA stream.
    ``defines`` pick a variant build of the kernel (``_build.library``);
    ``warps_per_block`` (of ``WARPS_PER_BLOCK``) overrides
    ``pick_warps_per_block``."""
    global LAUNCHES, SCAFFOLD_LAUNCHES
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    grid_flat, color_grid_flat, mlp_params, rays_encoding = diff
    a = launch_args(cfg, geom, diff, "render_fwd_cuda")

    from ._build import library

    lib = library(defines)
    smem = {w: lib.lightplane_render_fw_smem_bytes(a.width, a.n_layers,
                                                   a.color_chn, w)
            for w in WARPS_PER_BLOCK}
    warps = warps_per_block or pick_warps_per_block(smem)
    if warps is None:
        raise ValueError(
            f"the MLP weights need {smem[1]} bytes of shared memory per "
            f"block of one warp, more than the {MAX_SMEM_BYTES} a Hopper "
            f"block can have"
        )
    if smem.get(warps, MAX_SMEM_BYTES + 1) > MAX_SMEM_BYTES:
        raise ValueError(f"warps_per_block must be one of {WARPS_PER_BLOCK} "
                         f"and fit in shared memory, got {warps}")

    f32 = torch.float32
    depth = torch.empty((a.R,), dtype=f32, device=a.device)
    nlt = torch.empty((a.R,), dtype=f32, device=a.device)
    feat = torch.empty((a.R, a.color_chn), dtype=f32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.lightplane_render_fw(
        origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
        far.data_ptr(), grid_idx.data_ptr(), rays_encoding.data_ptr(),
        grid_flat.data_ptr(), mlp_params.data_ptr(),
        depth.data_ptr(), nlt.data_ptr(), feat.data_ptr(),
        a.R, len(cfg.grid_sizes), a.grid_meta, a.C,
        a.n_t, a.n_o, a.n_c, a.mlp_widths,
        a.C_enc, a.color_chn, a.width, warps,
        cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf, cfg.gain,
        int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
        cfg.inject_noise_sigma, int(noise_seed), cfg.noise_stride,
        cfg.num_rays_noise,
        *a.extras(scaffold, color_grid_flat),
        stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(f"renderer_fw kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    SCAFFOLD_LAUNCHES += scaffold is not None
    return depth, nlt, feat


def check_impl(impl: str, on_cuda: bool, device) -> bool:
    """Whether ``impl`` takes the plain version for tensors on ``device``;
    raises for an unknown ``impl`` and for ``impl="cuda"`` on the CPU."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "torch" or (impl == "auto" and not on_cuda):
        return True
    if not on_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {device}")
    return False


def render_fwd(cfg: _RenderCfg, geom, diff, impl: str = "auto"):
    """Forward march: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (``impl="auto"``); ``impl="cuda"`` raises for CPU
    tensors and ``impl="torch"`` asks for the plain version explicitly."""
    if check_impl(impl, geom[0].is_cuda, geom[0].device):
        return render_fwd_torch(cfg, geom, diff)
    return render_fwd_cuda(cfg, geom, diff)
