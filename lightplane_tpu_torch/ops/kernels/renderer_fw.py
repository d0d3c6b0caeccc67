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

MAX_GRIDS = 16         # kMaxGrids in march_common.cuh
MAX_LAYERS = 16        # kMaxLayers in march_common.cuh (per MLP)
# The kernels' compiled activation widths: 32 and 64 keep the MLP's layers
# in shared memory, 96 to 768 (the wide builds, csrc/renderer_wide.cuh and
# csrc/wide_mlp.cuh) stage them a slice at a time; past 256 each product in
# N-parts of at most WIDE_PART_TILES N-tiles (the splatter MLP's builds are
# the same: splatter_fw.MLP_WIDTHS)
WIDTHS = (32, 64, 96, 128, 192, 256, 384, 512, 768)
MAX_SMEM_BYTES = 232448  # 227 KB, a Hopper block's shared-memory limit
# Warps (one ray each) per block the forward kernel may take, most first:
# each warp keeps two [32, W + 4] tiles in shared memory beside the MLP.
WARPS_PER_BLOCK = (4, 2, 1)

# The wide builds (csrc/renderer_wide.cuh, csrc/wide_mlp.cuh): a block's
# warps march a ray each in lockstep, WIDE_CHUNK steps at a time, each
# product's layer staged for the whole block in a ring of WIDE_RING_SLOTS
# shared-memory slots of WIDE_SLICE_STEPS k-steps of 8 by up to
# WIDE_SLOT_TILES N-tiles (a wider product, past W = 128, one k-step a
# slot; packed once a launch as wgmma's K-major core matrices, split into
# TF32 hi and lo: pack_wide_torch) and multiplied by wgmma a warpgroup (4
# warps) at a time.  The forward takes WIDE_FW_WARPS warps a block where
# they fit (``wide_fw_warps``), two [WIDE_CHUNK, W + 4] tiles each.
WIDE_CHUNK = 16
WIDE_SLICE_STEPS = 2
WIDE_SLOT_TILES = 16
WIDE_RING_SLOTS = 3
WIDE_FW_WARPS = 8
# Past W = 256 a product runs in N-parts of up to WIDE_PART_TILES N-tiles
# (256 columns: a slot's k-step, 128 accumulators a thread), and the parts
# but the last of one that overwrites its own input wait in a warp's stash
# in device memory, WIDE_STASH_FLOATS a part (``wide_stash_floats``;
# csrc/wide_mlp.cuh::staged_rows_parts)
WIDE_PART_TILES = 32
WIDE_STASH_FLOATS = WIDE_PART_TILES * 4 * 32


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
    """The padded activation width the kernels run at: the narrowest of
    ``WIDTHS`` that holds the grid's channels and every MLP layer (a width
    between two is zero-padded up); raises above the widest."""
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

    def layers(self):
        """Each layer's (d_in, d_out, weight offset, bias offset)."""
        return wide_layers(self.n_t, self.n_o, self.n_c,
                           list(self.mlp_widths))

    def products(self, backward: bool):
        """The wide kernels' products of a chunk (``wide_products``)."""
        return wide_products(self.layers(), self.n_t, self.n_o, backward)

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


def wide_ring_bytes(width: int) -> int:
    """Bytes of the wide builds' ring of layer slices at ``width``: three
    slots of two k-steps of ``width / 8`` N-tiles (at most WIDE_SLOT_TILES)
    of 32 lanes' 16 bytes."""
    tiles = min(width // 8, WIDE_SLOT_TILES)
    return 16 * WIDE_RING_SLOTS * WIDE_SLICE_STEPS * tiles * 32


def wide_slice_steps(n_tiles: int) -> int:
    """k-steps a ring slice of a product (or an N-part) of ``n_tiles``
    N-tiles holds: WIDE_SLICE_STEPS up to WIDE_SLOT_TILES N-tiles, else
    one."""
    return 1 if n_tiles > WIDE_SLOT_TILES else WIDE_SLICE_STEPS


def wide_parts(n_tiles: int):
    """The N-tiles of each N-part of a product of ``n_tiles`` N-tiles:
    WIDE_PART_TILES each, the last the rest (one part up to W = 256)."""
    return [min(WIDE_PART_TILES, n_tiles - q)
            for q in range(0, n_tiles, WIDE_PART_TILES)]


def wide_stash_floats(width: int) -> int:
    """Floats of a warp's stash at ``width``: WIDE_STASH_FLOATS for each
    N-part but the last of a product ``width`` wide (one at 384 and 512,
    two at 768), none up to 256 (``csrc/wide_mlp.cuh::stash_floats``)."""
    return (len(wide_parts(width // 8)) - 1) * WIDE_STASH_FLOATS


def wide_fw_warps(width: int) -> int:
    """The wide forward's warps a block: WIDE_FW_WARPS (two warpgroups)
    where their tiles fit with the ring (W = 96, 128), else one warpgroup
    (W = 192, 256), else the most that fit (3 at W = 384, 2 at 512, 1 at
    768)."""
    if wide_fw_smem_bytes(width, WIDE_FW_WARPS) <= MAX_SMEM_BYTES:
        return WIDE_FW_WARPS
    return next(w for w in (4, 3, 2, 1)
                if wide_fw_smem_bytes(width, w) <= MAX_SMEM_BYTES)


def wide_fw_scratch_bytes(width: int, warps: Optional[int] = None) -> int:
    """A block's scratch in device memory in the wide forward: past W =
    256 a stash (``wide_stash_floats``) a warp, else none."""
    warps = warps or wide_fw_warps(width)
    return 4 * warps * wide_stash_floats(width)


def wide_fw_smem_bytes(width: int, warps: Optional[int] = None) -> int:
    """Shared memory of a block of ``warps`` warps (``wide_fw_warps`` by
    default) of the wide forward: each warp's two [WIDE_CHUNK, width + 4]
    f32 tiles, then the ring."""
    warps = warps or wide_fw_warps(width)
    return 4 * warps * 2 * WIDE_CHUNK * (width + 4) + wide_ring_bytes(width)


def wide_layers(n_t: int, n_o: int, n_c: int, widths):
    """``(d_in, d_out, weight offset, bias offset)`` of each layer of the
    three MLPs in the flat parameter vector, as
    ``csrc/march_common.cuh::fill_layers`` lays them out: each MLP's
    weights, then its biases."""
    layers, at, off = [], 0, 0
    for count in (n_t, n_o, n_c):
        nh = widths[at:at + count + 1]
        w_off = off
        b_off = off + sum(nh[k] * nh[k + 1] for k in range(count))
        for k in range(count):
            layers.append((nh[k], nh[k + 1], w_off, b_off))
            w_off += nh[k] * nh[k + 1]
            b_off += nh[k + 1]
        off = b_off
        at += count + (count > 0)
    return layers


def wide_products(layers, n_t: int, n_o: int, backward: bool):
    """The products of a chunk in the order the wide kernels run them
    (``csrc/wide_mlp.cuh::wide_product``): ``(layer, transposed, k_steps,
    n_tiles)``, the relu layers of the forward (layer j below the opacity
    head's last, j + 1 past it), past W = 256 the colour head's last layer
    (``wide_head_product``), then with ``backward`` every layer's input
    gradient (its transpose), last layer first."""
    n_total = len(layers)
    opacity_end = n_t + n_o - 1
    fwd = n_total - 2 + wide_head_product(layers)
    out = []
    for i in range(fwd + (n_total if backward else 0)):
        transposed = i >= fwd
        if transposed:
            layer = n_total - 1 - (i - fwd)
        else:
            layer = i if i < opacity_end else i + 1
        d_in, d_out = layers[layer][:2]
        k, n = (d_out, d_in) if transposed else (d_in, d_out)
        out.append((layer, transposed, -(-k // 8), -(-n // 8)))
    return out


def wide_head_product(layers) -> bool:
    """Whether R1 and R2 run the colour head's last layer as a product
    (``csrc/wide_mlp.cuh::wide_head_product``): past W = 256, where its
    outputs, the rendered channels (up to W), are too many for a lane's
    dot products."""
    return max(max(d_in, d_out) for d_in, d_out, _, _ in layers) > 256


def wide_slices(products) -> int:
    """Ring slices of a chunk's products: each N-part's k-steps,
    ``wide_slice_steps`` of them a slice."""
    return sum(-(-ks // wide_slice_steps(pt)) for _, _, ks, nt in products
               for pt in wide_parts(nt))


def wide_pack_bytes(products) -> int:
    """Bytes of the wide kernels' packed layers: an int2 a ring slice (two
    k-steps of a product, one past WIDE_SLOT_TILES N-tiles; a slice of one
    N-part past WIDE_PART_TILES), then each product's 32 lanes' uint4 a
    k-step and N-tile."""
    return 16 * (-(-wide_slices(products) // 2)
                 + sum(ks * nt * 32 for _, _, ks, nt in products))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 bits of the result are 0."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    bits = ((bits + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def pack_wide_torch(mlp_params: torch.Tensor, layers, products):
    """The plain version of the wide kernels' pre-pass
    (``csrc/renderer_wide.cuh::pack_wide_kernel``): their workspace as int32
    ``[wide_pack_bytes / 16, 4]``.  First the schedule, an int2 a ring
    slice (its first row, its rows); then per product and k-step of 8 the
    hi part, then the lo part of B (the layer's ``[d_in, d_out]`` weights,
    or their transpose; 0 past them), hi = ``tf32_round(b)`` and lo = b -
    hi (so hi + lo == b): each part, per N-tile j of 8 and k-half h, a
    core matrix of ``wgmma``'s K-major layout, row r = ``B[8 ks + 4 h +
    (0..3), 8 j + r]`` (16 bytes), core 2 j + h.  A product of more than
    WIDE_PART_TILES N-tiles is laid out N-part by N-part (``wide_parts``),
    each as a product of its own N-tiles, its slices after the last
    part's."""
    w_all = mlp_params.detach().to(torch.float32).reshape(-1)
    head = -(-wide_slices(products) // 2)
    out = torch.zeros((wide_pack_bytes(products) // 16, 4),
                      dtype=torch.int32, device=w_all.device)
    sched, at = [], head
    for layer, transposed, ks, nt in products:
        d_in, d_out, w_off = layers[layer][:3]
        w = w_all[w_off:w_off + d_in * d_out].reshape(d_in, d_out)
        b = w.t() if transposed else w
        padded = torch.zeros((8 * ks, 8 * nt), dtype=torch.float32,
                             device=w_all.device)
        padded[:b.shape[0], :b.shape[1]] = b
        for q, pt in enumerate(wide_parts(nt)):
            part = padded[:, 8 * WIDE_PART_TILES * q:][:, :8 * pt]
            # k = 8 s + 4 h + c, n = 8 j + r -> [s][j][h][r][c]
            core = part.reshape(ks, 2, 4, pt, 8).permute(0, 3, 1, 4, 2)
            hi = tf32_round(core)
            lo = core - hi
            region = torch.stack([hi, lo], 1).view(torch.int32)
            n = ks * pt * 32
            out[at:at + n] = region.reshape(n, 4)
            steps = wide_slice_steps(pt)
            for k0 in range(0, ks, steps):
                sched.append((at + k0 * pt * 32,
                              min(steps, ks - k0) * pt * 32))
            at += n
    if sched:
        flat = out[:head].reshape(-1)
        flat[:2 * len(sched)] = torch.tensor(sched, dtype=torch.int32,
                                             device=w_all.device).reshape(-1)
    return out


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


def wide_config(lib, a):
    """The wide forward's ``(warps, shared-memory bytes, packed layers'
    bytes, blocks of the resident wave, a block's scratch bytes)`` as its C
    side plans them (``lightplane_render_fw_wide_config``)."""
    out = (ctypes.c_int * 5)()
    rc = lib.lightplane_render_fw_wide_config(a.width, a.n_t, a.n_o, a.n_c,
                                              a.mlp_widths, out)
    if rc != 0:
        raise ValueError(f"the wide forward does not take these widths "
                         f"({lib.lightplane_cuda_error_string(rc).decode()})")
    return tuple(out)


def render_fwd_cuda(cfg: _RenderCfg, geom, diff, defines=(),
                    warps_per_block=None, probe=None):
    """Launch the forward-march kernel on the current CUDA stream.
    ``defines`` pick a variant build of the kernel (``_build.library``);
    ``warps_per_block`` (of ``WARPS_PER_BLOCK``; 1..``WIDE_FW_WARPS`` that
    fit at the wide widths up to 256) overrides ``pick_warps_per_block``.
    ``probe``, for the wide builds' recording build only
    (``renderer_bw.RELU_MASKS_BUILD``): a zero-filled ``[R, steps, 2]`` f32
    tensor that gets each open step's raw opacity and the sum of its raw
    colours (``renderer_bw.forward_probes``)."""
    global LAUNCHES, SCAFFOLD_LAUNCHES
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    grid_flat, color_grid_flat, mlp_params, rays_encoding = diff
    a = launch_args(cfg, geom, diff, "render_fwd_cuda")

    from ._build import library

    lib = library(defines)
    workspace = None
    if a.width > 64:
        # the wide build: wide_fw_warps warps (or warps_per_block) in
        # lockstep over the layers staged in shared memory, packed into a
        # workspace by the launch's pre-pass; by wgmma where R2's plan at
        # these layers is whole warpgroups (and the warps are), so that R2's
        # recomputed forward gives R1's activations to the bit
        warps = warps_per_block or wide_fw_warps(a.width)
        if not (1 <= warps <= WIDE_FW_WARPS and wide_fw_smem_bytes(
                a.width, warps) <= MAX_SMEM_BYTES) or (
                a.width > 256 and warps != wide_fw_warps(a.width)):
            raise ValueError(f"warps_per_block must be 1..{WIDE_FW_WARPS} "
                             f"and fit in shared memory at width {a.width} "
                             f"(past 256 the plan's, for which the blocks' "
                             f"scratch is sized), got {warps}")
        conf = wide_config(lib, a)
        want = (wide_fw_warps(a.width), wide_fw_smem_bytes(a.width),
                wide_pack_bytes(a.products(False)))
        if conf[:3] != want or conf[4] != wide_fw_scratch_bytes(a.width):
            raise RuntimeError(f"the wide forward's plan {conf} is not the "
                               f"wrapper's")
        # the packed layers, then (past W = 256) each block's scratch
        workspace = torch.empty(((conf[2] + conf[3] * conf[4]) // 4,),
                                dtype=torch.int32, device=a.device)
    else:
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
            raise ValueError(f"warps_per_block must be one of "
                             f"{WARPS_PER_BLOCK} and fit in shared memory, "
                             f"got {warps}")

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
        _ptr(workspace),
        _ptr(probe),
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
