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

The relu masks.  Where a relu's input lies within rounding of 0, the kernel
and the plain version may take opposite branches and a gradient jumps by a
whole term.  To hold the kernel to the plain version on every ray, a
variant build of it (``render_bwd_cuda_relu_masks``) records the branch of
every unit of every relu'd vector at every (ray, step) as one bit, into an
int32 tensor ``[R, steps, vectors, width // 32]`` (``mask_shape``), and
``render_bwd_torch(..., relu_masks=)`` replays them: ``x * mask`` in place
of ``relu(x)``.  ``relu_masks_torch`` records the plain forward's own.
The same build of the wide kernels (widths 96-768) also writes a probe of
each open step's raw opacity and raw colours, in the forward march (R1)
and in the backward's recomputed forward alike, so that the two can be
held equal to the bit (``forward_probes``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..mlp_utils import _mlp_numel
from ..renderer import (
    _chunk_depth_delta,
    _chunk_noise,
    _chunk_steps,
    _plain_width,
    _RenderCfg,
    _step_decoder,
    _step_depth_delta,
    _step_noise,
    _step_points,
)
from .renderer_fw import (
    MAX_SMEM_BYTES,
    WIDE_CHUNK,
    _check,
    _kernel_width,
    _ptr,
    check_impl,
    launch_args,
    render_fwd_cuda,
    wide_pack_bytes,
    wide_ring_bytes,
    wide_stash_floats,
)

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it; SCAFFOLD_LAUNCHES, the launches that
# were passed a scaffold.
LAUNCHES = 0
SCAFFOLD_LAUNCHES = 0

# Rays per block the kernel may take, widest first: the block keeps every
# ray's activations in shared memory, so wide or deep MLPs take fewer rays.
RAYS_PER_BLOCK = (128, 64, 32)

# An SM's shared memory (228 KB on Hopper) and what the driver reserves of
# it per block, for pick_rays_per_block's count of blocks per SM
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024

# The build that records the relu masks (csrc/renderer_bw.cu)
RELU_MASKS_BUILD = ("LIGHTPLANE_RELU_MASKS=1",)

# The wide build (csrc/renderer_wide.cuh): the most warps (rays) a block
# takes (one past W = 256), and the bytes of their active flags after the
# ring
WIDE_BW_MAX_WARPS = 8
WIDE_FLAG_BYTES = 4 * WIDE_BW_MAX_WARPS


def mask_shape(cfg: _RenderCfg, R: int, grid_chn: int):
    """Shape of the relu masks of ``R`` rays: ``[R, steps, vectors, words]``
    with one bit per unit of the kernel's padded width (``WIDTHS``)."""
    n_t = max(len(cfg.n_hidden_trunk) - 1, 0)
    n_total = n_t + len(cfg.n_hidden_opacity) - 1 + len(cfg.n_hidden_color) - 1
    vectors = (n_total - 2 + (n_t == 0)
               + (cfg.color_grid_sizes is not None))
    return (R, cfg.tot_num_samples, vectors,
            _kernel_width(cfg, grid_chn) // 32)


_BITS = torch.arange(32, dtype=torch.int32)


def pack_masks(bits: torch.Tensor, words: int) -> torch.Tensor:
    """``[..., units]`` booleans as ``[..., words]`` int32, bit c of word w
    for unit 32 w + c (units past ``bits``' last are 0)."""
    bits = F.pad(bits.to(torch.int64), (0, 32 * words - bits.shape[-1]))
    bits = bits.reshape(*bits.shape[:-1], words, 32)
    v = (bits << _BITS.to(bits.device, torch.int64)).sum(-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def unpack_masks(words: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_masks``: ``[..., words]`` int32 as
    ``[..., 32 * words]`` 0/1 floats."""
    bits = (words[..., None] >> _BITS.to(words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1).float()


def relu_masks_torch(cfg: _RenderCfg, geom, diff):
    """The relu masks that the plain forward takes, in the kernel's layout
    (``mask_shape``)."""
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    R = directions.shape[0]
    shape = mask_shape(cfg, R, diff[0].shape[1])
    out = torch.zeros(shape, dtype=torch.int32, device=directions.device)
    for s in range(cfg.tot_num_samples):
        t, _ = _step_depth_delta(cfg, near, far, s)
        pts = _step_points(cfg, origins, directions, t)
        noise = (_step_noise(cfg, s, R, noise_seed, directions.device)
                 if cfg.inject_noise_sigma > 0.0 else None)

        def relu(k, x):
            out[:, s, k] = pack_masks(x > 0, shape[3])
            return F.relu(x)

        _step_decoder(cfg, pts, *diff, grid_idx, scaffold, noise, relu=relu)
    return out


def render_bwd_torch(cfg: _RenderCfg, geom, diff, nlt_final, g_out,
                     relu_masks=None):
    """Plain PyTorch reverse march; each step's decoder is differentiated by
    ``torch.autograd.grad`` (the per-step ``jax.vjp``), a chunk of steps
    (``renderer._chunk_steps``) at a time: the chunk's decoder is
    recomputed at once, the EA adjoint walks its steps far to near one by
    one, then one ``autograd.grad`` takes every step's cotangents.  Given
    ``relu_masks`` (``mask_shape``), each step's decoder applies them in
    place of its relus."""
    directions, origins, near, far, grid_idx, scaffold, noise_seed = geom
    g_depth, g_nlt, g_feat = g_out
    R = directions.shape[0]
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in diff]
    wrt = [t for t in leaves if t is not None]
    grads = [torch.zeros_like(t) for t in wrt]

    nlt_run = nlt_final
    suffix = torch.zeros_like(nlt_final)
    chunks = _chunk_steps(range(cfg.tot_num_samples), R,
                          _plain_width(cfg, diff), directions.is_cuda)
    for chunk in reversed(chunks):
        t, delta = _chunk_depth_delta(cfg, near, far, chunk)
        pts = _step_points(cfg, origins, directions, t)
        noise = _chunk_noise(cfg, chunk, R, noise_seed, directions.device)
        relu = {}
        if relu_masks is not None:
            m = unpack_masks(relu_masks[:, chunk[0]:chunk[-1] + 1]).to(
                nlt_final.dtype)
            relu = dict(relu=lambda k, x, m=m: x * m[:, :, k, : x.shape[-1]])
        with torch.enable_grad():
            sigma, color = _step_decoder(cfg, pts, *leaves, grid_idx,
                                         scaffold, noise, **relu)
            color = color[..., : cfg.out_chn]

        # transmittance rewind + EA adjoint, step by step far to near
        g_sigma = torch.empty_like(sigma)
        g_color = torch.empty_like(color)
        for j in reversed(range(len(chunk))):
            nlt_prev = nlt_run - sigma[:, j].detach() * delta[:, j]
            T = torch.exp(-nlt_run)          # T_s (includes step s)
            w = torch.exp(-nlt_prev) - T     # T_{s-1} - T_s
            g_w = g_depth * t[:, j] + (g_feat * color[:, j].detach()).sum(-1)
            g_s = g_w * T - suffix + g_nlt
            g_sigma[:, j] = g_s * delta[:, j]
            g_color[:, j] = w[:, None] * g_feat
            suffix = suffix + g_w * w
            nlt_run = nlt_prev
        d = torch.autograd.grad(
            (sigma, color), wrt, (g_sigma, g_color), allow_unused=True,
        )
        for acc, di in zip(grads, d):
            if di is not None:
                acc += di

    it = iter(grads)
    return tuple(None if t is None else next(it) for t in leaves)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pick_rays_per_block(num_rays: int, smem_bytes, num_sms: int,
                        max_smem: int = MAX_SMEM_BYTES):
    """The kernel's block size for ``num_rays`` rays, given ``smem_bytes[r]``,
    the shared memory a block of ``r`` rays needs, and the card's SM count;
    None where no size of ``RAYS_PER_BLOCK`` fits in ``max_smem``.

    The rule: the fewest waves, a wave being as many blocks as the SMs hold
    at once (each SM as many as fit in its shared memory, SM_SMEM_BYTES
    less BLOCK_RESERVED_BYTES per block, which binds before the registers
    do); of the sizes with the fewest, 64 rays, else 32, else 128.

    Why, from R2 timed at each size with the scene fitter's model on an H100
    (132 SMs, 700 W; ``chip_smoke.py`` phase 9, PERF.md): one block of
    128 or 64 rays fits per SM, and two of 32.  A ray's steps run in order
    on one thread, so the kernel takes about one ray's serial time per wave
    whatever the block count: 11.9-12.0 / 11.0-11.1 / 11.1 ms at 128 / 64 /
    32 rays per block for 4096 rays (one wave each), 12.2 / 11.8 / 12.0-12.1
    ms for 8192 (one wave each), and 12.7-12.9 ms at 128 rays for 16384
    (128 blocks, one wave) against 20.5-21.2 ms at 64 or 32 (two waves).
    At equal waves, 64-ray blocks were the fastest or tied in two runs.
    The render headline's 65,536 rays keep 128 (4 waves, against 8)."""
    fits = [r for r in RAYS_PER_BLOCK if smem_bytes[r] <= max_smem]

    def waves(r):
        blocks = -(-num_rays // r)
        per_sm = max(1, SM_SMEM_BYTES // (smem_bytes[r]
                                          + BLOCK_RESERVED_BYTES))
        return -(-blocks // (num_sms * per_sm))

    if not fits:
        return None
    least = min(map(waves, fits))
    return next(r for r in (64, 32, 128) if r in fits and waves(r) == least)


def block_smem_bytes(lib, a, has_color_grid: bool):
    """The shared memory a block needs, by rays per block, for the inputs
    of ``launch_args`` result ``a``."""
    return {r: lib.lightplane_render_bw_smem_bytes(
        a.width, r, a.n_layers, a.color_chn, int(has_color_grid))
        for r in RAYS_PER_BLOCK}


def wide_head_stride(layers, n_c: int) -> int:
    """Row stride of the wide backward's heads' tile (Gt): the heads' last
    layers' widest output rounded up to 8, plus 4."""
    head_out = max(layers[len(layers) - n_c - 1][1], layers[-1][1])
    return -(-head_out // 8) * 8 + 4


def wide_tile_floats(width: int, layers, n_c: int,
                     has_color_grid: bool) -> int:
    """Floats of one warp's layer-input tiles in the wide backward: a
    [WIDE_CHUNK, width + 4] tile for each layer input of the forward
    (``len(layers) - 1``, + 1 for a colour grid's sample, + 1 with a
    one-layer colour head)."""
    n_wide = len(layers) - 1 + int(has_color_grid) + int(n_c == 1)
    return n_wide * WIDE_CHUNK * (width + 4)


def wide_tiles_in_device_memory(width: int, layers, n_c: int,
                                has_color_grid: bool) -> bool:
    """Whether the wide backward's tiles lie in its block's scratch in
    device memory (``csrc/renderer_wide.cuh::BwLayout::dev``): past W = 256
    (one warp a block), where they and the encoding do not fit with the
    ring in a block's shared memory (the 2/2/2 decoder at 768, more than 8
    and 6 layers at 384 and 512)."""
    floats = wide_tile_floats(width, layers, n_c, has_color_grid) + width
    return width > 256 and wide_bw_smem_bytes(width, floats,
                                              1) > MAX_SMEM_BYTES


def wide_warp_floats(width: int, layers, n_c: int,
                     has_color_grid: bool) -> int:
    """Floats of one warp's region in the wide build's shared memory
    (``csrc/renderer_wide.cuh::bw_layout``): its tiles
    (``wide_tile_floats``), the heads' tile [WIDE_CHUNK,
    ``wide_head_stride``] (past W = 256 in device memory:
    ``wide_bw_scratch_bytes``) and the ray's encoding (``width``); the
    encoding alone where the tiles lie in device memory
    (``wide_tiles_in_device_memory``)."""
    if wide_tiles_in_device_memory(width, layers, n_c, has_color_grid):
        return width
    heads = 0 if width > 256 else WIDE_CHUNK * wide_head_stride(layers, n_c)
    return (wide_tile_floats(width, layers, n_c, has_color_grid) + heads
            + width)


def wide_bw_scratch_bytes(width: int, layers, n_c: int,
                          has_color_grid: bool) -> int:
    """A block's scratch in device memory in the wide backward: past W =
    256 (one warp a block) its stash (``wide_stash_floats``), its heads'
    tile and, where they lie in device memory, its tiles; else none."""
    if width <= 256:
        return 0
    tiles = (wide_tile_floats(width, layers, n_c, has_color_grid)
             if wide_tiles_in_device_memory(width, layers, n_c,
                                            has_color_grid) else 0)
    return 4 * (wide_stash_floats(width)
                + WIDE_CHUNK * wide_head_stride(layers, n_c) + tiles)


def wide_bw_smem_bytes(width: int, warp_floats: int, warps: int) -> int:
    """Shared memory of a block of the wide backward: its warps' regions,
    the ring of layer slices and the warps' active flags."""
    return 4 * warps * warp_floats + wide_ring_bytes(width) + WIDE_FLAG_BYTES


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """The wide backward's launch: warps (rays) a block, a block's shared
    memory, the bytes of the packed layers, the floats of a block's row of
    weight-gradient sums, the bytes of a block's scratch in device memory
    (past W = 256), whether its tiles lie there and the blocks an SM
    holds."""

    warps: int
    smem_bytes: int
    workspace_bytes: int
    row_floats: int
    scratch_bytes: int = 0
    tiles_in_device_memory: bool = False
    blocks_per_sm: int = 1

    def partial_rows(self, num_sms: int) -> int:
        """Rows of the partial-sum buffer: one per block of the resident
        wave, not per warp: one block an SM where a block takes more than
        half an SM's shared memory, as many as fit where its tiles lie in
        device memory (4 at 768: the ring and the encoding, 52,256
        bytes)."""
        return num_sms * self.blocks_per_sm


def wide_bw_plan(width: int, n_t: int, n_o: int, n_c: int, widths,
                 has_color_grid: bool) -> WidePlan:
    """The wide backward's plan at these MLP widths (``widths``: the
    n_hidden tuples of the trunk, opacity and colour MLPs, one after the
    other): the most warps, up to WIDE_BW_MAX_WARPS, whose regions fit with
    the ring in a block's shared memory, rounded down to whole warpgroups
    of 4 past 4 (a warpgroup runs the products by ``wgmma``; 1-3 warps by
    ``mma.sync``); past W = 256 one (its heads' tile and stash in a scratch
    in device memory, and its tiles too where they do not fit with the
    ring: ``wide_tiles_in_device_memory``, as many blocks an SM as its
    shared memory holds).  Raises ``ValueError`` with the bytes one warp
    needs where even that does not fit (up to W = 256)."""
    from .renderer_fw import wide_layers, wide_products

    layers = wide_layers(n_t, n_o, n_c, list(widths))
    floats = wide_warp_floats(width, layers, n_c, has_color_grid)
    warps = 1 if width > 256 else WIDE_BW_MAX_WARPS
    while warps > 1 and wide_bw_smem_bytes(width, floats,
                                           warps) > MAX_SMEM_BYTES:
        warps -= 1
    if warps > 4:
        warps = warps // 4 * 4  # whole warpgroups: the products by wgmma
    smem = wide_bw_smem_bytes(width, floats, warps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"the backward kernel needs {smem} bytes of shared memory for a "
            f"block of one warp at width {width} with {len(layers)} layers, "
            f"more than the {MAX_SMEM_BYTES} a Hopper block can have")
    row = 0
    for d_in, d_out, _, _ in layers:
        mi, no = -(-d_in // 16), -(-d_out // 8)
        row += mi * no * 128 + 8 * no
    dev = wide_tiles_in_device_memory(width, layers, n_c, has_color_grid)
    return WidePlan(
        warps, smem, wide_pack_bytes(wide_products(layers, n_t, n_o, True)),
        -(-row // 4) * 4,
        wide_bw_scratch_bytes(width, layers, n_c, has_color_grid), dev,
        SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES) if dev else 1)


def wide_config(lib, a, has_color_grid: bool):
    """The wide build's (widths 96-768) launch as its C side plans it,
    held to ``wide_bw_plan``'s: ``(plan, rows of the partial-sum buffer)``,
    a row per block of the resident wave.  Raises ``ValueError`` where one
    warp's region and the ring exceed a block's shared memory."""
    import ctypes

    plan = wide_bw_plan(a.width, a.n_t, a.n_o, a.n_c, list(a.mlp_widths),
                        has_color_grid)
    out = (ctypes.c_int * 6)()
    rc = lib.lightplane_render_bw_wide_config(
        a.width, a.n_t, a.n_o, a.n_c, a.mlp_widths, int(has_color_grid), out)
    if rc != 0:
        raise ValueError(f"the wide backward refused its launch "
                         f"({lib.lightplane_cuda_error_string(rc).decode()})")
    if (out[0], out[3], out[4], out[2], out[5]) != (
            plan.warps, plan.smem_bytes, plan.workspace_bytes,
            plan.row_floats, plan.scratch_bytes):
        raise RuntimeError(f"the wide backward's plan {tuple(out)} is not "
                           f"the wrapper's {plan}")
    return plan, out[1]


def _launch_bw(cfg: _RenderCfg, geom, diff, nlt_final, g_out, defines,
               rays_per_block, relu_masks, probe=None):
    global LAUNCHES, SCAFFOLD_LAUNCHES
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
    workspace = None
    if a.width > 64:
        # the wide build: a warp per ray, each block of the resident wave
        # its own row of weight-gradient sums, zero-filled here (a second
        # kernel sums the rows into g_mlp), the layers packed into the
        # workspace by the launch's pre-pass, then (past W = 256) each
        # block's scratch.  rays_per_block is not read.
        plan, rows = wide_config(lib, a, color_grid_flat is not None)
        partials = torch.zeros((rows, plan.row_floats), dtype=f32,
                               device=a.device)
        workspace = torch.empty(
            ((plan.workspace_bytes + rows * plan.scratch_bytes) // 4,),
            dtype=torch.int32, device=a.device)
        rays_per_block = RAYS_PER_BLOCK[-1]
    else:
        smem = block_smem_bytes(lib, a, color_grid_flat is not None)
        if rays_per_block is None:
            rays_per_block = pick_rays_per_block(
                a.R, smem, _sm_count(a.device.index or 0))
            if rays_per_block is None:
                raise ValueError(
                    f"the backward kernel needs {smem[RAYS_PER_BLOCK[-1]]} "
                    f"bytes of shared memory per block of "
                    f"{RAYS_PER_BLOCK[-1]} rays at these MLP widths, more "
                    f"than the {MAX_SMEM_BYTES} a Hopper block can have"
                )
        elif smem.get(rays_per_block, MAX_SMEM_BYTES + 1) > MAX_SMEM_BYTES:
            raise ValueError(f"rays_per_block must be one of "
                             f"{RAYS_PER_BLOCK} and fit in shared memory, "
                             f"got {rays_per_block}")
        # per-block partial sums of the MLP weight gradients; each block
        # initialises its own row, and a second kernel sums the rows into
        # g_mlp
        n_blocks = -(-a.R // rays_per_block)
        partials = torch.empty(
            (max(n_blocks, 1),
             lib.lightplane_render_bw_partial_floats(a.width, a.n_layers)),
            dtype=f32, device=a.device)

    n_params = sum(map(_mlp_numel, (cfg.n_hidden_trunk, cfg.n_hidden_opacity,
                                    cfg.n_hidden_color)))
    g_grid = torch.zeros_like(grid_flat)
    g_color_grid = (None if color_grid_flat is None
                    else torch.zeros_like(color_grid_flat))
    g_mlp = torch.empty((n_params,), dtype=f32, device=a.device)
    g_enc = torch.empty_like(rays_encoding)
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
        None if relu_masks is None else relu_masks.data_ptr(),
        _ptr(workspace),
        _ptr(probe),
        stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(f"renderer_bw kernel launch failed: {msg} ({rc})")
    LAUNCHES += 1
    SCAFFOLD_LAUNCHES += scaffold is not None
    return g_grid, g_color_grid, g_mlp, g_enc


def render_bwd_cuda(cfg: _RenderCfg, geom, diff, nlt_final, g_out,
                    defines=(), rays_per_block=None):
    """Launch the recompute-backward kernel on the current CUDA stream.
    ``defines`` pick a variant build of the kernel (``_build.library``);
    ``rays_per_block`` (128, 64 or 32) overrides ``pick_rays_per_block``."""
    return _launch_bw(cfg, geom, diff, nlt_final, g_out, defines,
                      rays_per_block, None)


def render_bwd_cuda_relu_masks(cfg: _RenderCfg, geom, diff, nlt_final, g_out,
                               rays_per_block=None, probe=None):
    """The kernel's recording build (``RELU_MASKS_BUILD``): returns its
    gradients, as ``render_bwd_cuda``'s, and the relu masks its recomputed
    forward took (``mask_shape``; zero at steps that no ray of a block
    passes the scaffold at, where every cotangent is 0).  ``probe`` as
    ``renderer_fw.render_fwd_cuda``'s (the wide widths only)."""
    shape = mask_shape(cfg, geom[0].shape[0], diff[0].shape[1])
    masks = torch.zeros(shape, dtype=torch.int32, device=geom[0].device)
    grads = _launch_bw(cfg, geom, diff, nlt_final, g_out, RELU_MASKS_BUILD,
                       rays_per_block, masks, probe)
    return grads, masks


def forward_probes(cfg: _RenderCfg, geom, diff, g_out):
    """R1's forward and R2's recomputed forward, each through the wide
    builds' recording build (widths 96-768): ``(r1, r2)``, each ``[R,
    steps, 2]`` f32, an open step's raw opacity (before the noise) and the
    sum of its raw colours, 0 at the steps that are shut.  R2 recomputes
    R1's activations by the same products in the same order, so the two
    are equal to the bit (``torch.equal``)."""
    R = geom[0].shape[0]
    shape = (R, cfg.tot_num_samples, 2)
    r1 = torch.zeros(shape, dtype=torch.float32, device=geom[0].device)
    r2 = torch.zeros_like(r1)
    nlt = render_fwd_cuda(cfg, geom, diff, defines=RELU_MASKS_BUILD,
                          probe=r1)[1]
    render_bwd_cuda_relu_masks(cfg, geom, diff, nlt, g_out, probe=r2)
    return r1, r2


def render_bwd(cfg: _RenderCfg, geom, diff, nlt_final, g_out,
               impl: str = "auto"):
    """Recompute backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, with ``impl`` as in ``renderer_fw.render_fwd``."""
    if check_impl(impl, geom[0].is_cuda, geom[0].device):
        return render_bwd_torch(cfg, geom, diff, nlt_final, g_out)
    return render_bwd_cuda(cfg, geom, diff, nlt_final, g_out)
