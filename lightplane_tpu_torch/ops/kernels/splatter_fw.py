"""The splatter's forward kernel (S1): its wrapper, its plain PyTorch version
and the dispatch between them, and the plan of runs by brick that the
kernel splats by, with its own plain version.

``splat_fwd_cuda`` launches ``csrc/splatter_fw.cu`` (which replaces
``lightplane_tpu/ops/kernels/splatter_pallas.py::_build_fw_kernel``):
the plan's count pass, a prefix sum, its fill pass, then the splat pass that
sums each brick's runs in shared memory and flushes the touched rows.  With
an MLP wider than 64 it runs two passes per slice of the rays
(``mlp_slices``): pass F computes every sampled step's MLP output once into
a staging buffer, and pass S splats the staged rows by the plan into each
output sub-grid.  ``splat_fwd_torch`` is the same splat as a plain PyTorch
loop over steps (the port of the JAX scan core ``_splat_fwd_impl``);
``splat_fwd_two_pass_torch`` is the wide build's two-pass design in plain
PyTorch, for the tests.  ``splat_fwd`` sends CUDA tensors to the kernel and
CPU tensors to ``splat_fwd_torch``; there is no fallback from one to the
other.  ``splat_plan_cuda`` and ``splat_plan_torch`` give the plan itself
(``canonical_runs`` puts the kernel's runs in the plain version's order).

Every function takes ``(cfg, geom, diff)``: ``geom = (directions, origins,
near, far, grid_idx)`` and ``diff = (encoding, input_grid_flat,
mlp_params)`` (the last two None without an MLP), and the splat returns the
raw accumulators ``(feat [V, C], w [V, 1])``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import guards
from ..grid_sample import grid_row_offsets, splat_grid_rep
from ..mlp_utils import _mlp_numel
from ..splatter import (
    _chunk_points,
    _march_points,
    _splat_chunks,
    _SplatCfg,
    _step_fused_feature,
)
from .renderer_fw import (
    MAX_GRIDS,
    MAX_LAYERS,
    MAX_SMEM_BYTES,
    WIDE_CHUNK,
    _check,
    check_impl,
    wide_layers,
    wide_pack_bytes,
    wide_ring_bytes,
)

# The splatter MLP's padded activation widths (its kernels' builds: 32 and
# 64, and the wide ones up to 256; the renderer's go on to 512)
MLP_WIDTHS = (32, 64, 96, 128, 192, 256)

# Number of kernel launches in this process; the kernel path adds one per
# launch and nothing else changes it, so a caller can reset it and show that
# a run went through the kernel.  LAUNCHES counts splats (their plans and
# splat passes), PLAN_LAUNCHES plans (one per output sub-grid and slice of
# rays of a splat, and any asked for alone).
LAUNCHES = 0
PLAN_LAUNCHES = 0

# Shared memory of a splat block (the MLP's layers, then per warp a tile of
# rows of C channels and the weight, and a batch of staged encodings) that
# lets three blocks share an SM (228 KB, 1 KB of it reserved per block):
# the splat pass is bound by latency, and at the splat headline and
# lift-then-render's splat this beat the bricks for one or two blocks an SM
# (PERF.md, section 6)
BLOCK_SMEM_BUDGET = 228 * 1024 // 3 - 1024
SPLAT_WARPS = 4    # warps per block of the splat pass (kWarps)
RUN_BATCH = 32     # runs a warp marches together (kBatch)
# K: the runs of one work item, a brick's slice; the adjoint's pass B
# splats a slice of rays into few bricks, so it takes smaller items to give
# every warp of the card some
RUNS_PER_ITEM = 1024
RUNS_PER_ITEM_STEPS = 64
# a run stores its first and last step in 16 bits each
MAX_STEPS = 0xFFFF
# The most runs one plan's list holds (256 MiB): a splat whose rays' bound
# (plan_shape) exceeds it plans and splats its rays in slices, so that the
# list stops growing with the rays and the samples
PLAN_MAX_RUNS = 1 << 25
# The wide MLP build's pass F (csrc/splatter_fw.cu): warps (rays) a block,
# each with one [WIDE_CHUNK, W + 4] f32 tile
PASS_F_WARPS = 8


def splat_fwd_torch(cfg: _SplatCfg, geom, diff):
    """Plain PyTorch splat over all steps, a chunk of steps at a time
    (``splatter._splat_chunks``): ``[vec | 1]`` into one ``[V, C + 1]``
    accumulator updated in place, split at the end; memory O(V + R)."""
    grid_idx = geom[4]
    encoding, input_grid_flat, mlp_params = diff
    C = cfg.out_chn
    acc = encoding.new_zeros((cfg.v_total, C + 1))
    for chunk in _splat_chunks(cfg, geom, diff):
        pts = _chunk_points(cfg, geom, chunk)
        vec = _step_fused_feature(cfg, pts, encoding, input_grid_flat,
                                  mlp_params, grid_idx)
        ones = vec.new_ones(vec.shape[:-1] + (1,))
        splat_grid_rep(torch.cat([vec, ones], -1), acc, cfg.output_grid_sizes,
                       pts, grid_idx, cfg.mask_out_of_bounds_samples,
                       inplace=True)
    return acc[:, :C].contiguous(), acc[:, C:].contiguous()


def _mlp_width(cfg: _SplatCfg) -> int:
    """The MLP's padded activation width, the narrowest of ``MLP_WIDTHS``
    that holds every layer (0 without an MLP or beyond the widest build;
    ``splat_launch_args`` raises for the latter)."""
    if not cfg.n_hidden:
        return 0
    return next((w for w in MLP_WIDTHS if max(cfg.n_hidden) <= w), 0)


def _tile_rows(grid_size, brick) -> int:
    """Rows of a brick's tile: its cells and the upper corner of the last
    along each axis that is not a singleton."""
    rows = 1
    for size, cells in zip(grid_size[1:4], brick):
        rows *= cells + 1 if size > 1 else 1
    return rows


def _stage_chn(cfg: _SplatCfg) -> int:
    """Channels of a run's staged encoding (``stage_chn``): the MLP's input
    (widths 32 and 64), or a pass of at most 64 of the output's, in slices
    of 32."""
    E = cfg.n_hidden[0] if cfg.n_hidden else min(cfg.out_chn, 64)
    return 32 if E <= 32 else 64


def splat_smem_bytes(width: int, n_layers: int, rows: int, C: int,
                     stage: int) -> int:
    """Shared memory of a splat block: the MLP's layers (widths 32 and 64),
    then per warp a tile of ``rows`` rows of C channels and the weight (an
    even count of floats) and a batch of staged values of ``stage``
    channels, each rounded up to 16 bytes (as
    ``csrc/splatter_fw.cu::splat_smem_bytes``)."""
    row = (C + 2) & ~1
    warp = -(-rows * row // 4) * 4 + -(-RUN_BATCH * stage // 4) * 4
    return 4 * (n_layers * (width * width + width) + SPLAT_WARPS * warp)


def pick_bricks(cfg: _SplatCfg, budget: int = BLOCK_SMEM_BUDGET,
                grid_sizes=None):
    """The brick, cells along (D, H, W), of each output sub-grid (or of each
    sub-grid of ``grid_sizes``, splatted without the MLP: the adjoint's
    pass B over the input grid-list; with an MLP wider than 64 the output
    sub-grids' are pass S's): from 2 cells along each axis that is
    not a singleton, the axis with the fewest cells (the later on a tie)
    doubles while the block's shared memory stays within ``budget`` and the
    brick within the grid.  A smallest brick past ``budget`` stays, and
    fewer blocks share an SM (pass S at 256 channels: 102,720 bytes, two);
    raises where it exceeds a block's shared memory."""
    # the per-step splat (the adjoint's pass B, the wide MLP build's pass
    # S) stages two steps' values of a batch of runs
    steps = grid_sizes is not None or _mlp_width(cfg) > 64
    grid_sizes = grid_sizes or cfg.output_grid_sizes
    C = int(grid_sizes[0][-1])
    width = 0 if steps else _mlp_width(cfg)
    stage = 2 * (32 if C <= 32 else 64) if steps else _stage_chn(cfg)
    n_layers = len(cfg.n_hidden) - 1 if width else 0

    def smem(gs, brick):
        return splat_smem_bytes(width, n_layers, _tile_rows(gs, brick), C,
                                stage)

    bricks = []
    for gs in grid_sizes:
        dims = gs[1:4]
        brick = [2 if d > 1 else 1 for d in dims]
        if smem(gs, brick) > MAX_SMEM_BYTES:
            raise ValueError(
                f"the CUDA splatter needs {smem(gs, brick)} bytes of shared "
                f"memory for the smallest brick of {C} channels, more than "
                f"the {MAX_SMEM_BYTES} a Hopper block has")
        while True:
            grow = [k for k in range(3) if 1 < dims[k] and brick[k] < dims[k]]
            if not grow:
                break
            k = min(reversed(grow), key=lambda k: brick[k])
            bigger = list(brick)
            bigger[k] *= 2
            if smem(gs, bigger) > budget:
                break
            brick = bigger
        bricks.append(tuple(brick))
    return tuple(bricks)


@dataclasses.dataclass(frozen=True)
class PlanShape:
    """The bricks of an output grid-list and the bound on its runs."""

    nb: tuple          # bricks along (D, H, W), per sub-grid
    first: tuple       # the first brick id of each sub-grid, then the total
    capacity: int      # runs the list can hold

    @property
    def n_bricks(self):
        return self.first[-1]


def plan_shape(cfg: _SplatCfg, bricks, n_rays: int,
               grid_sizes=None) -> PlanShape:
    """Brick counts and the capacity of the run list of the output
    grid-list (or of ``grid_sizes``), from the shapes alone.  A run is one
    ray's consecutive steps with one brick in one sub-grid.  Without
    contraction and background steps the steps walk a straight segment in
    order, so each axis's brick index only moves one way and the steps with
    an in-bounds corner (and, with masking, inside the cube) form one
    interval: a ray makes at most 1 + sum(bricks - 1 per axis) runs in a
    sub-grid.  Background depths need not grow by the step
    in f32 and contraction bends the path, so with either the bound is the
    step count; always at most the step count."""
    steps = cfg.tot_num_samples
    nb, first, capacity = [], [0], 0
    straight = not cfg.contract_coords and cfg.num_samples_inf == 0
    for gs, brick in zip(grid_sizes or cfg.output_grid_sizes, bricks):
        n = tuple(-(-size // cells) for size, cells in zip(gs[1:4], brick))
        nb.append(n)
        first.append(first[-1] + gs[0] * n[0] * n[1] * n[2])
        per_ray = steps
        if straight:
            per_ray = min(steps, 1 + sum(k - 1 for k in n))
        capacity += n_rays * per_ray
    return PlanShape(tuple(nb), tuple(first), capacity)


def ray_slices(cfg: _SplatCfg, g: int, brick, n_rays: int):
    """The slices ``(start, stop)`` of the rays that ``splat_fwd_cuda``
    plans and splats one after another in output sub-grid ``g``: each
    slice's run list (``plan_shape``) holds at most ``PLAN_MAX_RUNS`` runs,
    and each slice but the last is a multiple of 32 rays."""
    per_ray = plan_shape(cfg, (brick,), 1,
                         (cfg.output_grid_sizes[g],)).capacity
    step = max(32, PLAN_MAX_RUNS // max(per_ray, 1) // 32 * 32)
    return [(lo, min(lo + step, n_rays)) for lo in range(0, n_rays, step)]


def byte_slices(lo: int, hi: int, per_ray: int):
    """``[lo, hi)`` cut into slices of at most ``PLAN_MAX_RUNS`` runs'
    bytes at ``per_ray`` bytes a ray, each but the last a multiple of 32
    rays."""
    step = max(32, 8 * PLAN_MAX_RUNS // max(per_ray, 1) // 32 * 32)
    return [(a, min(a + step, hi)) for a in range(lo, hi, step)]


def mlp_slices(cfg: _SplatCfg, bricks, n_rays: int):
    """The slices ``(start, stop)`` of the rays that the wide MLP build
    runs its two passes over: each slice's staged MLP outputs ([rays,
    steps, C] f32) and each of its run lists over an output sub-grid
    (``plan_shape``, 8 bytes a run, ``bricks`` per sub-grid) within
    ``PLAN_MAX_RUNS`` runs' bytes; each slice but the last a multiple of 32
    rays."""
    runs = max(plan_shape(cfg, (b,), 1, (gs,)).capacity
               for gs, b in zip(cfg.output_grid_sizes, bricks))
    return byte_slices(0, n_rays,
                       max(4 * cfg.tot_num_samples * cfg.out_chn, 8 * runs))


def splat_products(layers, backward: bool):
    """The products of a chunk of the splatter MLP's wide kernels, in the
    order they run them (``csrc/wide_mlp.cuh::wide_product``):
    ``(layer, transposed, k_steps, n_tiles)``; S1's pass F every layer,
    S2's pass A (``backward``) the relu layers, then every layer's input
    gradient (its transpose), last layer first.  ``layers`` as
    ``renderer_fw.wide_layers(L, 0, 0, n_hidden)``'s."""
    L = len(layers)
    out = [(l, False, -(-layers[l][0] // 8), -(-layers[l][1] // 8))
           for l in range(L - 1 if backward else L)]
    if backward:
        out += [(l, True, -(-layers[l][1] // 8), -(-layers[l][0] // 8))
                for l in reversed(range(L))]
    return out


def pass_f_smem_bytes(width: int) -> int:
    """Shared memory of a block of the wide MLP build's pass F: each warp's
    [WIDE_CHUNK, width + 4] f32 tile, then the ring."""
    return (4 * PASS_F_WARPS * WIDE_CHUNK * (width + 4)
            + wide_ring_bytes(width))


def _brick_keys(gs, brick, nb, first, pts, grid_idx, live):
    """Per ray, the brick of sub-grid ``gs`` that holds the lower corner of
    its point, clamped into the grid, or -1 where the point has no in-bounds
    corner there or ``live`` is false."""
    coords = []
    for size, p, cells in zip(gs[1:4], (pts[:, 2], pts[:, 1], pts[:, 0]),
                              brick):
        f = ((p + 1.0) * 0.5) * size - 0.5 if size > 1 else torch.zeros_like(p)
        f0 = torch.floor(f)
        live = live & (f0 >= -1) & (f0 <= size - 1)
        coords.append(f0)
    k = [torch.where(live, f0, torch.zeros_like(f0)).clamp(min=0).long()
         // cells for f0, cells in zip(coords, brick)]
    key = first + ((grid_idx * nb[0] + k[0]) * nb[1] + k[1]) * nb[2] + k[2]
    return torch.where(live, key, torch.full_like(key, -1))


def splat_plan_torch(cfg: _SplatCfg, geom, bricks, grid_sizes=None):
    """Plain PyTorch version of the plan's two passes over the output
    grid-list (or ``grid_sizes``): ``(counts [bricks] int32, offsets
    [bricks + 1] int32, runs [N, 3] int64)``, the runs as (ray, first step,
    last step), grouped by brick in order of (ray, first step).  A ray whose
    ``grid_idx`` lies outside the batch of any grid of ``cfg`` (output or
    input) makes no runs."""
    directions, _, _, _, grid_idx = geom
    R, S = directions.shape[0], cfg.tot_num_samples
    grids = tuple(grid_sizes or cfg.output_grid_sizes)
    shape = plan_shape(cfg, bricks, R, grids)
    sizes = tuple(cfg.output_grid_sizes) + tuple(cfg.input_grid_sizes or ())
    gi = grid_idx.long()
    live = (gi >= 0) & (gi < min(gs[0] for gs in sizes))
    G = len(grids)
    keys = torch.full((G, R, S), -1, dtype=torch.int64,
                      device=directions.device)
    for s in range(S):
        pts = _march_points(cfg, geom, s)
        ok = live
        if cfg.mask_out_of_bounds_samples:
            ok = ok & (pts.abs() <= 1.0).all(-1)
        for g, (gs, brick) in enumerate(zip(grids, bricks)):
            keys[g, :, s] = _brick_keys(gs, brick, shape.nb[g],
                                        shape.first[g], pts, gi, ok)
    runs, run_keys = [], []
    none = torch.full((R, 1), -1, dtype=torch.int64, device=keys.device)
    for k in keys:
        prev = torch.cat([none, k[:, :-1]], 1)
        nxt = torch.cat([k[:, 1:], none], 1)
        starts = ((k >= 0) & (k != prev)).nonzero()   # (ray, step), in order
        ends = ((k >= 0) & (k != nxt)).nonzero()
        runs.append(torch.stack([starts[:, 0], starts[:, 1], ends[:, 1]], 1))
        run_keys.append(k[starts[:, 0], starts[:, 1]])
    runs, run_keys = torch.cat(runs), torch.cat(run_keys)
    order = torch.argsort((run_keys * R + runs[:, 0]) * S + runs[:, 1])
    counts = torch.bincount(run_keys, minlength=shape.n_bricks)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return counts.int(), offsets.int(), runs[order]


def canonical_runs(counts, offsets, runs):
    """The kernel's run list ``runs`` ([capacity, 2] int32: ray, first step
    | last step << 16, in an order its atomics chose within each brick) as
    ``splat_plan_torch`` gives it: [N, 3] int64 (ray, first step, last
    step), grouped by brick in order of (ray, first step)."""
    counts = counts.long()
    n = int(offsets[-1])
    raw = runs[:n].long()
    brick = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    out = torch.stack([raw[:, 0], raw[:, 1] & 0xFFFF,
                       (raw[:, 1] >> 16) & 0xFFFF], 1)
    R = int(out[:, 0].max()) + 1 if n else 1
    order = torch.argsort((brick * R + out[:, 0]) * (MAX_STEPS + 1)
                          + out[:, 1])
    return out[order]


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
    width: int       # one of MLP_WIDTHS with an MLP, 0 without
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
        width = next((w for w in MLP_WIDTHS if widest <= w), None)
        if width is None:
            raise ValueError(
                f"the CUDA splatter takes MLP widths up to {MLP_WIDTHS[-1]}, "
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
    if cfg.tot_num_samples > MAX_STEPS:
        raise ValueError(f"the CUDA splatter takes up to {MAX_STEPS} steps "
                         f"per ray, got {cfg.tot_num_samples}")
    guards.check_grid_idx(grid_idx, min(batches), kernel)
    return SplatLaunchArgs(
        device=device, R=R, C=C, C_in=C_in, n_layers=n_layers,
        n_params=n_params, width=width, out_meta=out_meta, in_meta=in_meta,
        mlp_widths=widths,
    )


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sub_cfg(cfg: _SplatCfg, g: int) -> _SplatCfg:
    """``cfg`` with output sub-grid ``g`` alone."""
    return dataclasses.replace(cfg,
                               output_grid_sizes=(cfg.output_grid_sizes[g],))


def plan_slice(counts, offsets, runs, shape: PlanShape, g: int):
    """The part of a plan of every output sub-grid (``splat_plan_torch``)
    that is sub-grid ``g``'s: its counts, its offsets from 0 and its runs,
    as the plan of that sub-grid alone gives them."""
    lo, hi = shape.first[g], shape.first[g + 1]
    first, last = int(offsets[lo]), int(offsets[hi])
    return counts[lo:hi], offsets[lo:hi + 1] - first, runs[first:last]


def list_args(cfg: _SplatCfg, a: SplatLaunchArgs, rows: int):
    """``a`` for a splat of no MLP into the input grid-list of ``cfg``
    (``rows`` rows): the adjoint's pass B, and its plan."""
    sizes = cfg.input_grid_sizes
    C = int(sizes[0][-1])
    return dataclasses.replace(
        a, C=C, C_in=0, n_layers=0, n_params=0, width=0,
        out_meta=_grid_meta(sizes, rows, C, "the input grid-list"),
        in_meta=None, mlp_widths=None)


def steps_args(a: SplatLaunchArgs):
    """``a`` for a per-step splat of no MLP into the same output grid-list:
    the wide MLP build's pass S."""
    return dataclasses.replace(a, C_in=0, n_layers=0, n_params=0, width=0,
                               in_meta=None, mlp_widths=None)


def batch_limit(cfg: _SplatCfg) -> int:
    """The batches that every grid-list of ``cfg`` has."""
    sizes = tuple(cfg.output_grid_sizes) + tuple(cfg.input_grid_sizes or ())
    return min(gs[0] for gs in sizes)


def _launch(lib, stage, cfg, geom, diff, a, g, brick, feat=None, w=None,
            counts=None, cursor=None, offsets=None, runs=None, capacity=0,
            item_start=None, max_items=0, step_values=0, limit=0):
    """One stage of ``lightplane_splat_fw`` (0 count, 1 fill, 2 splat) for
    sub-grid ``g`` of ``a``'s grid-list with bricks of ``brick`` cells, over
    the rays of ``geom`` (all of them or a slice), on the current CUDA
    stream; ``step_values`` (0, 1 or 2) and ``limit`` as the C entry's
    step_values and batch_limit.  Raises when the launch fails."""
    directions, origins, near, far, grid_idx = geom
    encoding, input_grid_flat, mlp_params = diff
    meta = (ctypes.c_int * 5)(*a.out_meta[5 * g:5 * g + 5])
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.lightplane_splat_fw(
        origins.data_ptr(), directions.data_ptr(), near.data_ptr(),
        far.data_ptr(), grid_idx.data_ptr(), encoding.data_ptr(),
        _ptr(input_grid_flat), _ptr(mlp_params), _ptr(feat), _ptr(w),
        directions.shape[0], 1, meta, a.C,
        len(cfg.input_grid_sizes or ()), a.in_meta, a.C_in,
        a.n_layers, a.mlp_widths, a.width,
        cfg.num_samples, cfg.num_samples_inf, cfg.disparity_at_inf,
        int(cfg.mask_out_of_bounds_samples), int(cfg.contract_coords),
        (ctypes.c_int * 3)(*brick), stage, _ptr(counts), _ptr(cursor),
        _ptr(offsets), _ptr(runs), capacity, _ptr(item_start),
        RUNS_PER_ITEM_STEPS if step_values else RUNS_PER_ITEM, max_items,
        step_values, limit, stream,
    )
    if rc != 0:
        msg = lib.lightplane_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"splatter_fw kernel launch (stage {stage}) failed: {msg} ({rc})")


def _plan_cuda(lib, cfg, geom, diff, a, g, brick, grid_sizes=None, limit=0):
    """Sub-grid ``g``'s plan of the rays of ``geom``, of the output
    grid-list or of ``grid_sizes`` (then ``a`` is ``list_args``' and
    ``limit`` its ``batch_limit``; such a plan is not counted in
    PLAN_LAUNCHES): the count pass, the prefix sum of the counts and the
    fill pass; ``(shape, counts, offsets, runs)``.  Nothing is read back."""
    global PLAN_LAUNCHES
    sizes = grid_sizes or cfg.output_grid_sizes
    shape = plan_shape(cfg, (brick,), geom[0].shape[0], (sizes[g],))
    if shape.capacity >= 2**31 or shape.n_bricks >= 2**31:
        raise ValueError("too many runs or bricks for the CUDA splatter's "
                         "int32 plan")
    counts = torch.zeros(shape.n_bricks, dtype=torch.int32, device=a.device)
    _launch(lib, 0, cfg, geom, diff, a, g, brick, counts=counts, limit=limit)
    offsets = torch.zeros(shape.n_bricks + 1, dtype=torch.int32,
                          device=a.device)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    cursor = torch.zeros_like(counts)
    runs = torch.empty((max(shape.capacity, 1), 2), dtype=torch.int32,
                       device=a.device)
    _launch(lib, 1, cfg, geom, diff, a, g, brick, cursor=cursor,
            offsets=offsets, runs=runs, capacity=shape.capacity, limit=limit)
    if grid_sizes is None:
        PLAN_LAUNCHES += 1
    return shape, counts, offsets, runs


def splat_plan_cuda(cfg: _SplatCfg, geom, diff, bricks=None, grid=0,
                    inputs=False):
    """The plan's kernels alone, for output sub-grid ``grid`` (with
    ``inputs``, input sub-grid ``grid``: the adjoint's pass B) and every ray
    in one list, on the current CUDA stream: ``(counts [bricks] int32,
    offsets [bricks + 1] int32, runs [capacity, 2] int32)``, each brick's
    runs in the order its atomics chose (``canonical_runs`` orders them;
    ``plan_slice`` cuts the plain version's plan of every sub-grid to
    match).  ``bricks`` default to ``pick_bricks``'."""
    a = splat_launch_args(cfg, geom, diff, "splat_plan_cuda")
    diff = tuple(aligned(t) for t in diff)
    from ._build import library

    sizes, limit = None, 0
    if inputs:
        sizes, limit = cfg.input_grid_sizes, batch_limit(cfg)
        a = list_args(cfg, a, diff[1].shape[0])
    if bricks is None:
        bricks = pick_bricks(cfg, grid_sizes=sizes)
    _, counts, offsets, runs = _plan_cuda(library(), cfg, geom, diff, a,
                                          grid, tuple(bricks)[grid], sizes,
                                          limit)
    return counts, offsets, runs


def splat_fwd_cuda(cfg: _SplatCfg, geom, diff, defines=(), bricks=None):
    """Launch the splat forward on the current CUDA stream, one output
    sub-grid and slice of rays (``ray_slices``) after another, so that a
    run list holds at most one sub-grid's runs and ``PLAN_MAX_RUNS``: its
    plan (``_plan_cuda``), the work items' prefix sum, and the splat pass.
    With an MLP wider than 64, slice by slice of the rays (``mlp_slices``):
    pass F, then pass S into each output sub-grid (``_splat_mlp_wide``).
    ``defines`` pick a variant build of the kernel
    (``_build.library``); ``bricks`` (cells along D, H, W per output
    sub-grid) default to ``pick_bricks(cfg)``."""
    global LAUNCHES
    a = splat_launch_args(cfg, geom, diff, "splat_fwd_cuda")
    diff = tuple(aligned(t) for t in diff)

    from ._build import library

    lib = library(defines)
    bricks = pick_bricks(cfg) if bricks is None else tuple(bricks)
    rows = max(_tile_rows(gs, b)
               for gs, b in zip(cfg.output_grid_sizes, bricks))
    smem = lib.lightplane_splat_fw_smem_bytes(a.width, a.n_layers, rows, a.C,
                                              a.C_in)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"the splatter needs {smem} bytes of shared memory per block, "
            f"more than the {MAX_SMEM_BYTES} a Hopper block has")
    feat = torch.zeros((cfg.v_total, a.C), dtype=torch.float32,
                       device=a.device)
    w = torch.zeros((cfg.v_total, 1), dtype=torch.float32, device=a.device)
    if a.width > 64:
        _splat_mlp_wide(lib, cfg, geom, diff, a, bricks, feat, w)
    else:
        for g, brick in enumerate(bricks):
            for lo, hi in ray_slices(cfg, g, brick, a.R):
                geom_s = tuple(t[lo:hi] for t in geom)
                diff_s = (diff[0][lo:hi],) + diff[1:]
                splat_by_plan_cuda(lib, cfg, geom_s, diff_s, a, g, brick,
                                   feat, w)
    LAUNCHES += 1
    return feat, w


def pass_f_config(lib, a: SplatLaunchArgs):
    """Pass F's ``(warps, shared-memory bytes, workspace bytes)`` as its C
    side plans them (``lightplane_splat_fw_mlp_config``), held to the
    wrapper's plan."""
    out = (ctypes.c_int * 3)()
    rc = lib.lightplane_splat_fw_mlp_config(a.width, a.n_layers,
                                            a.mlp_widths, out)
    if rc != 0:
        raise ValueError(f"the wide MLP splat does not take these widths "
                         f"({lib.lightplane_cuda_error_string(rc).decode()})")
    layers = wide_layers(a.n_layers, 0, 0, list(a.mlp_widths))
    want = (PASS_F_WARPS, pass_f_smem_bytes(a.width),
            wide_pack_bytes(splat_products(layers, False)))
    if tuple(out) != want:
        raise RuntimeError(f"pass F's plan {tuple(out)} is not the "
                           f"wrapper's {want}")
    return want


def _splat_mlp_wide(lib, cfg, geom, diff, a, bricks, feat, w):
    """The wide MLP build, slice by slice of the rays (``mlp_slices``):
    pass F stages every sampled step's MLP output ([rays, steps, C]), then
    per output sub-grid S1's plan of the slice and pass S, the per-step
    splat of the staged rows by that plan, on the current CUDA stream."""
    _, _, ws_bytes = pass_f_config(lib, a)
    workspace = torch.empty((ws_bytes // 4,), dtype=torch.int32,
                            device=a.device)
    directions, origins, near, far, grid_idx = geom
    encoding, input_grid_flat, mlp_params = diff
    stream = torch.cuda.current_stream(a.device).cuda_stream
    stage = None
    for lo, hi in mlp_slices(cfg, bricks, a.R):
        geom_s = tuple(t[lo:hi] for t in geom)
        diff_s = (encoding[lo:hi],) + diff[1:]
        if stage is None:  # the first slice is the largest
            stage = torch.empty((hi - lo, cfg.tot_num_samples, a.C),
                                dtype=torch.float32, device=a.device)
        values = stage[:hi - lo]
        rc = lib.lightplane_splat_fw_mlp(
            origins[lo:hi].data_ptr(), directions[lo:hi].data_ptr(),
            near[lo:hi].data_ptr(), far[lo:hi].data_ptr(),
            grid_idx[lo:hi].data_ptr(), diff_s[0].data_ptr(),
            input_grid_flat.data_ptr(), mlp_params.data_ptr(),
            values.data_ptr(), workspace.data_ptr(), hi - lo,
            len(cfg.output_grid_sizes), a.out_meta, a.C,
            len(cfg.input_grid_sizes), a.in_meta, a.C_in, a.n_layers,
            a.mlp_widths, a.width, cfg.num_samples, cfg.num_samples_inf,
            cfg.disparity_at_inf, int(cfg.mask_out_of_bounds_samples),
            int(cfg.contract_coords), stream)
        if rc != 0:
            msg = lib.lightplane_cuda_error_string(rc).decode()
            raise RuntimeError(f"splatter_fw pass F launch failed: {msg} "
                               f"({rc})")
        for g, brick in enumerate(bricks):
            splat_by_plan_cuda(lib, cfg, geom_s, diff_s, a, g, brick, feat,
                               w, values=values)


def splat_by_plan_cuda(lib, cfg, geom, diff, a, g, brick, feat, w,
                       grid_sizes=None, limit=0, values=None):
    """Plan the rays of ``geom`` in sub-grid ``g`` (``_plan_cuda``), sum the
    work items' prefix and splat by the plan into ``feat`` (and ``w``),
    all on the current CUDA stream.  With ``grid_sizes`` (the adjoint's
    pass B: ``a`` from ``list_args``, no ``w``) each step splats its own
    row of ``diff[0]``, ``[rays, steps, C]``; with ``values`` (the wide MLP
    build's pass S: S1's own plan, ``w`` written) each step its own row of
    ``values``."""
    shape, counts, offsets, runs = _plan_cuda(lib, cfg, geom, diff, a, g,
                                              brick, grid_sizes, limit)
    steps = grid_sizes is not None or values is not None
    k = RUNS_PER_ITEM_STEPS if steps else RUNS_PER_ITEM
    items = (counts + (k - 1)) // k
    item_start = torch.zeros_like(offsets)
    item_start[1:] = torch.cumsum(items, 0, dtype=torch.int32)
    max_items = shape.n_bricks + -(-shape.capacity // k)
    step_values = 0
    if values is not None:
        diff, a, limit, step_values = ((values, None, None), steps_args(a),
                                       batch_limit(cfg), 2)
    elif grid_sizes is not None:
        step_values = 1
    _launch(lib, 2, cfg, geom, diff, a, g, brick, feat=feat, w=w,
            offsets=offsets, runs=runs, capacity=shape.capacity,
            item_start=item_start, max_items=max_items,
            step_values=step_values, limit=limit)


def splat_steps_torch(cfg: _SplatCfg, geom, values, dst, grid_sizes,
                      bricks):
    """The per-step splat's plain version: row ``(ray, s)`` of ``values``
    ``[rays, steps, C]`` splatted at step s of each run of the plan of the
    rays of ``geom`` over each sub-grid of ``grid_sizes``
    (``splat_plan_torch`` with ``bricks``) into ``dst``, their flat ``[V,
    C]`` grid-list, in place."""
    rows = grid_row_offsets(grid_sizes)
    for g, (gs, brick) in enumerate(zip(grid_sizes, bricks)):
        _, _, runs = splat_plan_torch(cfg, geom, (brick,), (gs,))
        lens = runs[:, 2] - runs[:, 1] + 1
        ray = torch.repeat_interleave(runs[:, 0], lens)
        first = torch.repeat_interleave(lens.cumsum(0) - lens, lens)
        step = torch.repeat_interleave(runs[:, 1], lens) + (
            torch.arange(int(lens.sum()), device=lens.device) - first)
        for s in range(cfg.tot_num_samples):
            sel = ray[step == s]
            if not sel.numel():
                continue
            sub = tuple(t[sel] for t in geom)
            splat_grid_rep(values[sel, s], dst[rows[g]:rows[g + 1]], (gs,),
                           _march_points(cfg, sub, s), sub[4],
                           cfg.mask_out_of_bounds_samples, inplace=True)


def splat_fwd_two_pass_torch(cfg: _SplatCfg, geom, diff):
    """The wide MLP build's two-pass design in plain PyTorch, slice by slice
    of the rays (``mlp_slices``): each step's MLP output computed once and
    staged with the weight's 1 ([rays, steps, C + 1]), then splatted run by
    run of S1's plan into each output sub-grid (``splat_steps_torch``).
    Without the MLP it is ``splat_fwd_torch``."""
    if not cfg.n_hidden:
        return splat_fwd_torch(cfg, geom, diff)
    encoding, input_grid_flat, mlp_params = diff
    C = cfg.out_chn
    bricks = pick_bricks(cfg)
    acc = encoding.new_zeros((cfg.v_total, C + 1))
    for lo, hi in mlp_slices(cfg, bricks, encoding.shape[0]):
        geom_s = tuple(t[lo:hi] for t in geom)
        stage = encoding.new_ones((hi - lo, cfg.tot_num_samples, C + 1))
        for s in range(cfg.tot_num_samples):  # pass F
            pts = _march_points(cfg, geom_s, s)
            stage[:, s, :C] = _step_fused_feature(
                cfg, pts, encoding[lo:hi], input_grid_flat, mlp_params,
                geom_s[4])
        splat_steps_torch(cfg, geom_s, stage, acc, cfg.output_grid_sizes,
                          bricks)  # pass S
    return acc[:, :C].contiguous(), acc[:, C:].contiguous()


def splat_fwd(cfg: _SplatCfg, geom, diff, impl: str = "auto"):
    """Splat forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (``impl="auto"``); ``impl="cuda"`` raises for CPU tensors
    and ``impl="torch"`` asks for the plain version explicitly."""
    if check_impl(impl, geom[0].is_cuda, geom[0].device):
        return splat_fwd_torch(cfg, geom, diff)
    return splat_fwd_cuda(cfg, geom, diff)
