"""The plan of the splatter's forward kernel (S1): its plain version
``splat_plan_torch`` against a brute force that keys every sample on its
own, the brick choice and the run list's bound, and splatting by the plan
against ``splat_fwd_torch`` and the JAX splatter.

S1 bins each ray's consecutive steps that share a brick (the cell block
that holds their lower corner) into runs, and sums each brick in shared
memory; the kernels themselves run on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against these plain versions).
"""

import numpy as np
import pytest
import torch

from lightplane_tpu_torch.ops import grid_sample as tgs
from lightplane_tpu_torch.ops import splatter as smod
from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

torch.set_num_threads(1)


def _rays(rng, R, batch, kind):
    """Ray geometry as numpy: ``sorted`` as tests/test_splatter_sorted.py
    (unit directions from inside the cube, near 0.1, far 3), ``shell`` as
    tests/utils.py::random_rays, ``border`` along the x axis through the
    faces and border half-cells of the y and z axes."""
    if kind == "border":
        edge = np.array([-1.0, -0.999, -0.97, 0.0, 0.97, 0.999, 1.0])
        yz = rng.choice(edge, (R, 2))
        origins = np.concatenate([np.full((R, 1), -1.5), yz], 1)
        d = np.tile([1.0, 0.0, 0.0], (R, 1))
        d[:, 1:] += rng.standard_normal((R, 2)) * 1e-3 * (rng.random((R, 1))
                                                          < 0.5)
        near, far = np.full(R, 0.1), np.full(R, 3.0)
    elif kind == "shell":
        origins = rng.standard_normal((R, 3)) / 3.0 + np.array([0, 0, -2.0])
        d = rng.standard_normal((R, 3)) * 0.2 - origins
        near = 0.1 + 0.05 * rng.random(R)
        far = 3.0 + 0.2 * rng.random(R)
    else:
        origins = rng.standard_normal((R, 3)) / 3.0
        d = rng.standard_normal((R, 3)) * 0.3 - origins
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        near, far = np.full(R, 0.1), np.full(R, 3.0)
    gidx = rng.integers(0, batch, R)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa
    return (t(d), t(origins), t(near), t(far),
            torch.as_tensor(gidx, dtype=torch.int32))


def _tri(batch, res, chn):
    return [(batch, 1, res, res, chn), (batch, res, 1, res, chn),
            (batch, res, res, 1, chn)]


_SORTED = [
    ((1, 48, 40, 56, 8), 33, True, False),
    ((1, 40, 36, 44, 4), 17, False, False),
    ((1, 48, 48, 48, 8), 25, True, True),
    ((1, 1, 48, 56, 8), 21, False, False),
    ((1, 40, 1, 56, 8), 21, True, False),
    ((1, 40, 48, 1, 8), 21, False, False),
    ((3, 24, 20, 28, 8), 15, False, False),
    ((2, 1, 48, 40, 4), 15, True, False),
]
# name: (output sizes, rays, kind, march keywords, bricks or None for
# pick_bricks, whether to put some grid_idx out of range)
PLAN_CASES = {
    **{f"sorted{i}": ([gs], 2048, "sorted",
                      dict(num_samples=ns, mask_out_of_bounds_samples=m,
                           contract_coords=c), (5, 4, 6), False)
       for i, (gs, ns, m, c) in enumerate(_SORTED)},
    "sorted0_picked": ([_SORTED[0][0]], 2048, "sorted",
                       dict(num_samples=33, mask_out_of_bounds_samples=True),
                       None, False),
    "samples_inf": ([(1, 12, 10, 14, 4)], 1024, "shell",
                    dict(num_samples=9, num_samples_inf=4,
                         disparity_at_inf=1e-3), (3, 2, 4), False),
    "bad_grid_idx": ([(2, 10, 10, 10, 4)], 1024, "shell",
                     dict(num_samples=16), (3, 3, 3), True),
    "border": ([(1, 8, 6, 10, 4)], 1024, "border", dict(num_samples=24),
               (2, 2, 3), False),
    "triplane_batch2_mask": (_tri(2, 12, 4), 1024, "shell",
                             dict(num_samples=20,
                                  mask_out_of_bounds_samples=True),
                             (4, 3, 5), False),
    "voxel_and_plane": ([(1, 6, 8, 10, 4), (1, 1, 12, 12, 4)], 1024,
                        "sorted", dict(num_samples=17, contract_coords=True),
                        (2, 3, 4), False),
}


def _cfg(out_sizes, kw, in_sizes=None, n_hidden=()):
    return smod._SplatCfg(
        kw["num_samples"], kw.get("num_samples_inf", 0),
        kw.get("mask_out_of_bounds_samples", False),
        kw.get("contract_coords", False), kw.get("disparity_at_inf", 1e-5),
        tuple(map(tuple, out_sizes)),
        None if in_sizes is None else tuple(map(tuple, in_sizes)),
        tuple(n_hidden))


def _case_bricks(cfg, bricks, sizes=None):
    if bricks is None:
        return sfw.pick_bricks(cfg, grid_sizes=sizes)
    return tuple(tuple(c if size > 1 else 1
                       for c, size in zip(bricks, gs[1:4]))
                 for gs in sizes or cfg.output_grid_sizes)


def _brute_force_bricks(cfg, geom, bricks, shape, sizes=None):
    """Per sub-grid of the output grid-list (or of ``sizes``), [R, S]: the
    brick each sample must lie in, or -1 where it splats nothing there.
    Keys each sample on its own from the corners that ``splat_grid_rep``
    adds into (``_corner_rows_and_weights``): the brick of the least
    in-bounds corner along each axis, for the batch of its ray (one that
    every grid-list of ``cfg`` has)."""
    directions, _, _, _, grid_idx = geom
    R, S = directions.shape[0], cfg.tot_num_samples
    sizes = sizes or cfg.output_grid_sizes
    batches = min(gs[0] for gs in tuple(cfg.output_grid_sizes)
                  + tuple(cfg.input_grid_sizes or ()))
    gi = grid_idx.long()
    live = (gi >= 0) & (gi < batches)
    out = []
    for g, (gs, brick) in enumerate(zip(sizes, bricks)):
        _, D, H, W, _ = gs
        want = torch.full((R, S), -1, dtype=torch.int64)
        for s in range(S):
            pts = smod._march_points(cfg, geom, s)
            ok = live.clone()
            if cfg.mask_out_of_bounds_samples:
                ok &= (pts.abs() <= 1.0).all(-1)
            rows, _, valid = tgs._corner_rows_and_weights(
                gs, pts, gi.clamp(0, gs[0] - 1), "linear")
            b = rows // (D * H * W)
            z = rows // (H * W) % D
            y = rows // W % H
            x = rows % W
            big = torch.iinfo(torch.int64).max
            least = [torch.where(valid, c, big).amin(-1) for c in (z, y, x)]
            ok &= valid.any(-1)
            nb = shape.nb[g]
            k = [torch.where(ok, c, 0) // cells
                 for c, cells in zip(least, brick)]
            key = shape.first[g] + ((b[:, 0] * nb[0] + k[0]) * nb[1]
                                    + k[1]) * nb[2] + k[2]
            want[:, s] = torch.where(ok, key, -1)
            # every in-bounds corner lies in that brick's tile
            for c, kk, cells in zip((z, y, x), k, brick):
                lo = (kk * cells)[:, None]
                inside = (c >= lo) & (c <= lo + cells)
                assert bool((inside | ~valid | ~ok[:, None]).all())
        out.append(want)
    return out


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_brute_force(case):
    out_sizes, R, kind, kw, bricks, bad = PLAN_CASES[case]
    rng = np.random.default_rng(len(case))
    batch = out_sizes[0][0]
    geom = _rays(rng, R, batch, kind)
    if bad:
        gi = geom[4].clone()
        gi[::3] = batch
        gi[1::7] = -1
        geom = geom[:4] + (gi,)
    cfg = _cfg(out_sizes, kw)
    _check_plan(cfg, geom, _case_bricks(cfg, bricks))


def _check_plan(cfg, geom, bricks, sizes=None):
    """``splat_plan_torch`` of the output grid-list (or of ``sizes``)
    against the brute force: every sample in the run of its brick, runs
    maximal, in canonical order and within the list's bound."""
    R = geom[0].shape[0]
    shape = sfw.plan_shape(cfg, bricks, R, sizes)
    counts, offsets, runs = sfw.splat_plan_torch(cfg, geom, bricks, sizes)
    S = cfg.tot_num_samples
    N = runs.shape[0]
    assert counts.dtype == offsets.dtype == torch.int32
    assert counts.shape == (shape.n_bricks,)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == N
    assert torch.equal(offsets[1:] - offsets[:-1], counts)
    assert N <= shape.capacity
    brick = torch.repeat_interleave(torch.arange(shape.n_bricks),
                                    counts.long())
    ray, s0, s1 = runs.unbind(1)
    assert bool((s0 <= s1).all()) and bool((s1 < S).all())
    # canonical order: by brick, then ray, then first step
    order = (brick * R + ray) * S + s0
    assert bool((order[1:] > order[:-1]).all())
    g_of = torch.searchsorted(torch.tensor(shape.first[1:]), brick,
                              right=True)
    want = _brute_force_bricks(cfg, geom, bricks, shape, sizes)
    assert any(bool((w >= 0).any()) for w in want), "no sample splats"
    for g, w in enumerate(want):
        sel = g_of == g
        # each sample lies in as many runs as it has a brick (0 or 1), and
        # the run's brick is the sample's
        cover = torch.zeros((R, S + 1), dtype=torch.int64)
        key = torch.zeros((R, S + 1), dtype=torch.int64)
        for c, v in ((cover, torch.ones_like(ray[sel])), (key, brick[sel])):
            c.index_put_((ray[sel], s0[sel]), v, accumulate=True)
            c.index_put_((ray[sel], s1[sel] + 1), -v, accumulate=True)
        cover, key = cover.cumsum(1)[:, :S], key.cumsum(1)[:, :S]
        assert torch.equal(cover, (w >= 0).long())
        assert torch.equal(torch.where(w >= 0, key, -1), w)
        # runs are maximal: no run of a ray continues in the same brick
        r_g, a_g, b_g, k_g = ray[sel], s0[sel], s1[sel], brick[sel]
        nxt = torch.argsort(r_g * S + a_g)
        r_g, a_g, b_g, k_g = r_g[nxt], a_g[nxt], b_g[nxt], k_g[nxt]
        joined = (r_g[1:] == r_g[:-1]) & (a_g[1:] == b_g[:-1] + 1) & (
            k_g[1:] == k_g[:-1])
        assert not bool(joined.any())
        # and stay within the per-ray bound the run list is sized by
        per_ray = torch.bincount(r_g, minlength=R)
        straight = not cfg.contract_coords and cfg.num_samples_inf == 0
        bound = min(S, 1 + sum(n - 1 for n in shape.nb[g])) if straight \
            else S
        assert int(per_ray.max()) <= bound


# the MLP splatter's input grid-lists, which the adjoint's pass B plans
# over: (output sizes, input sizes, rays' batches, march keywords); in
# "batched" the output grid-list's two batches limit the rays' three
INPUT_CASES = {
    "voxel": ([(1, 10, 12, 8, 4)], [(1, 9, 11, 13, 8)], 1,
              dict(num_samples=20, mask_out_of_bounds_samples=True)),
    "triplane": (_tri(1, 12, 4), _tri(1, 14, 8), 1,
                 dict(num_samples=18, contract_coords=True)),
    "batched": ([(2, 10, 10, 10, 4)], [(3, 7, 9, 8, 8)], 3,
                dict(num_samples=16)),
}


@pytest.mark.parametrize("case", sorted(INPUT_CASES))
def test_plan_over_input_grids_matches_brute_force(case):
    out_sizes, in_sizes, batch, kw = INPUT_CASES[case]
    geom = _rays(np.random.default_rng(4), 1024, batch, "shell")
    cfg = _cfg(out_sizes, kw, in_sizes, (8, 16, 4))
    sizes = cfg.input_grid_sizes
    for bricks in (None, (2, 3, 2)):
        _check_plan(cfg, geom, _case_bricks(cfg, bricks, sizes), sizes)


@pytest.mark.parametrize("case", ["triplane_batch2_mask", "voxel_and_plane"])
def test_plan_of_one_sub_grid_is_its_slice(case):
    """The kernel plans one output sub-grid at a time: the plan of a
    sub-grid alone is the slice of the plan of all (``plan_slice``)."""
    out_sizes, R, kind, kw, bricks, _ = PLAN_CASES[case]
    geom = _rays(np.random.default_rng(5), R, out_sizes[0][0], kind)
    cfg = _cfg(out_sizes, kw)
    bricks = _case_bricks(cfg, bricks)
    shape = sfw.plan_shape(cfg, bricks, R)
    plain = sfw.splat_plan_torch(cfg, geom, bricks)
    for g, brick in enumerate(bricks):
        alone = sfw.splat_plan_torch(sfw._sub_cfg(cfg, g), geom, (brick,))
        for a, b in zip(alone, sfw.plan_slice(*plain, shape, g)):
            assert torch.equal(a, b)
        assert alone[2].shape[0] > 0


def test_canonical_runs_restores_the_plain_order():
    """The kernel's list (int2 records, any order within a brick, unused
    capacity at the end) comes back in the plain version's order."""
    out_sizes, R, kind, kw, bricks, _ = PLAN_CASES["triplane_batch2_mask"]
    geom = _rays(np.random.default_rng(3), R, 2, kind)
    cfg = _cfg(out_sizes, kw)
    bricks = _case_bricks(cfg, bricks)
    counts, offsets, runs = sfw.splat_plan_torch(cfg, geom, bricks)
    packed = torch.stack([runs[:, 0], runs[:, 1] | (runs[:, 2] << 16)], 1)
    gen = torch.Generator().manual_seed(0)
    for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist()):
        packed[a:b] = packed[a:b][torch.randperm(b - a, generator=gen)]
    raw = torch.cat([packed, torch.full((17, 2), -5)]).int()
    assert torch.equal(sfw.canonical_runs(counts, offsets, raw), runs)


PICK_CASES = {
    # bench.py's splatter headline: per warp 3 x 3 x 3 rows of 65 floats
    # and 32 staged encodings, four warps a block, three blocks an SM
    "voxel160_64ch": ([(1, 160, 160, 160, 64)], (), [(2, 2, 2)], 96),
    # the lift triplane of lift-then-render
    "triplane128_32ch": (_tri(1, 128, 32), (),
                         [(1, 8, 8), (8, 1, 8), (8, 8, 1)], 31),
    # the MLP splatter: its 64-wide layers leave room for no more than the
    # smallest brick
    "mlp_voxel160_64ch": ([(1, 160, 160, 160, 64)], (32, 32, 64),
                          [(2, 2, 2)], 96),
    # a grid smaller than the brick could grow: capped at the grid
    "small_voxel": ([(2, 3, 5, 2, 4)], (), [(4, 8, 2)], 1),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_bricks_and_run_bound(case):
    out_sizes, n_hidden, want, per_ray = PICK_CASES[case]
    in_sizes = _tri(1, 128, 32) if n_hidden else None
    cfg = _cfg(out_sizes, dict(num_samples=96), in_sizes, n_hidden)
    bricks = sfw.pick_bricks(cfg)
    assert bricks == tuple(map(tuple, want))
    width = 64 if n_hidden else 0
    for gs, brick in zip(out_sizes, bricks):
        rows = sfw._tile_rows(gs, brick)
        smem = sfw.splat_smem_bytes(width, len(n_hidden) - 1 if n_hidden
                                    else 0, rows, gs[-1],
                                    sfw._stage_chn(cfg))
        assert smem <= sfw.BLOCK_SMEM_BUDGET or brick == (2, 2, 2)
    shape = sfw.plan_shape(cfg, bricks, 1000)
    assert shape.capacity == 1000 * per_ray * len(out_sizes)
    # contraction bends the path: the bound is the step count
    bent = _cfg(out_sizes, dict(num_samples=96, contract_coords=True),
                in_sizes, n_hidden)
    assert sfw.plan_shape(bent, bricks, 1000).capacity == \
        1000 * 96 * len(out_sizes)


def test_pick_bricks_raises_for_too_many_channels():
    cfg = _cfg([(1, 8, 8, 8, 4000)], dict(num_samples=8))
    with pytest.raises(ValueError, match="smallest brick"):
        sfw.pick_bricks(cfg)


def _splat_by_plan(cfg, geom, diff, bricks):
    """The raw accumulators summed run by run: each run's steps splat
    ``[vec | 1]`` into its brick's sub-grid alone, by ``splat_grid_rep``."""
    encoding, input_grid_flat, mlp_params = diff
    counts, offsets, runs = sfw.splat_plan_torch(cfg, geom, bricks)
    shape = sfw.plan_shape(cfg, bricks, geom[0].shape[0])
    brick = torch.repeat_interleave(torch.arange(shape.n_bricks),
                                    counts.long())
    g_of = torch.searchsorted(torch.tensor(shape.first[1:]), brick,
                              right=True)
    lens = runs[:, 2] - runs[:, 1] + 1
    ray = torch.repeat_interleave(runs[:, 0], lens)
    grid = torch.repeat_interleave(g_of, lens)
    first = torch.repeat_interleave(lens.cumsum(0) - lens, lens)
    step = torch.repeat_interleave(runs[:, 1], lens) + (
        torch.arange(int(lens.sum())) - first)
    C = cfg.out_chn
    acc = encoding.new_zeros((cfg.v_total, C + 1))
    rows = tgs.grid_row_offsets(cfg.output_grid_sizes)
    for s in range(cfg.tot_num_samples):
        for g, gs in enumerate(cfg.output_grid_sizes):
            sel = ray[(step == s) & (grid == g)]
            if not sel.numel():
                continue
            sub = tuple(t[sel] for t in geom)
            pts = smod._march_points(cfg, sub, s)
            vec = smod._step_fused_feature(cfg, pts, encoding[sel],
                                           input_grid_flat, mlp_params,
                                           sub[4])
            tgs.splat_grid_rep(torch.cat([vec, torch.ones_like(vec[:, :1])],
                                         -1),
                               acc[rows[g]:rows[g + 1]], (gs,), pts, sub[4],
                               cfg.mask_out_of_bounds_samples, inplace=True)
    return acc[:, :C], acc[:, C:]


@pytest.mark.parametrize("variant", range(8))
def test_splat_by_plan_matches_plain_and_jax(variant):
    """Summing over the plan's runs gives the same raw accumulators as
    ``splat_fwd_torch`` and as the JAX package's splatter, on the eight
    variants of tests/test_splatter_parity.py."""
    pytest.importorskip("jax")
    pytest.importorskip("flax")  # the JAX package imports it
    import jax.numpy as jnp

    from lightplane_tpu.ops.splatter import lightplane_splatter_raw

    from .port_utils import compare_outputs, rays_to_torch, to_torch
    from .test_torch_splatter import _variant

    rays, out_sizes, kw, sp, igrid, in_sizes = _variant(variant)
    want = lightplane_splatter_raw(
        rays, out_sizes, sp, None if igrid is None else jnp.asarray(igrid),
        input_grid_sizes=in_sizes, **kw)
    r = rays_to_torch(rays)
    cfg = _cfg(out_sizes, kw, in_sizes if sp is not None else None,
               () if sp is None else sp.n_hidden)
    geom = (r.directions, r.origins, r.near, r.far,
            r.grid_idx.to(torch.int32))
    diff = (r.encoding, None if igrid is None else to_torch(igrid),
            None if sp is None else to_torch(np.asarray(sp.mlp_params)))
    # small bricks, so that every ray crosses several
    bricks = _case_bricks(cfg, (2, 2, 3))
    by_plan = _splat_by_plan(cfg, geom, diff, bricks)
    plain = sfw.splat_fwd_torch(cfg, geom, diff)
    compare_outputs(plain, by_plan, names=("feat", "w"))
    compare_outputs(want, by_plan, names=("feat", "w"))
    assert float(by_plan[1].sum()) > 0


# name: (output sizes, march keywords, rays, rays a slice's list may bound
# (PLAN_MAX_RUNS) or None for the module's PLAN_MAX_RUNS, slices wanted)
SLICE_CASES = {
    # the splat headline: one slice at 96 samples, two at 192
    "headline96": ([(1, 160, 160, 160, 64)], dict(num_samples=96), 262144,
                   None, 1),
    "headline192": ([(1, 160, 160, 160, 64)], dict(num_samples=192), 262144,
                    None, 2),
    "contract": ([(1, 12, 10, 14, 4)], dict(num_samples=20,
                                            contract_coords=True),
                 1000, 96, 11),
    "triplane": (_tri(1, 12, 4), dict(num_samples=20), 1000, 256, 4),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_ray_slices_bound_each_run_list(case, monkeypatch):
    """The wrapper plans and splats the rays of a sub-grid in slices whose
    run lists hold at most PLAN_MAX_RUNS runs: contiguous, covering every
    ray once, each starting at a multiple of 32 rays."""
    out_sizes, kw, R, rays, want = SLICE_CASES[case]
    cfg = _cfg(out_sizes, kw)
    bricks = sfw.pick_bricks(cfg)
    if rays is not None:
        per_ray = sfw.plan_shape(sfw._sub_cfg(cfg, 0), bricks[:1], 1).capacity
        monkeypatch.setattr(sfw, "PLAN_MAX_RUNS", rays * per_ray)
    for g, brick in enumerate(bricks):
        slices = sfw.ray_slices(cfg, g, brick, R)
        assert len(slices) == want
        assert slices[0][0] == 0 and slices[-1][1] == R
        for (a, b), (c, _) in zip(slices, slices[1:] + [(R, None)]):
            assert b == c and a < b and a % 32 == 0
            cap = sfw.plan_shape(sfw._sub_cfg(cfg, g), (brick,),
                                 b - a).capacity
            assert cap <= sfw.PLAN_MAX_RUNS


@pytest.mark.parametrize("case", ["triplane_batch2_mask", "voxel_and_plane",
                                  "samples_inf"])
def test_splat_by_sliced_plans_matches_plain(case, monkeypatch):
    """Splatting each sub-grid's rays slice by slice, each slice by its own
    plan (its rays numbered from the slice's first), as ``splat_fwd_cuda``
    does, gives ``splat_fwd_torch``'s raw accumulators."""
    out_sizes, R, kind, kw, bricks, _ = PLAN_CASES[case]
    rng = np.random.default_rng(11)
    geom = _rays(rng, R, out_sizes[0][0], kind)
    cfg = _cfg(out_sizes, kw)
    bricks = _case_bricks(cfg, bricks)
    enc = torch.as_tensor(rng.standard_normal((R, cfg.out_chn)),
                          dtype=torch.float32)
    # about 300 rays a slice
    per_ray = max(sfw.plan_shape(sfw._sub_cfg(cfg, g), (b,), 1).capacity
                  for g, b in enumerate(bricks))
    monkeypatch.setattr(sfw, "PLAN_MAX_RUNS", 300 * per_ray)
    rows = tgs.grid_row_offsets(cfg.output_grid_sizes)
    feat = enc.new_zeros((cfg.v_total, cfg.out_chn))
    w = enc.new_zeros((cfg.v_total, 1))
    n_slices = 0
    for g, brick in enumerate(bricks):
        sub = sfw._sub_cfg(cfg, g)
        for a, b in sfw.ray_slices(cfg, g, brick, R):
            f, ww = _splat_by_plan(sub, tuple(t[a:b] for t in geom),
                                   (enc[a:b], None, None), (brick,))
            feat[rows[g]:rows[g + 1]] += f
            w[rows[g]:rows[g + 1]] += ww
            n_slices += 1
    assert n_slices > len(bricks)
    want = sfw.splat_fwd_torch(cfg, geom, (enc, None, None))
    for got, ref in zip((feat, w), want):
        assert float((got - ref).abs().max()) <= \
            1e-5 * max(float(ref.abs().max()), 1.0)
    assert float(w.sum()) > 0
