"""The splatter adjoint's relu masks on the CPU: the masks that S2's
recording build writes and the plain version replays
(``ops/kernels/splatter_bw.py``), as ``tests/test_torch_r2.py`` holds R2's.
No JAX: the plain splatter's parity with the JAX package is in
``tests/test_torch_splatter.py``, and the kernel's own under its masks in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (phase 6).
"""

import pytest
import torch

import lightplane_tpu_torch as lp
from lightplane_tpu_torch.ops import splatter as smod
from lightplane_tpu_torch.ops.kernels import splatter_bw, splatter_fw

torch.set_num_threads(1)


def _tri(batch, res, chn):
    return ((batch, 1, res, res, chn), (batch, res, 1, res, chn),
            (batch, res, res, 1, chn))


def _splat(n_hidden, out_sizes, in_sizes, R=40, num_samples=10, **kw):
    """The plain adjoint's inputs: rays from a shell at z = -2 toward the
    origin, their encodings, a flat input grid-list and the MLP's flat
    parameters, all from one seeded generator, and a random cotangent of
    the output grid."""
    gen = torch.Generator().manual_seed(0)
    origins = torch.randn((R, 3), generator=gen) / 3 + torch.tensor(
        [0.0, 0.0, -2.0])
    directions = torch.randn((R, 3), generator=gen) * 0.2 - origins
    batch = out_sizes[0][0]
    grid_idx = torch.randint(0, batch, (R,), generator=gen,
                             dtype=torch.int32)
    geom = (directions, origins, torch.full((R,), 0.1),
            torch.full((R,), 3.0), grid_idx)
    sp = lp.init_splatter_params(gen, len(n_hidden) - 1, n_hidden[0],
                                 n_hidden[1], n_hidden[-1], device="cpu")
    v_in = sum(s[0] * s[1] * s[2] * s[3] for s in in_sizes)
    diff = (torch.randn((R, n_hidden[0]), generator=gen) * 0.1,
            torch.randn((v_in, n_hidden[0]), generator=gen) * 0.5,
            sp.mlp_params.detach())
    cfg = smod._SplatCfg(
        num_samples=num_samples,
        num_samples_inf=kw.get("num_samples_inf", 0),
        mask_out_of_bounds_samples=kw.get("mask_out_of_bounds_samples",
                                          False),
        contract_coords=kw.get("contract_coords", False),
        disparity_at_inf=kw.get("disparity_at_inf", 1e-3),
        output_grid_sizes=tuple(out_sizes), input_grid_sizes=tuple(in_sizes),
        n_hidden=tuple(sp.n_hidden))
    g_out = torch.randn((cfg.v_total, cfg.out_chn), generator=gen)
    return cfg, geom, diff, g_out


MASK_CASES = {
    # tests/test_splatter_parity.py's MLP, 8 -> 16 -> 16
    "mlp_voxel": dict(n_hidden=(8, 16, 16), out_sizes=[(2, 8, 8, 8, 16)],
                      in_sizes=[(2, 8, 8, 8, 8)]),
    "deep_triplane_mask": dict(n_hidden=(8, 16, 16, 12),
                               out_sizes=list(_tri(1, 8, 12)),
                               in_sizes=list(_tri(1, 8, 8)),
                               mask_out_of_bounds_samples=True),
    # hidden 40: the kernel's 64-wide build, two mask words per vector
    "wide_contract_background": dict(n_hidden=(8, 40, 16),
                                     out_sizes=[(1, 8, 8, 8, 16)],
                                     in_sizes=list(_tri(1, 8, 8)),
                                     contract_coords=True,
                                     num_samples_inf=3),
}


@pytest.mark.parametrize("n_hidden, want", [
    ((8, 16, 16), (40, 10, 1, 1)),
    ((8, 16, 16, 12), (40, 10, 2, 1)),
    ((8, 40, 16), (40, 10, 1, 2)),
    ((8, 16), (40, 10, 0, 1)),      # one layer: no relu'd vector
])
def test_mask_shape(n_hidden, want):
    cfg = smod._SplatCfg(10, 0, False, False, 1e-5, ((1, 4, 4, 4, 16),),
                         ((1, 4, 4, 4, n_hidden[0]),), n_hidden)
    assert splatter_bw.mask_shape(cfg, 40) == want


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_own_masks_replay_the_plain_adjoint(case):
    """The plain adjoint under the masks its own forward takes equals it
    without them; one flipped bit (unit 0 of the first hidden layer, at the
    first step where it matters) changes that ray's encoding gradient and no
    other ray's."""
    cfg, geom, diff, g_out = _splat(**MASK_CASES[case])
    R = geom[0].shape[0]
    masks = splatter_bw.relu_masks_torch(cfg, geom, diff)
    assert masks.shape == splatter_bw.mask_shape(cfg, R)
    assert masks.count_nonzero() > 0
    plain = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out)
    replay = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out,
                                         relu_masks=masks)
    for a, b in zip(plain, replay):
        assert float((a - b).abs().max()) <= 1e-6

    ray = 7
    for s in range(cfg.tot_num_samples):
        flipped = masks.clone()
        flipped[ray, s, 0, 0] ^= 1
        other = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out,
                                            relu_masks=flipped)
        if not torch.equal(other[2], plain[2]):
            break
    else:
        pytest.fail("no single bit of the ray moved g_mlp")
    g_enc = (other[0] - plain[0]).abs().amax(-1)
    assert float(g_enc[ray]) > 0.0
    g_enc[ray] = 0.0
    assert float(g_enc.max()) == 0.0


def test_masks_need_the_mlp():
    cfg = smod._SplatCfg(4, 0, False, False, 1e-5, ((1, 4, 4, 4, 8),), None,
                         ())
    with pytest.raises(ValueError, match="splatter MLP"):
        splatter_bw.splat_bwd_cuda_relu_masks(cfg, None, None, None)


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_two_pass_adjoint_matches_the_reference(case, monkeypatch):
    """The kernel's two-pass design in plain PyTorch (pass A staging each
    step's MLP input gradient, pass B splatting it by the plan over the
    input grid-list) equals ``splat_bwd_torch``, whole and with the rays in
    slices of 32, and under the same relu masks."""
    cfg, geom, diff, g_out = _splat(**MASK_CASES[case], R=72)
    want = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out)
    masks = splatter_bw.relu_masks_torch(cfg, geom, diff)
    masks[::5] = 0  # a branch that the forward did not take
    want_m = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out,
                                         relu_masks=masks)
    got = splatter_bw.splat_bwd_two_pass_torch(cfg, geom, diff, g_out)
    monkeypatch.setattr(splatter_fw, "PLAN_MAX_RUNS", 1)
    bricks = splatter_fw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    assert len(splatter_bw.adjoint_slices(cfg, bricks, 72)) == 3
    sliced = splatter_bw.splat_bwd_two_pass_torch(cfg, geom, diff, g_out,
                                                  relu_masks=masks)
    for a, b, c, d in zip(want, got, want_m, sliced):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * scale
        assert float((c - d).abs().max()) <= 1e-5 * scale
    assert float((want_m[2] - want[2]).abs().max()) > 0


@pytest.mark.parametrize("steps, C_in, sizes, contract, want", [
    # 32 channels in and out: 12,288 bytes of staged g_in a ray at 96 steps
    # outweigh its run lists over the 128^2 planes
    (96, 32, _tri(1, 128, 32), False, 21824),
    (192, 32, _tri(1, 128, 32), False, 10912),
    # one channel and contraction (a run a step): the run lists bound it
    (64, 1, ((1, 64, 64, 64, 1),), True, 524288),
])
def test_adjoint_slices_cap_staging_and_run_lists(steps, C_in, sizes,
                                                  contract, want):
    """Each slice's staged g_in and its run lists over the input sub-grids,
    and each of its sub-slices' staged g_vec, stay within PLAN_MAX_RUNS
    runs' bytes; the slices cover the rays, all but the last a multiple of
    32 rays."""
    cfg = smod._SplatCfg(steps, 0, False, contract, 1e-5,
                         ((1, 8, 8, 8, C_in),), tuple(sizes),
                         (C_in, 32, C_in))
    bricks = splatter_fw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    R = 1_000_000
    slices = splatter_bw.adjoint_slices(cfg, bricks, R)
    assert slices[0] == (0, want)
    assert slices[-1][1] == R
    cap = 8 * splatter_fw.PLAN_MAX_RUNS
    for (a, b), (c, _) in zip(slices, slices[1:] + [(R, None)]):
        assert b == c and a % 32 == 0
        assert 4 * (b - a) * steps * C_in <= cap
        for gs, brick in zip(cfg.input_grid_sizes, bricks):
            runs = splatter_fw.plan_shape(cfg, (brick,), b - a, (gs,))
            assert 8 * runs.capacity <= cap
        # the gather and pass A over sub-slices of it: their staged g_vec
        sub = splatter_bw.gvec_slices(cfg, a, b)
        assert sub[0][0] == a and sub[-1][1] == b
        for (d, e), (f, _) in zip(sub, sub[1:] + [(b, None)]):
            assert e == f and (d - a) % 32 == 0
            assert 4 * (e - d) * steps * cfg.out_chn <= cap


@pytest.mark.parametrize("case", sorted(MASK_CASES) + ["no_mlp"])
def test_plain_chunks_match_one_step_at_a_time(case, monkeypatch):
    """The plain splat and adjoint, a chunk of steps at a time (the
    default), against the same one step at a time: equal up to the rounding
    of the chunk's larger products and sums."""
    from lightplane_tpu_torch.ops import renderer as rmod

    if case == "no_mlp":
        cfg, geom, diff, g_out = _splat(**MASK_CASES["mlp_voxel"])
        cfg = smod._SplatCfg(cfg.num_samples, 0, False, False, 1e-3,
                             ((2, 8, 8, 8, 8),), None, ())
        diff = (diff[0], None, None)
        g_out = g_out[:, :8].contiguous()
        masks = None
    else:
        cfg, geom, diff, g_out = _splat(**MASK_CASES[case])
        masks = splatter_bw.relu_masks_torch(cfg, geom, diff)

    def run():
        return (splatter_fw.splat_fwd_torch(cfg, geom, diff),
                splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out),
                splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out,
                                            relu_masks=masks))

    chunked = run()
    assert len(smod._splat_chunks(cfg, geom, diff)) == 1
    monkeypatch.setattr(rmod, "PLAIN_CHUNK_STEPS", 1)
    stepped = run()
    for outs_c, outs_s in zip(chunked, stepped):
        for a, b in zip(outs_c, outs_s):
            if a is not None:
                tol = 1e-6 * max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= tol

