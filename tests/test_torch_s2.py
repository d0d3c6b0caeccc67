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
from lightplane_tpu_torch.ops.kernels import splatter_bw

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
