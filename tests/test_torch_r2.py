"""The recompute backward's host-side pieces on the CPU: the opt-in
``grid_idx`` range check, the block-size rule of R2's wrapper, and the relu
masks that R2's recording build writes and the plain version replays
(``ops/kernels/renderer_bw.py``).  No JAX: the masks' parity with the JAX
package is in ``tests/test_torch_grad.py``, and the kernel's own under its
masks in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import pytest
import torch

import lightplane_tpu_torch as lp
from lightplane_tpu_torch.ops import guards
from lightplane_tpu_torch.ops import renderer as rmod
from lightplane_tpu_torch.ops.kernels import renderer_bw, renderer_fw

torch.set_num_threads(1)


def test_grid_idx_check_is_opt_in(monkeypatch):
    """Unset, the check reads nothing back from the tensor; set, it raises
    ``ValueError`` for an index outside ``[0, batches)``."""
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)

    def no_readback(*args, **kw):
        raise AssertionError("read back with the flag unset")

    monkeypatch.delenv("LIGHTPLANE_CHECK_GRID_IDX", raising=False)
    with monkeypatch.context() as m:
        m.setattr(torch, "aminmax", no_readback)
        guards.check_grid_idx(idx, 2, "k")
    monkeypatch.setenv("LIGHTPLANE_CHECK_GRID_IDX", "0")
    guards.check_grid_idx(idx, 2, "k")
    monkeypatch.setenv("LIGHTPLANE_CHECK_GRID_IDX", "1")
    guards.check_grid_idx(idx, 3, "k")
    guards.check_grid_idx(idx[:0], 1, "k")
    with pytest.raises(ValueError, match=r"grid_idx out of range: \[0, 2\]"):
        guards.check_grid_idx(idx, 2, "k")
    with pytest.raises(ValueError, match="out of range"):
        guards.check_grid_idx(torch.tensor([-1, 0]), 1, "k")


# Shared memory per block of R2 at the scene fitter's model (MLPs 2/2/2 of
# width 32, 3 colours: renderer_bw.cu's bw_smem_floats, with the
# weight-gradient sums in shared memory) by rays per block
FIT_SMEM = {128: 190208, 64: 123648, 32: 90368}


@pytest.mark.parametrize("rays, want", [
    (4096, 64),     # the trainer: one wave at every size; 64 was fastest
    (8192, 64),
    (16384, 128),   # 128 blocks of 128 in one wave, 64 or 32 take two
    (65536, 128),   # the render headline: 4 waves, against 8
    (100, 64),
])
def test_block_size_rule(rays, want):
    assert renderer_bw.pick_rays_per_block(rays, FIT_SMEM, 132) == want


def test_block_size_rule_limits():
    # only the narrow sizes fit in a block's shared memory
    tight = {128: 300_000, 64: 240_000, 32: 150_000}
    assert renderer_bw.pick_rays_per_block(65536, tight, 132) == 32
    assert renderer_bw.pick_rays_per_block(
        65536, {r: 300_000 for r in FIT_SMEM}, 132) is None
    # fewer SMs: 4096 rays of 128 take one wave on 32 SMs, of 64 two
    assert renderer_bw.pick_rays_per_block(4096, FIT_SMEM, 32) == 128


def test_mask_packing():
    gen = torch.Generator().manual_seed(0)
    bits = torch.rand((5, 3, 40), generator=gen) > 0.5
    words = renderer_bw.pack_masks(bits, 2)
    assert words.dtype == torch.int32 and words.shape == (5, 3, 2)
    back = renderer_bw.unpack_masks(words)
    assert back.shape == (5, 3, 64)
    assert torch.equal(back[..., :40].bool(), bits)
    assert not back[..., 40:].any()
    # bit 31 set: a negative int32 word
    top = torch.zeros((1, 32), dtype=torch.bool)
    top[0, 31] = True
    assert int(renderer_bw.pack_masks(top, 1)) == -(2**31)


def _march(layers, relu_field=False, scaffold=False, hidden=16, R=40,
           **render_kw):
    gen = torch.Generator().manual_seed(0)
    dp = lp.init_decoder_params(
        gen, n_layers_trunk=layers[0], n_layers_opacity=layers[1],
        n_layers_color=layers[2], input_chn=8, hidden_chn=hidden,
        color_chn=3, opacity_init_bias=-1.0,
        use_separate_color_grid=relu_field, device="cpu")
    origins = torch.randn((R, 3), generator=gen) / 3 + torch.tensor(
        [0.0, 0.0, -2.0])
    directions = torch.randn((R, 3), generator=gen) * 0.2 - origins
    rays = lp.Rays(directions, origins, torch.zeros(R, dtype=torch.int64),
                   torch.full((R,), 0.1), torch.full((R,), 3.0),
                   torch.randn((R, dp.n_hidden_color[0]), generator=gen) * 0.1)
    tri = [(1, 1, 8, 8, 8), (1, 8, 1, 8, 8), (1, 8, 8, 1, 8)]
    grid = [torch.randn(s, generator=gen) * 0.5 for s in tri]
    cgrid = ([torch.randn(s, generator=gen) * 0.5 for s in tri]
             if relu_field else None)
    if scaffold:
        render_kw["scaffold"] = (torch.rand((1, 6, 6, 6), generator=gen)
                                 > 0.3).float()
    flat = lp.process_and_flatten_grid(grid, cgrid)
    cfg, geom, diff = rmod._march_inputs(rays, *flat, dp, num_samples=10,
                                         gain=1.5, **render_kw)
    nlt = renderer_fw.render_fwd_torch(cfg, geom, diff)[1]
    g_out = (torch.randn(R, generator=gen), torch.randn(R, generator=gen),
             torch.randn((R, 3), generator=gen))
    return cfg, geom, diff, nlt, g_out


MASK_CASES = {
    "trunk": dict(layers=(2, 2, 2)),
    "no_trunk_deep_heads": dict(layers=(0, 3, 3), hidden=8),
    "one_layer_each": dict(layers=(1, 1, 1)),
    "relu_field_scaffold": dict(layers=(0, 2, 2), relu_field=True,
                                scaffold=True),
    "wide_mask_noise": dict(layers=(2, 2, 2), hidden=40,
                            mask_out_of_bounds_samples=True,
                            inject_noise_sigma=1.0, inject_noise_seed=3),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_own_masks_replay_the_plain_backward(case):
    """The plain backward under the masks its own forward takes equals it
    without them; one flipped bit (unit 0 of the first relu'd vector, at
    the first step from the far end where it matters) changes that ray's
    gradients and no other ray's."""
    cfg, geom, diff, nlt, g_out = _march(**MASK_CASES[case])
    R = geom[0].shape[0]
    masks = renderer_bw.relu_masks_torch(cfg, geom, diff)
    assert masks.shape == renderer_bw.mask_shape(cfg, R, diff[0].shape[1])
    assert masks.count_nonzero() > 0
    plain = renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
    replay = renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out,
                                          relu_masks=masks)
    for a, b in zip(plain, replay):
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-6

    ray = 7
    for s in reversed(range(cfg.tot_num_samples)):
        flipped = masks.clone()
        flipped[ray, s, 0, 0] ^= 1
        other = renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out,
                                             relu_masks=flipped)
        if not torch.equal(other[2], plain[2]):
            break
    else:
        pytest.fail("no single bit of the ray moved g_mlp")
    g_enc = (other[3] - plain[3]).abs().amax(-1)
    g_enc[ray] = 0.0
    assert float(g_enc.max()) == 0.0


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_plain_chunks_match_one_step_at_a_time(case, monkeypatch):
    """The plain forward and backward, a chunk of steps at a time (the
    default), against the same one step at a time: the same per-sample
    arithmetic, so equal up to the rounding of the chunk's larger matrix
    products and sums."""
    cfg, geom, diff, nlt, g_out = _march(**MASK_CASES[case])
    assert len(rmod._chunk_steps(range(cfg.tot_num_samples), 40, 8)) == 1
    masks = renderer_bw.relu_masks_torch(cfg, geom, diff)
    chunked = (renderer_fw.render_fwd_torch(cfg, geom, diff),
               renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out),
               renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out,
                                            relu_masks=masks))
    monkeypatch.setattr(rmod, "PLAIN_CHUNK_STEPS", 1)
    stepped = (renderer_fw.render_fwd_torch(cfg, geom, diff),
               renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out),
               renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out,
                                            relu_masks=masks))
    for outs_c, outs_s in zip(chunked, stepped):
        for a, b in zip(outs_c, outs_s):
            if a is not None:
                tol = 1e-6 * max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= tol


@pytest.mark.parametrize("rays, width, on_card, want", [
    (40, 8, False, [10]),               # all ten steps in one chunk
    (4096, 32, False, [32, 32, 6]),     # PLAIN_CHUNK_STEPS
    (65536, 32, False, [2] * 35),       # PLAIN_CHUNK_FLOATS: 2 x 65536 x 32
    (32768, 512, False, [1] * 70),      # one step: one activation is 2^24
    (65536, 32, True, [32, 32, 6]),     # PLAIN_CHUNK_FLOATS_CARD
    (32768, 512, True, [4] * 17 + [2]),
])
def test_plain_chunk_sizes(rays, width, on_card, want):
    steps = range(10) if rays == 40 else range(70)
    chunks = rmod._chunk_steps(steps, rays, width, on_card)
    assert [len(c) for c in chunks] == want
    assert [s for c in chunks for s in c] == list(steps)

