"""The CUDA kernels (the renderer's forward march and recompute backward,
with their scaffold and relu-field branches, the splatter's splat and
adjoint, and their wide builds) against their plain PyTorch versions, on
the card.  Every test is marked ``cuda`` and skips
where no CUDA device is available; the file imports neither JAX nor the JAX
package, so it runs on a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import lightplane_tpu_torch as lp
from lightplane_tpu_torch.ops.kernels import (
    renderer_bw,
    renderer_fw,
    splatter_bw,
    splatter_fw,
)

# f32 on both sides; the rounding differs (fused multiply-adds, summation
# order, CUDA's expf/logf), so the bound is looser than the CPU tests' 1e-4
MAX_ABS = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(device, grid_shapes, batch=1, n_rays=512, layers=(2, 2, 2),
          hidden=16, seed=0, colours=3):
    rng = np.random.default_rng(seed)
    origins = rng.standard_normal((n_rays, 3)) / 3.0 + np.array([0, 0, -2.0])
    directions = rng.standard_normal((n_rays, 3)) * 0.2 - origins
    gen = torch.Generator().manual_seed(seed)
    dp = lp.init_decoder_params(
        gen, n_layers_trunk=layers[0], n_layers_opacity=layers[1],
        n_layers_color=layers[2], input_chn=grid_shapes[0][-1],
        hidden_chn=hidden, color_chn=colours, opacity_init_bias=-1.0,
        device=device,
    )

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    rays = lp.Rays(
        directions=t(directions), origins=t(origins),
        grid_idx=t(rng.integers(0, batch, n_rays), torch.int64),
        near=t(0.1 + 0.05 * rng.random(n_rays)),
        far=t(3.0 + 0.2 * rng.random(n_rays)),
        encoding=t(rng.standard_normal((n_rays, dp.n_hidden_color[0])) * 0.1),
    )
    grid = [t(rng.standard_normal(s) * 0.5) for s in grid_shapes]
    return rays, grid, dp


CASES = {
    # the wide builds: a 96-wide decoder (hidden 72 padded up) with noise,
    # and a 128-channel grid under a 32-wide decoder
    "wide_hidden72_noise": (
        dict(grid_shapes=[(1, 1, 12, 12, 8), (1, 12, 12, 1, 8)], hidden=72),
        dict(inject_noise_sigma=1.0, inject_noise_seed=3),
    ),
    "wide_grid128_mask": (
        dict(grid_shapes=[(1, 10, 10, 10, 128)], hidden=32),
        dict(mask_out_of_bounds_samples=True),
    ),
    # one-layer heads over a 98-channel grid (W = 128; rows not a multiple
    # of 4 floats: the scalar gather and reductions), and no trunk at W = 96
    "wide_layers_1_1_1_grid98": (
        dict(grid_shapes=[(1, 10, 10, 10, 98)], hidden=40, layers=(1, 1, 1)),
        {},
    ),
    "wide_layers_0_1_1": (
        dict(grid_shapes=[(1, 12, 12, 12, 80)], hidden=80, layers=(0, 1, 1)),
        {},
    ),
    # past 128: one-layer heads at hidden 160 (W = 192; R2 a warpgroup, the
    # products by wgmma m64n192k8 and m64n128k8), and a 256-channel grid
    # under a 256-wide decoder (R2 2 warps, mma.sync)
    "wide_hidden160_layers_1_1_1": (
        dict(grid_shapes=[(1, 1, 12, 12, 24), (1, 12, 12, 1, 24)], hidden=160,
             layers=(1, 1, 1)),
        {},
    ),
    "wide_grid256_hidden256_mask": (
        dict(grid_shapes=[(1, 10, 10, 10, 256)], hidden=256),
        dict(mask_out_of_bounds_samples=True),
    ),
    "mixed_batch2_mask_noise": (
        dict(grid_shapes=[(2, 8, 8, 8, 8), (2, 1, 8, 8, 8)], batch=2),
        dict(mask_out_of_bounds_samples=True, inject_noise_sigma=1.0,
             inject_noise_seed=3),
    ),
    "contract_samples_inf": (
        dict(grid_shapes=[(1, 1, 16, 16, 12), (1, 16, 1, 16, 12)],
             layers=(1, 3, 1), hidden=40),
        dict(contract_coords=True, num_samples_inf=4, disparity_at_inf=1e-3),
    ),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case):
    setup_kw, render_kw = CASES[case]
    rays, grid, dp = _case(cuda, **setup_kw)
    kw = dict(num_samples=32, gain=1.5, **render_kw)
    before = renderer_fw.LAUNCHES
    with torch.no_grad():
        out_k = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
        out_p = lp.lightplane_renderer(rays, grid, dp, impl="torch", **kw)
    torch.cuda.synchronize()
    assert renderer_fw.LAUNCHES == before + 1
    for name, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
        assert a.shape == b.shape, name
        scale = max(1.0, float(b.abs().max())) if "num_samples_inf" in kw \
            else 1.0  # background samples reach nlt ~ 1e3
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * scale, f"{name}: max |diff| {err}"


# The forward kernel's edges: a warp marches 32 samples at a time, so
# sample counts that are not a multiple of 32, chunks that the scaffold
# shuts whole or in part, and the width-64 and no-trunk layer orders
_TRI16 = [(1, 1, 16, 16, 16), (1, 16, 1, 16, 16), (1, 16, 16, 1, 16)]
FW_EDGES = {
    "samples_37": (dict(grid_shapes=_TRI16), dict(num_samples=37)),
    "samples_37_inf8": (dict(grid_shapes=_TRI16),
                        dict(num_samples=37, num_samples_inf=8,
                             disparity_at_inf=1e-3)),
    "scaffold_all_shut": (dict(grid_shapes=_TRI16), dict(scaffold=0.0)),
    "scaffold_part_shut": (dict(grid_shapes=_TRI16), dict(scaffold=0.5)),
    "scaffold_all_open": (dict(grid_shapes=_TRI16), dict(scaffold=1.0)),
    "w64_layers_1_3_2": (dict(grid_shapes=[(1, 12, 12, 12, 40)], hidden=48,
                              layers=(1, 3, 2)), {}),
    "w32_layers_0_1_3": (dict(grid_shapes=[(1, 12, 12, 12, 16)],
                              layers=(0, 1, 3)), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FW_EDGES))
def test_forward_kernel_edges(cuda, case):
    """R1 against its plain version where its 32-sample chunks meet the
    march's edges; a chunk whose gates are all shut adds exactly 0."""
    setup_kw, render_kw = FW_EDGES[case]
    rays, grid, dp = _case(cuda, **setup_kw)
    kw = dict(num_samples=70, gain=1.5)
    kw.update(render_kw)
    fill = kw.pop("scaffold", None)
    if fill is not None:
        # 70 samples: the rays leave the [-1, 1] cube, outside which a
        # scaffold gates every sample, before their third chunk, which is
        # shut whole; the first two are shut in part
        sc = torch.full((1, 8, 8, 8), 1.0 if fill else 0.0, device=cuda)
        if fill == 0.5:
            sc[:, :4] = 0.0
        kw["scaffold"] = sc
    before = renderer_fw.LAUNCHES
    with torch.no_grad():
        out_k = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
        out_p = lp.lightplane_renderer(rays, grid, dp, impl="torch", **kw)
    torch.cuda.synchronize()
    assert renderer_fw.LAUNCHES == before + 1
    for name, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
        scale = max(1.0, float(b.abs().max()))  # nlt ~ 1e3 with background
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * scale, f"{name}: max |diff| {err}"
        if fill == 0.0:
            assert float(a.abs().max()) == 0.0, name
    if fill:
        assert float(out_k[1].max()) > 0.0


def _grads(rays, grid, dp, impl, proj, **kw):
    """Gradients of ``sum(proj * outputs)`` w.r.t. the grid-list,
    ``mlp_params`` and ``rays.encoding``."""
    grid = [g.detach().clone().requires_grad_(True) for g in grid]
    mlp = dp.mlp_params.detach().clone().requires_grad_(True)
    enc = rays.encoding.detach().clone().requires_grad_(True)
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    dp = lp.DecoderParams(mlp, dp.n_hidden_trunk, dp.n_hidden_opacity,
                          dp.n_hidden_color, dp.color_chn)
    out = lp.lightplane_renderer(rays, grid, dp, impl=impl, **kw)
    sum((o * p).sum() for o, p in zip(out, proj)).backward()
    return [g.grad for g in grid] + [mlp.grad, enc.grad]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain(cuda, case):
    setup_kw, render_kw = CASES[case]
    rays, grid, dp = _case(cuda, **setup_kw)
    kw = dict(num_samples=32, gain=1.5, **render_kw)
    gen = torch.Generator().manual_seed(1)
    n = len(rays)
    proj = [torch.randn(s, generator=gen).to(cuda)
            for s in [(n,), (n,), (n, 3)]]
    before = renderer_bw.LAUNCHES
    g_k = _grads(rays, grid, dp, "cuda", proj, **kw)
    torch.cuda.synchronize()
    assert renderer_bw.LAUNCHES == before + 1
    g_p = _grads(rays, grid, dp, "torch", proj, **kw)
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        assert a.shape == b.shape, i
        # f32 rounding differs (atomics' order, fused multiply-adds): the
        # bound scales with the gradient's magnitude
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * scale, f"grad {i}: max |diff| {err}"


def _branch_case(device, branch, chn=16):
    """A scaffold (random binary, over a batch of 2) or a relu-field colour
    grid-list on top of a triplane case (the grids and the decoder ``chn``
    wide)."""
    if branch == "scaffold":
        rays, grid, dp = _case(device, _tri(2, 12, 8), batch=2, seed=3)
        gen = torch.Generator().manual_seed(4)
        scaffold = (torch.rand((2, 10, 9, 8), generator=gen) > 0.5).float()
        return rays, grid, dp, dict(scaffold=scaffold.to(device),
                                    contract_coords=True)
    rays, grid, dp = _case(device, [(2, 8, 8, 8, chn)], batch=2,
                           layers=(0, 2, 2), hidden=chn, seed=5)
    rng = np.random.default_rng(6)
    cgrid = [torch.as_tensor(rng.standard_normal(s) * 0.5,
                             dtype=torch.float32, device=device)
             for s in _tri(2, 10, chn)]
    return rays, grid, dp, dict(color_grid=cgrid,
                                mask_out_of_bounds_samples=True)


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["scaffold", "relu_field"])
def test_branch_kernels_match_plain(cuda, branch):
    """R1 and R2 with scaffold gating (R3) or the relu-field colour grid
    (R1-rf): outputs and gradients (the colour grid's too)."""
    rays, grid, dp, extra = _branch_case(cuda, branch)
    kw = dict(num_samples=32, gain=1.5, **extra)
    gated = int(branch == "scaffold")
    with torch.no_grad():
        before = renderer_fw.LAUNCHES
        sc_before = renderer_fw.SCAFFOLD_LAUNCHES
        out_k = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
        out_p = lp.lightplane_renderer(rays, grid, dp, impl="torch", **kw)
        torch.cuda.synchronize()
        assert renderer_fw.LAUNCHES == before + 1
        assert renderer_fw.SCAFFOLD_LAUNCHES == sc_before + gated
    for name, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS, f"{name}: max |diff| {err}"
    assert float(out_p[1].abs().max()) > 0.0
    gen = torch.Generator().manual_seed(1)
    n = len(rays)
    proj = [torch.randn(s, generator=gen).to(cuda)
            for s in [(n,), (n,), (n, 3)]]
    cgrid = extra.get("color_grid")

    def grads(impl):
        leaves = [g.detach().clone().requires_grad_(True)
                  for g in cgrid or []]
        k = dict(kw, color_grid=leaves or None)
        return _grads(rays, grid, dp, impl, proj, **k) + [g.grad
                                                          for g in leaves]

    before = renderer_bw.LAUNCHES
    sc_before = renderer_bw.SCAFFOLD_LAUNCHES
    g_k = grads("cuda")
    torch.cuda.synchronize()
    assert renderer_bw.LAUNCHES == before + 1
    assert renderer_bw.SCAFFOLD_LAUNCHES == sc_before + gated
    g_p = grads("torch")
    assert len(g_k) == len(grid) + 2 + len(cgrid or [])
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        assert a.shape == b.shape, i
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * scale, f"grad {i}: max |diff| {err}"
        assert float(b.abs().max()) > 0.0, f"grad {i} is zero"


@pytest.mark.cuda
def test_training_step_launches_each_kernel_once(cuda):
    rays, grid, dp = _case(cuda, [(1, 1, 16, 16, 16), (1, 16, 1, 16, 16),
                                  (1, 16, 16, 1, 16)], n_rays=300)
    grid = [g.requires_grad_(True) for g in grid]
    dp.mlp_params.requires_grad_(True)
    fw, bw = renderer_fw.LAUNCHES, renderer_bw.LAUNCHES
    depth, nlt, feat = lp.lightplane_renderer(rays, grid, dp, num_samples=24,
                                              gain=1.0)
    (feat.square().mean() + depth.mean()).backward()
    torch.cuda.synchronize()
    assert (renderer_fw.LAUNCHES, renderer_bw.LAUNCHES) == (fw + 1, bw + 1)
    for g in grid + [dp.mlp_params]:
        assert torch.isfinite(g.grad).all() and g.grad.abs().sum() > 0


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_run(cuda):
    rays, grid, dp = _case(cuda, [(1, 8, 8, 8, 8)], n_rays=64)
    kw = dict(num_samples=8, gain=1.0)
    # inputs that require grad run: the backward kernel exists
    dp.mlp_params.requires_grad_(True)
    lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)[2].sum().backward()
    assert torch.isfinite(dp.mlp_params.grad).all()
    # so does a scaffold (R3), through both kernels
    fw, bw = renderer_fw.LAUNCHES, renderer_bw.LAUNCHES
    dp.mlp_params.grad = None
    lp.lightplane_renderer(
        rays, grid, dp, impl="cuda",
        scaffold=torch.ones((1, 4, 4, 4), device=cuda), **kw,
    )[2].sum().backward()
    torch.cuda.synchronize()
    assert (renderer_fw.LAUNCHES, renderer_bw.LAUNCHES) == (fw + 1, bw + 1)
    assert torch.isfinite(dp.mlp_params.grad).all()
    with torch.no_grad():
        # past the widest build (512), under "cuda" and under "auto": no
        # CUDA call falls back to the plain version
        wide = lp.init_decoder_params(None, 2, 2, 2, input_chn=8,
                                      hidden_chn=520, device=cuda)
        enc = torch.zeros((64, 520), device=cuda)
        rays_w = lp.Rays(rays.directions, rays.origins, rays.grid_idx,
                         rays.near, rays.far, enc)
        for impl in ("cuda", "auto"):
            with pytest.raises(ValueError, match="widths up to 512"):
                lp.lightplane_renderer(rays_w, grid, wide, impl=impl, **kw)
        short = lp.DecoderParams(dp.mlp_params.detach()[:-1],
                                 dp.n_hidden_trunk, dp.n_hidden_opacity,
                                 dp.n_hidden_color, dp.color_chn)
        with pytest.raises(ValueError, match="mlp_params has"):
            lp.lightplane_renderer(rays, grid, short, impl="cuda", **kw)


@pytest.mark.cuda
def test_kernels_with_bad_grid_idx(cuda, monkeypatch):
    """A ray whose grid_idx lies outside every grid's batch renders and
    splats nothing, and no launch reads a value back unless
    LIGHTPLANE_CHECK_GRID_IDX=1, which raises for it."""
    rays, grid, dp = _case(cuda, [(1, 8, 8, 8, 16)], n_rays=64)
    out = [(1, 8, 8, 8, 16)]  # the encoding's 16 channels, splatted
    kw = dict(num_samples=8, gain=1.0)
    bad = rays.grid_idx.clone()
    bad[::2] = 1
    bad[1::4] = -3
    rays_b = lp.Rays(rays.directions, rays.origins, bad, rays.near, rays.far,
                     rays.encoding)
    monkeypatch.delenv("LIGHTPLANE_CHECK_GRID_IDX", raising=False)
    grid_p = [g.clone().requires_grad_(True) for g in grid]
    depth, nlt, feat = lp.lightplane_renderer(rays_b, grid_p, dp, impl="cuda",
                                              **kw)
    (feat.sum() + depth.sum()).backward()
    torch.cuda.synchronize()
    good = bad == 0
    ref = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
    # the good rays render as before; the bad ones see an empty grid
    assert torch.allclose(nlt[good], ref[1][good], atol=1e-6)
    empty = lp.lightplane_renderer(rays, [torch.zeros_like(g) for g in grid],
                                   dp, impl="cuda", **kw)
    assert torch.allclose(nlt[~good], empty[1][~good], atol=1e-6)
    assert all(torch.isfinite(g.grad).all() for g in grid_p)
    splat = lp.lightplane_splatter(rays_b, out, num_samples=8,
                                   return_list=False, impl="cuda")
    splat_good = lp.lightplane_splatter(
        lp.Rays(rays.directions[good], rays.origins[good], bad[good],
                rays.near[good], rays.far[good], rays.encoding[good]),
        out, num_samples=8, return_list=False, impl="cuda")
    assert torch.allclose(splat, splat_good, atol=1e-5)
    # the opt-in host check
    monkeypatch.setenv("LIGHTPLANE_CHECK_GRID_IDX", "1")
    with pytest.raises(ValueError, match="grid_idx out of range"):
        lp.lightplane_renderer(rays_b, grid, dp, impl="cuda", **kw)
    with pytest.raises(ValueError, match="grid_idx out of range"):
        lp.lightplane_splatter(rays_b, out, num_samples=8, impl="cuda")
    # a grid_idx within the grid's batch of 2 but past the scaffold's
    rays_1 = lp.Rays(rays.directions, rays.origins,
                     torch.ones_like(rays.grid_idx), rays.near, rays.far,
                     rays.encoding)
    with pytest.raises(ValueError, match="grid_idx out of range"):
        lp.lightplane_renderer(
            rays_1, [torch.cat([g, g]) for g in grid], dp, impl="cuda",
            scaffold=torch.ones((1, 4, 4, 4), device=cuda), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case, rays_per_block", [
    ("triplane", 128), ("triplane", 64), ("triplane", 32),
    ("relu_field_scaffold", 128), ("relu_field_scaffold", 32),
    # too deep for the weight-gradient sums in shared memory: they stay in
    # the block's row of the partial buffer
    ("deep_8_8_8", 32),
    # the wide build (W = 128: 128-channel grids and decoder; a warp per
    # ray, rays_per_block not read), with the relu-field colour grid and a
    # scaffold
    ("wide_relu_field_scaffold", 32),
])
def test_backward_kernel_matches_plain_under_its_masks(cuda, case,
                                                        rays_per_block):
    """R2 (tensor-core weight gradient at width 32) against its plain
    version under the relu masks its recording build took, on every ray's
    cotangent."""
    from lightplane_tpu_torch.ops import renderer as rmod

    if case == "triplane":
        rays, grid, dp = _case(cuda, _tri(1, 16, 32), n_rays=600, hidden=32)
        extra = {}
    elif case == "deep_8_8_8":
        rays, grid, dp = _case(cuda, _tri(1, 12, 32), n_rays=300, hidden=32,
                               layers=(8, 8, 8))
        extra = {}
    else:
        rays, grid, dp, extra = _branch_case(
            cuda, "relu_field", chn=128 if case.startswith("wide") else 16)
        extra["scaffold"] = (torch.rand(
            (2, 8, 8, 8), generator=torch.Generator().manual_seed(2)) > 0.4
        ).float().to(cuda)
    flat = lp.process_and_flatten_grid(grid, extra.pop("color_grid", None))
    cfg, geom, diff = rmod._march_inputs(rays, *flat, dp, num_samples=32,
                                         gain=1.5, **extra)
    gen = torch.Generator().manual_seed(1)
    n = len(rays)
    g_out = tuple(torch.randn(s, generator=gen).to(cuda)
                  for s in [(n,), (n,), (n, 3)])
    with torch.no_grad():
        nlt = renderer_fw.render_fwd_cuda(cfg, geom, diff)[1]
        got, masks = renderer_bw.render_bwd_cuda_relu_masks(
            cfg, geom, diff, nlt, g_out, rays_per_block=rays_per_block)
        want = renderer_bw.render_bwd_torch(cfg, geom, diff, nlt, g_out,
                                            relu_masks=masks)
    assert masks.shape == renderer_bw.mask_shape(cfg, n, diff[0].shape[1])
    assert int(masks.count_nonzero()) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None:
            continue
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * float(b.abs().max()), f"grad {i}: {err}"


@pytest.mark.cuda
def test_kernels_at_the_layer_and_grid_caps(cuda):
    """R1 and R2 at the lifted caps: 16 sub-grids (planes of a few
    resolutions) and a 16-layer trunk, against their plain versions."""
    assert renderer_fw.MAX_GRIDS == 16 and renderer_fw.MAX_LAYERS == 16
    shapes = [s for res in (6, 8, 10, 12, 14) for s in _tri(1, res, 8)]
    shapes.append((1, 6, 6, 6, 8))
    assert len(shapes) == 16
    rays, grid, dp = _case(cuda, shapes, n_rays=256, layers=(16, 1, 1))
    kw = dict(num_samples=24, gain=1.5)
    fw, bw = renderer_fw.LAUNCHES, renderer_bw.LAUNCHES
    with torch.no_grad():
        out_k = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
        out_p = lp.lightplane_renderer(rays, grid, dp, impl="torch", **kw)
    for name, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS, f"{name}: max |diff| {err}"
    gen = torch.Generator().manual_seed(1)
    proj = [torch.randn(s, generator=gen).to(cuda)
            for s in [(256,), (256,), (256, 3)]]
    g_k = _grads(rays, grid, dp, "cuda", proj, **kw)
    g_p = _grads(rays, grid, dp, "torch", proj, **kw)
    torch.cuda.synchronize()
    assert (renderer_fw.LAUNCHES, renderer_bw.LAUNCHES) == (fw + 2, bw + 1)
    for i, (a, b) in enumerate(zip(g_k, g_p)):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * max(1.0, float(b.abs().max())), (
            f"grad {i}: max |diff| {err}")


def _tri(batch, res, chn):
    return [(batch, 1, res, res, chn), (batch, res, 1, res, chn),
            (batch, res, res, 1, chn)]


def _wide_parity(rays, grid, dp, **kw):
    """R1 against its plain version, and R2 against its plain version under
    the relu masks its recording build took, on every ray (the wide builds'
    bounds: max |d| <= MAX_ABS, and MAX_ABS x max |g|)."""
    from lightplane_tpu_torch.ops import renderer as rmod

    flat = lp.process_and_flatten_grid(grid, kw.pop("color_grid", None))
    cfg, geom, diff = rmod._march_inputs(rays, *flat, dp, **kw)
    assert renderer_fw._kernel_width(cfg, diff[0].shape[1]) > 64
    n = len(rays)
    gen = torch.Generator().manual_seed(1)
    g_out = tuple(torch.randn(s, generator=gen).to(rays.origins.device)
                  for s in [(n,), (n,), (n, cfg.out_chn)])
    fw, bw = renderer_fw.LAUNCHES, renderer_bw.LAUNCHES
    with torch.no_grad():
        out_k = renderer_fw.render_fwd_cuda(cfg, geom, diff)
        out_p = renderer_fw.render_fwd_torch(cfg, geom, diff)
        got, masks = renderer_bw.render_bwd_cuda_relu_masks(
            cfg, geom, diff, out_k[1], g_out)
        want = renderer_bw.render_bwd_torch(cfg, geom, diff, out_k[1], g_out,
                                            relu_masks=masks)
    torch.cuda.synchronize()
    assert (renderer_fw.LAUNCHES, renderer_bw.LAUNCHES) == (fw + 1, bw + 1)
    for name, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * max(1.0, float(b.abs().max())), (
            f"{name}: max |diff| {err}")
    assert float(out_k[1].max()) > 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None:
            continue
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * float(b.abs().max()), f"grad {i}: {err}"
    return cfg, geom, diff


def _facing_rays(device, n, hidden_enc, seed=7):
    """Rays that alternate between coming from z = -2 toward +z and from
    z = +2 toward -z, so that a scaffold of the half-space z > 0 shuts the
    first chunks of one kind and the last chunks of the other, in every
    block."""
    rng = np.random.default_rng(seed)
    side = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    origins = rng.standard_normal((n, 3)) * 0.2
    origins[:, 2] = 2.0 * side
    directions = rng.standard_normal((n, 3)) * 0.1
    directions[:, 2] = -side

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return lp.Rays(
        directions=t(directions), origins=t(origins),
        grid_idx=t(np.zeros(n), torch.int64), near=t(np.full(n, 0.5)),
        far=t(np.full(n, 3.5)),
        encoding=t(rng.standard_normal((n, hidden_enc)) * 0.1))


@pytest.mark.cuda
def test_wide_block_with_rays_gated_in_different_chunks(cuda):
    """W = 128: a scaffold of the half-space z > 0 over rays that cross it
    in opposite directions, so each block of R1 and R2 runs chunks where
    some of its rays sample and others are shut whole."""
    rays, grid, dp = _case(cuda, _tri(1, 12, 128), n_rays=64, hidden=128)
    rays = _facing_rays(cuda, 64, dp.n_hidden_color[0])
    scaffold = torch.zeros((1, 8, 8, 8), device=cuda)
    scaffold[:, 4:] = 1.0  # z > 0 (the D axis is z)
    _wide_parity(rays, grid, dp, num_samples=64, gain=1.5,
                 scaffold=scaffold)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [8, 4, 2])
def test_wide_forward_by_wgmma_and_by_mma_sync(cuda, warps):
    """R1 at W = 128 with 8 and 4 warps a block (its products by wgmma, a
    warpgroup's 64 rows at a time) and with 2 (by mma.sync, a warp's 16
    rows) against its plain version."""
    from lightplane_tpu_torch.ops import renderer as rmod

    rays, grid, dp = _case(cuda, _tri(1, 12, 32), n_rays=200, hidden=128)
    flat = lp.process_and_flatten_grid(grid, None)
    cfg, geom, diff = rmod._march_inputs(rays, *flat, dp, num_samples=48,
                                         gain=1.5)
    with torch.no_grad():
        out_k = renderer_fw.render_fwd_cuda(cfg, geom, diff,
                                            warps_per_block=warps)
        out_p = renderer_fw.render_fwd_torch(cfg, geom, diff)
    torch.cuda.synchronize()
    for name, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS, f"{name}: max |diff| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [37, 5])
def test_wide_ray_count_not_a_multiple_of_the_block(cuda, n_rays):
    """Ray counts that leave the last block of R1 (8 warps) and R2 (4 at
    W = 128) part-empty, and one smaller than a block."""
    rays, grid, dp = _case(cuda, _tri(1, 12, 32), n_rays=n_rays, hidden=128)
    _wide_parity(rays, grid, dp, num_samples=40, gain=1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("layers, hidden", [((3, 4, 4), 128),
                                            ((0, 1, 1), 128),
                                            ((6, 5, 5), 96),
                                            ((3, 3, 3), 256),
                                            ((3, 4, 4), 256),
                                            ((5, 5, 5), 192),
                                            ((0, 1, 2), 256)])
def test_wide_deep_and_shallow_mlps(cuda, layers, hidden):
    """11 layers at W = 128 and 256, 15 at 192 and 16 at 96 (blocks of
    fewer than 4 warps: the products by mma.sync), the 3/3/3 decoder at 256
    (one warp a block), the shallowest decoder (a one-layer colour head, no
    trunk) and at 256 one whose R2 takes a warpgroup (its products by
    wgmma m64n256k8, and so R1's)."""
    # with no trunk the heads read the grid's channels
    chn = hidden if layers[0] == 0 else 32
    rays, grid, dp = _case(cuda, _tri(1, 10, chn), n_rays=96, hidden=hidden,
                           layers=layers)
    _wide_parity(rays, grid, dp, num_samples=24, gain=1.5)


# past 256: hidden 320 (W = 384) and 512, each with and without the
# relu-field colour grid and a scaffold, and the feature path's decoder
# (512 colours: the colour head's last product in two N-parts, its tile in
# device memory)
PAST_256 = {
    "hidden320": dict(chn=32, hidden=320),
    "hidden512": dict(chn=32, hidden=512),
    "hidden320_relu_field_scaffold": dict(chn=320, relu_field=True),
    "hidden512_relu_field_scaffold": dict(chn=512, relu_field=True),
    "feature512": dict(chn=512, hidden=512, colours=512),
}


def _past_256_case(device, name):
    c = PAST_256[name]
    extra = dict(num_samples=24, gain=1.5)
    if c.get("relu_field"):
        rays, grid, dp, branch = _branch_case(device, "relu_field",
                                              chn=c["chn"])
        rays = lp.Rays(rays.directions[:96], rays.origins[:96],
                       rays.grid_idx[:96], rays.near[:96], rays.far[:96],
                       rays.encoding[:96])
        extra.update(branch)
        extra["scaffold"] = (torch.rand(
            (2, 8, 8, 8), generator=torch.Generator().manual_seed(2)) > 0.4
        ).float().to(device)
    else:
        rays, grid, dp = _case(device, _tri(1, 10, c["chn"]), n_rays=96,
                               hidden=c["hidden"],
                               colours=c.get("colours", 3))
    return rays, grid, dp, extra


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAST_256))
def test_wide_past_256_matches_plain(cuda, name):
    """R1 at W = 384 and 512 against its plain version, and R2 against its
    plain version under the relu masks its recording build took, on every
    ray, with the relu-field colour grid and a scaffold too."""
    rays, grid, dp, extra = _past_256_case(cuda, name)
    cfg, _, diff = _wide_parity(rays, grid, dp, **extra)
    assert renderer_fw._kernel_width(cfg, diff[0].shape[1]) in (384, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hidden320", "hidden512",
                                  "hidden512_relu_field_scaffold",
                                  "feature512"])
def test_wide_forward_equals_the_recomputed_forward(cuda, name):
    """R1's forward and R2's recomputed forward past 256, each by its
    recording build's probe (every open step's raw opacity and the sum of
    its raw colours), are equal to the bit."""
    from lightplane_tpu_torch.ops import renderer as rmod

    rays, grid, dp, extra = _past_256_case(cuda, name)
    flat = lp.process_and_flatten_grid(grid, extra.pop("color_grid", None))
    cfg, geom, diff = rmod._march_inputs(rays, *flat, dp, **extra)
    n = len(rays)
    g_out = tuple(torch.randn(s, generator=torch.Generator().manual_seed(3)
                              ).to(cuda)
                  for s in [(n,), (n,), (n, cfg.out_chn)])
    with torch.no_grad():
        r1, r2 = renderer_bw.forward_probes(cfg, geom, diff, g_out)
    torch.cuda.synchronize()
    assert int((r1 != 0).sum()) > 0
    assert torch.equal(r1, r2)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256, 512])
@pytest.mark.parametrize("backward", [False, True])
def test_wide_pack_kernel_matches_its_plain_version(cuda, backward, width):
    """The wide kernels' pre-pass equals ``pack_wide_torch`` bit for bit,
    and the wrapper's plan the C side's (at 256 products of 1 to 32
    N-tiles, one k-step a slice past 16; at 512 products of up to 64
    N-tiles in N-parts of 32, the colour head's last layer among them)."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build

    n_t, n_o, n_c = 1, 2, 2
    head = {128: (32, 128) + (128, 72, 1) + (128, 72, 3),
            256: (8, 256) + (256, 200, 1) + (256, 160, 3),
            512: (8, 512) + (512, 200, 1) + (512, 320, 512)}[width]
    layers = renderer_fw.wide_layers(n_t, n_o, n_c, head)
    n_params = sum(i * o + o for i, o, _, _ in layers)
    mlp = torch.randn(n_params, generator=torch.Generator().manual_seed(2))
    products = renderer_fw.wide_products(layers, n_t, n_o, backward)
    want = renderer_fw.pack_wide_torch(mlp, layers, products)
    lib = _build.library()
    widths = (ctypes.c_int * len(head))(*head)
    ws = torch.full((want.numel(),), -1, dtype=torch.int32, device=cuda)
    mlp_d = mlp.to(cuda)
    rc = lib.lightplane_render_wide_pack(
        mlp_d.data_ptr(), n_t, n_o, n_c, widths, int(backward),
        ws.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(ws.cpu().reshape(-1, 4), want)
    conf = (ctypes.c_int * 6)()
    assert lib.lightplane_render_bw_wide_config(width, n_t, n_o, n_c, widths,
                                                0, conf) == 0
    plan = renderer_bw.wide_bw_plan(width, n_t, n_o, n_c, head, False)
    assert (conf[0], conf[3], conf[4], conf[2], conf[5]) == (
        plan.warps, plan.smem_bytes, plan.workspace_bytes, plan.row_floats,
        plan.scratch_bytes)


SPLAT_CASES = {
    "triplane_batch2_mask": dict(out_sizes=_tri(2, 12, 16), batch=2,
                                 kw=dict(mask_out_of_bounds_samples=True)),
    "voxel_6ch_samples_inf": dict(out_sizes=[(1, 10, 12, 14, 6)],
                                  kw=dict(num_samples_inf=3,
                                          disparity_at_inf=1e-3)),
    "mlp_contract": dict(out_sizes=[(1, 12, 12, 12, 16)], mlp=(8, 16, 16),
                         in_sizes=_tri(1, 12, 8),
                         kw=dict(contract_coords=True)),
    # the module's default MLP width: 64 output channels, the 64-wide builds
    "mlp_64ch_out": dict(out_sizes=[(1, 10, 12, 14, 64)], mlp=(32, 32, 64),
                         in_sizes=_tri(1, 12, 32), kw={}),
    # the wide builds: a 96-wide MLP (72 padded up), and a 128-wide one
    # into 128 channels from a 128-channel input grid-list (pass B's splat
    # in two passes of 64 channels)
    "mlp_wide_72": dict(out_sizes=_tri(1, 12, 16), mlp=(8, 72, 16),
                        in_sizes=_tri(1, 12, 8),
                        kw=dict(mask_out_of_bounds_samples=True)),
    "mlp_wide_128ch": dict(out_sizes=[(1, 10, 12, 14, 128)],
                           mlp=(128, 32, 128), in_sizes=_tri(1, 12, 128),
                           kw={}),
    # past 128: a 160-wide MLP (W = 192), and 32 -> 256 -> 256 into a
    # 256-channel triplane (W = 256)
    "mlp_wide_160": dict(out_sizes=_tri(1, 12, 24), mlp=(8, 160, 24),
                         in_sizes=_tri(1, 12, 8),
                         kw=dict(mask_out_of_bounds_samples=True)),
    "mlp_wide_256ch": dict(out_sizes=_tri(1, 12, 256), mlp=(32, 256, 256),
                           in_sizes=_tri(1, 12, 32), kw={}),
}


def _splat_case(device, out_sizes, batch=1, mlp=None, in_sizes=None,
                n_rays=512, seed=0):
    rng = np.random.default_rng(seed)
    origins = rng.standard_normal((n_rays, 3)) / 3.0 + np.array([0, 0, -2.0])
    directions = rng.standard_normal((n_rays, 3)) * 0.2 - origins

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    enc_chn = mlp[0] if mlp else out_sizes[0][-1]
    rays = lp.Rays(
        directions=t(directions), origins=t(origins),
        grid_idx=t(rng.integers(0, batch, n_rays), torch.int64),
        near=t(0.1 + 0.05 * rng.random(n_rays)),
        far=t(3.0 + 0.2 * rng.random(n_rays)),
        encoding=t(rng.standard_normal((n_rays, enc_chn)) * 0.1),
    )
    sp = igrid = None
    if mlp:
        sp = lp.init_splatter_params(torch.Generator().manual_seed(seed),
                                     len(mlp) - 1, mlp[0], mlp[1], mlp[-1],
                                     device=device)
        igrid = [t(rng.standard_normal(s) * 0.5) for s in in_sizes]
    return rays, sp, igrid


def _splat_grads(rays, out_sizes, sp, igrid, impl, proj, **kw):
    """The raw accumulators, and the gradients of ``sum(proj * grid)``
    w.r.t. the encoding (and the input grid-list and ``mlp_params``)."""
    enc = rays.encoding.detach().clone().requires_grad_(True)
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    leaves = [enc]
    if sp is None:
        raw = lp.lightplane_splatter_raw(rays, out_sizes, impl=impl, **kw)
        out = lp.lightplane_splatter(rays, out_sizes, return_list=False,
                                     impl=impl, **kw)
    else:
        igrid = [g.detach().clone().requires_grad_(True) for g in igrid]
        sp = lp.SplatterParams(
            sp.mlp_params.detach().clone().requires_grad_(True), sp.n_hidden)
        leaves += igrid + [sp.mlp_params]
        raw = lp.lightplane_splatter_raw(rays, out_sizes, sp, igrid,
                                         impl=impl, **kw)
        out = lp.lightplane_mlp_splatter(rays, out_sizes, sp, igrid,
                                         return_list=False, impl=impl, **kw)
    (out * proj).sum().backward()
    return [t.detach() for t in raw] + [x.grad for x in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPLAT_CASES))
def test_splat_kernels_match_plain(cuda, case):
    c = dict(SPLAT_CASES[case])
    kw = dict(num_samples=24, **c.pop("kw"))
    rays, sp, igrid = _splat_case(cuda, **c)
    out_sizes = c["out_sizes"]
    V = sum(int(np.prod(s[:-1])) for s in out_sizes)
    proj = torch.randn((V, out_sizes[0][-1]),
                       generator=torch.Generator().manual_seed(1)).to(cuda)
    before = (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES,
              splatter_bw.MLP_LAUNCHES)
    got = _splat_grads(rays, out_sizes, sp, igrid, "cuda", proj, **kw)
    torch.cuda.synchronize()
    # one splat for the raw call and one for the loss; one adjoint, counted
    # also as one with the MLP when the case has one
    assert (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES,
            splatter_bw.MLP_LAUNCHES) == (
        before[0] + 2, before[1] + 1, before[2] + (sp is not None))
    want = _splat_grads(rays, out_sizes, sp, igrid, "torch", proj, **kw)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        # the atomics reorder the sums: the bound scales with the magnitude
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * max(1.0, float(b.abs().max())), (
            f"output {i}: max |diff| {err}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp_contract", "mlp_64ch_out",
                                  "mlp_wide_72", "mlp_wide_128ch",
                                  "mlp_wide_160", "mlp_wide_256ch"])
def test_splat_adjoint_matches_plain_under_its_masks(cuda, case):
    """S2 with the MLP against its plain version under the relu masks its
    recording build took, on every ray, and the shipped build against the
    recording one."""
    from lightplane_tpu_torch.ops import splatter as smod

    c = dict(SPLAT_CASES[case])
    kw = dict(num_samples=24, **c.pop("kw"))
    rays, sp, igrid = _splat_case(cuda, **c)
    out_sizes, in_sizes = c["out_sizes"], c["in_sizes"]
    cfg = smod._SplatCfg(
        kw["num_samples"], 0, kw.get("mask_out_of_bounds_samples", False),
        kw.get("contract_coords", False), 1e-5,
        tuple(out_sizes), tuple(in_sizes), tuple(sp.n_hidden))
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    diff = (rays.encoding, torch.cat([g.reshape(-1, g.shape[-1])
                                      for g in igrid]), sp.mlp_params)
    g_out = torch.randn((cfg.v_total, cfg.out_chn),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.no_grad():
        got, masks = splatter_bw.splat_bwd_cuda_relu_masks(cfg, geom, diff,
                                                           g_out)
        shipped = splatter_bw.splat_bwd_cuda(cfg, geom, diff, g_out)
        want = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out,
                                           relu_masks=masks)
    assert masks.shape == splatter_bw.mask_shape(cfg, len(rays))
    assert int(masks.count_nonzero()) > 0
    for i, (a, b, c_) in enumerate(zip(got, want, shipped)):
        bound = MAX_ABS * float(b.abs().max())
        assert float((a - b).abs().max()) <= bound, f"grad {i}"
        assert float((c_ - a).abs().max()) <= bound, f"grad {i}, shipped"


@pytest.mark.cuda
def test_splat_kernels_reject_what_they_do_not_run(cuda, monkeypatch):
    monkeypatch.setenv("LIGHTPLANE_CHECK_GRID_IDX", "1")
    rays, sp, igrid = _splat_case(cuda, [(1, 8, 8, 8, 16)], mlp=(8, 264, 16),
                                  in_sizes=[(1, 8, 8, 8, 8)], n_rays=64)
    with pytest.raises(ValueError, match="widths up to 256"):
        lp.lightplane_mlp_splatter(rays, [(1, 8, 8, 8, 16)], sp, igrid,
                                   num_samples=8, impl="cuda")
    rays, _, _ = _splat_case(cuda, [(1, 8, 8, 8, 16)], n_rays=64)
    rays_b = lp.Rays(rays.directions, rays.origins, rays.grid_idx + 1,
                     rays.near, rays.far, rays.encoding)
    with pytest.raises(ValueError, match="grid_idx out of range"):
        lp.lightplane_splatter(rays_b, [(1, 8, 8, 8, 16)], num_samples=8,
                               impl="cuda")


def _splat_geom(device, out_sizes, n_rays, num_samples=24, seed=0, **kw):
    """``(cfg, geom, diff)`` of a splat without MLP, as
    ``lightplane_splatter`` hands them to S1."""
    from lightplane_tpu_torch.ops import splatter as smod

    rays, _, _ = _splat_case(device, out_sizes, batch=out_sizes[0][0],
                             n_rays=n_rays, seed=seed)
    cfg = smod._SplatCfg(num_samples, kw.get("num_samples_inf", 0),
                         kw.get("mask_out_of_bounds_samples", False),
                         kw.get("contract_coords", False),
                         kw.get("disparity_at_inf", 1e-3),
                         tuple(out_sizes), None, ())
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    return cfg, geom, (rays.encoding, None, None)


# S1's shapes: (output sizes, rays, march keywords, bricks or None for the
# wrapper's pick); "crowded" sends 4096 rays through an 8^3 grid of one
# brick, which then holds more runs than a work item takes (RUNS_PER_ITEM)
S1_CASES = {
    "voxel": ([(1, 20, 18, 16, 16)], 2048, {}, None),
    "triplane": (_tri(1, 24, 32), 2048, {}, None),
    "batched_mask": ([(3, 12, 12, 12, 8)], 2048,
                     dict(mask_out_of_bounds_samples=True), (2, 3, 4)),
    "chn6_samples_inf": ([(1, 10, 12, 14, 6)], 2048,
                         dict(num_samples_inf=3), (3, 2, 2)),
    "crowded": ([(1, 8, 8, 8, 16)], 4096, {}, (8, 8, 8)),
}


def _grid_bricks(bricks, out_sizes):
    """``bricks`` (cells along D, H, W) for each output sub-grid, 1 along
    its singleton axes; None stays None."""
    if bricks is None:
        return None
    return tuple(tuple(c if size > 1 else 1 for c, size in zip(bricks, gs[1:4]))
                 for gs in out_sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(S1_CASES))
def test_splat_fwd_kernel_matches_plain(cuda, case):
    """S1 (plan, prefix sums, splat by bricks) against ``splat_fwd_torch``:
    the raw accumulators within 1e-3 x max |ref|."""
    out_sizes, n, kw, bricks = S1_CASES[case]
    cfg, geom, diff = _splat_geom(cuda, out_sizes, n, **kw)
    bricks = _grid_bricks(bricks, out_sizes)
    if case == "crowded":
        counts = splatter_fw.splat_plan_cuda(cfg, geom, diff, bricks)[0]
        assert int(counts.max()) > splatter_fw.RUNS_PER_ITEM
    before = splatter_fw.LAUNCHES
    with torch.no_grad():
        got = splatter_fw.splat_fwd_cuda(cfg, geom, diff, bricks=bricks)
        want = splatter_fw.splat_fwd_torch(cfg, geom, diff)
    torch.cuda.synchronize()
    assert splatter_fw.LAUNCHES == before + 1
    for name, a, b in zip(("feat", "w"), got, want):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * float(b.abs().max()), f"{name}: {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(S1_CASES))
def test_splat_plan_kernels_match_plain(cuda, case):
    """The plan's count and fill passes equal ``splat_plan_torch`` exactly
    once each brick's runs are sorted."""
    out_sizes, n, kw, bricks = S1_CASES[case]
    cfg, geom, diff = _splat_geom(cuda, out_sizes, n, **kw)
    bricks = _grid_bricks(bricks, out_sizes) or splatter_fw.pick_bricks(cfg)
    shape = splatter_fw.plan_shape(cfg, bricks, n)
    with torch.no_grad():
        plain = splatter_fw.splat_plan_torch(cfg, geom, bricks)
        for g in range(len(out_sizes)):
            counts, offsets, runs = splatter_fw.splat_plan_cuda(
                cfg, geom, diff, bricks, grid=g)
            want = splatter_fw.plan_slice(*plain, shape, g)
            assert torch.equal(counts, want[0])
            assert torch.equal(offsets, want[1])
            # the runs fit the list sized from the shapes (the fill pass
            # traps where they do not)
            assert int(offsets[-1]) <= runs.shape[0]
            got = splatter_fw.canonical_runs(counts, offsets, runs)
            assert torch.equal(got, want[2])
            assert got.shape[0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["voxel", "triplane", "batched_mask"])
def test_splat_fwd_kernel_in_ray_slices_matches_plain(cuda, case,
                                                      monkeypatch):
    """S1 with run lists of at most 500 rays' runs plans and splats each
    sub-grid's rays in slices (``ray_slices``), and still matches
    ``splat_fwd_torch``."""
    out_sizes, n, kw, bricks = S1_CASES[case]
    cfg, geom, diff = _splat_geom(cuda, out_sizes, n, **kw)
    bricks = _grid_bricks(bricks, out_sizes) or splatter_fw.pick_bricks(cfg)
    per_ray = max(splatter_fw.plan_shape(splatter_fw._sub_cfg(cfg, g), (b,),
                                         1).capacity
                  for g, b in enumerate(bricks))
    monkeypatch.setattr(splatter_fw, "PLAN_MAX_RUNS", 500 * per_ray)
    slices = sum(len(splatter_fw.ray_slices(cfg, g, b, n))
                 for g, b in enumerate(bricks))
    assert slices > len(bricks)
    plans = splatter_fw.PLAN_LAUNCHES
    with torch.no_grad():
        got = splatter_fw.splat_fwd_cuda(cfg, geom, diff, bricks=bricks)
        want = splatter_fw.splat_fwd_torch(cfg, geom, diff)
    torch.cuda.synchronize()
    assert splatter_fw.PLAN_LAUNCHES - plans == slices
    for name, a, b in zip(("feat", "w"), got, want):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * float(b.abs().max()), f"{name}: {err}"


def _adjoint_march(device, case, n_rays=512):
    """``(cfg, geom, diff)`` of a SPLAT_CASES case as the splatter hands
    them to S2, and a random cotangent of the raw features."""
    from lightplane_tpu_torch.ops import splatter as smod

    c = dict(SPLAT_CASES[case])
    kw = c.pop("kw")
    rays, sp, igrid = _splat_case(device, n_rays=n_rays, **c)
    out_sizes, in_sizes = c["out_sizes"], c.get("in_sizes")
    cfg = smod._SplatCfg(
        24, kw.get("num_samples_inf", 0),
        kw.get("mask_out_of_bounds_samples", False),
        kw.get("contract_coords", False), kw.get("disparity_at_inf", 1e-5),
        tuple(out_sizes), None if sp is None else tuple(in_sizes),
        () if sp is None else tuple(sp.n_hidden))
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    diff = (rays.encoding, None, None)
    if sp is not None:
        diff = (rays.encoding, torch.cat([g.reshape(-1, g.shape[-1])
                                          for g in igrid]), sp.mlp_params)
    g_out = torch.randn((cfg.v_total, cfg.out_chn),
                        generator=torch.Generator().manual_seed(1)).to(device)
    return cfg, geom, diff, g_out


@pytest.mark.cuda
@pytest.mark.parametrize("chn", [3, 6, 16, 32, 64, 100, 128, 200])
def test_splat_adjoint_gather_matches_plain(cuda, chn):
    """S2 without the MLP (lanes own scalars, pairs or quads of a row;
    several rays a warp below 64 channels, passes over the row above 128)
    against ``splat_bwd_torch`` on every ray, and bit-identical across two
    runs."""
    from lightplane_tpu_torch.ops import splatter as smod

    out_sizes = [(2, 9, 10, 11, chn)]
    rays, _, _ = _splat_case(cuda, out_sizes, batch=2, n_rays=300)
    cfg = smod._SplatCfg(20, 2, True, False, 1e-3, tuple(out_sizes), None,
                         ())
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    diff = (rays.encoding, None, None)
    g_out = torch.randn((cfg.v_total, chn),
                        generator=torch.Generator().manual_seed(2)).to(cuda)
    before = (splatter_bw.LAUNCHES, splatter_bw.MLP_LAUNCHES)
    with torch.no_grad():
        got = splatter_bw.splat_bwd_cuda(cfg, geom, diff, g_out)[0]
        again = splatter_bw.splat_bwd_cuda(cfg, geom, diff, g_out)[0]
        want = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out)[0]
    torch.cuda.synchronize()
    assert (splatter_bw.LAUNCHES, splatter_bw.MLP_LAUNCHES) == (
        before[0] + 2, before[1])
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= MAX_ABS * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp_contract", "mlp_64ch_out",
                                  "mlp_wide_72", "mlp_wide_128ch",
                                  "mlp_wide_256ch"])
def test_splat_adjoint_in_ray_slices(cuda, case, monkeypatch):
    """S2 with the MLP with its staging and run lists capped at ~100 rays,
    so that it runs pass A and pass B over slices of the rays, against its
    plain version under its relu masks; g_enc and g_mlp bit-identical
    across two runs."""
    cfg, geom, diff, g_out = _adjoint_march(cuda, case)
    bricks = splatter_fw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    monkeypatch.setattr(splatter_fw, "PLAN_MAX_RUNS",
                        100 * cfg.tot_num_samples * cfg.n_hidden[0] // 2)
    slices = splatter_bw.adjoint_slices(cfg, bricks, geom[0].shape[0])
    assert len(slices) > 2
    with torch.no_grad():
        got, masks = splatter_bw.splat_bwd_cuda_relu_masks(cfg, geom, diff,
                                                           g_out)
        again, _ = splatter_bw.splat_bwd_cuda_relu_masks(cfg, geom, diff,
                                                         g_out)
        want = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_out,
                                           relu_masks=masks)
    for i, (a, b) in enumerate(zip(got, want)):
        err = float((a - b).abs().max())
        assert err <= MAX_ABS * float(b.abs().max()), f"grad {i}: {err}"
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp_contract", "mlp_64ch_out"])
def test_splat_adjoint_plan_over_the_input_grids(cuda, case):
    """Pass B's plan over the input grid-list equals ``splat_plan_torch``
    exactly once each brick's runs are sorted."""
    cfg, geom, diff, _ = _adjoint_march(cuda, case)
    sizes = cfg.input_grid_sizes
    bricks = splatter_fw.pick_bricks(cfg, grid_sizes=sizes)
    shape = splatter_fw.plan_shape(cfg, bricks, geom[0].shape[0], sizes)
    with torch.no_grad():
        plain = splatter_fw.splat_plan_torch(cfg, geom, bricks, sizes)
        for g in range(len(sizes)):
            counts, offsets, runs = splatter_fw.splat_plan_cuda(
                cfg, geom, diff, bricks, grid=g, inputs=True)
            want = splatter_fw.plan_slice(*plain, shape, g)
            assert torch.equal(counts, want[0])
            assert torch.equal(offsets, want[1])
            got = splatter_fw.canonical_runs(counts, offsets, runs)
            assert torch.equal(got, want[2]) and got.shape[0] > 0


@pytest.mark.cuda
def test_splat_adjoint_does_not_spill(cuda):
    """Neither S2's gathers nor its pass A at W = 32 or 64 spills."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build

    out = (ctypes.c_int * 3)()
    lib = _build.library()
    for mlp, width in ((0, 0), (1, 32), (1, 64), (2, 0), (3, 0)):
        assert lib.lightplane_splat_bw_attrs(mlp, width, out) == 0
        assert out[1] == 0, (mlp, width, out[0], out[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp_wide_72", "mlp_wide_128ch",
                                  "mlp_wide_160", "mlp_wide_256ch"])
def test_wide_splat_fwd_in_ray_slices(cuda, case, monkeypatch):
    """S1's wide MLP build with its staging capped at ~100 rays, so that
    pass F and pass S run over slices of the rays, against
    ``splat_fwd_torch`` and its own two-pass plain version; one pass F a
    slice, one plan a slice and output sub-grid."""
    cfg, geom, diff, _ = _adjoint_march(cuda, case)
    monkeypatch.setattr(splatter_fw, "PLAN_MAX_RUNS",
                        100 * cfg.tot_num_samples * cfg.out_chn // 2)
    bricks = splatter_fw.pick_bricks(cfg)
    slices = splatter_fw.mlp_slices(cfg, bricks, geom[0].shape[0])
    assert len(slices) > 2
    plans = splatter_fw.PLAN_LAUNCHES
    with torch.no_grad():
        got = splatter_fw.splat_fwd_cuda(cfg, geom, diff)
        torch.cuda.synchronize()
        assert splatter_fw.PLAN_LAUNCHES - plans == len(slices) * len(bricks)
        want = splatter_fw.splat_fwd_torch(cfg, geom, diff)
        two_pass = splatter_fw.splat_fwd_two_pass_torch(cfg, geom, diff)
    for name, a, b, c in zip(("feat", "w"), got, want, two_pass):
        bound = MAX_ABS * float(b.abs().max())
        assert float((a - b).abs().max()) <= bound, name
        assert float((c - b).abs().max()) <= bound, name


@pytest.mark.cuda
@pytest.mark.parametrize("n_hidden", [(32, 128, 128), (8, 72, 100),
                                      (128, 32, 128), (32, 256, 256),
                                      (8, 160, 24), (32, 160, 256)])
def test_wide_splat_pack_and_plans(cuda, n_hidden):
    """The layers' pre-pass with the splatter's schedules (S1's pass F, S2's
    pass A) equals ``pack_wide_torch`` bit for bit, and the C side plans
    pass F and pass A as the wrappers do."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build

    width = next(w for w in renderer_fw.WIDTHS if max(n_hidden) <= w)
    L = len(n_hidden) - 1
    layers = renderer_fw.wide_layers(L, 0, 0, n_hidden)
    n_params = sum(i * o + o for i, o, _, _ in layers)
    mlp = torch.randn(n_params, generator=torch.Generator().manual_seed(4))
    lib = _build.library()
    widths = (ctypes.c_int * len(n_hidden))(*n_hidden)
    mlp_d = mlp.to(cuda)
    for schedule, backward in ((2, False), (3, True)):
        want = renderer_fw.pack_wide_torch(
            mlp, layers, splatter_fw.splat_products(layers, backward))
        ws = torch.full((want.numel(),), -1, dtype=torch.int32, device=cuda)
        rc = lib.lightplane_render_wide_pack(
            mlp_d.data_ptr(), L, 0, 0, widths, schedule, ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.equal(ws.cpu().reshape(-1, 4), want), schedule
    fw = (ctypes.c_int * 3)()
    assert lib.lightplane_splat_fw_mlp_config(width, L, widths, fw) == 0
    assert tuple(fw) == (
        splatter_fw.PASS_F_WARPS, splatter_fw.pass_f_smem_bytes(width),
        renderer_fw.wide_pack_bytes(splatter_fw.splat_products(layers,
                                                               False)))
    bw = (ctypes.c_int * 5)()
    assert lib.lightplane_splat_bw_mlp_config(width, L, widths, bw) == 0
    assert (bw[0], bw[3], bw[4]) == (
        *splatter_bw.wide_a_plan(width, n_hidden),
        renderer_fw.wide_pack_bytes(splatter_fw.splat_products(layers,
                                                               True)))
