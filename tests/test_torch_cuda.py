"""The CUDA forward-march kernel against its plain PyTorch version, on the
card.  Every test is marked ``cuda`` and skips where no CUDA device is
available; the file imports neither JAX nor the JAX package, so it runs on
a GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import lightplane_tpu_torch as lp
from lightplane_tpu_torch.ops.kernels import renderer_fw

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
          hidden=16, seed=0):
    rng = np.random.default_rng(seed)
    origins = rng.standard_normal((n_rays, 3)) / 3.0 + np.array([0, 0, -2.0])
    directions = rng.standard_normal((n_rays, 3)) * 0.2 - origins
    gen = torch.Generator().manual_seed(seed)
    dp = lp.init_decoder_params(
        gen, n_layers_trunk=layers[0], n_layers_opacity=layers[1],
        n_layers_color=layers[2], input_chn=grid_shapes[0][-1],
        hidden_chn=hidden, color_chn=3, opacity_init_bias=-1.0,
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


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_run(cuda):
    rays, grid, dp = _case(cuda, [(1, 8, 8, 8, 8)], n_rays=64)
    kw = dict(num_samples=8, gain=1.0)
    dp.mlp_params.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="R2"):
        lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="R3"):
            lp.lightplane_renderer(
                rays, grid, dp, impl="cuda",
                scaffold=torch.ones((1, 4, 4, 4), device=cuda), **kw,
            )
        wide = lp.init_decoder_params(None, 2, 2, 2, input_chn=8,
                                      hidden_chn=72, device=cuda)
        enc = torch.zeros((64, 72), device=cuda)
        rays_w = lp.Rays(rays.directions, rays.origins, rays.grid_idx,
                         rays.near, rays.far, enc)
        with pytest.raises(ValueError, match="widths up to 64"):
            lp.lightplane_renderer(rays_w, grid, wide, impl="cuda", **kw)
        short = lp.DecoderParams(dp.mlp_params.detach()[:-1],
                                 dp.n_hidden_trunk, dp.n_hidden_opacity,
                                 dp.n_hidden_color, dp.color_chn)
        with pytest.raises(ValueError, match="mlp_params has"):
            lp.lightplane_renderer(rays, grid, short, impl="cuda", **kw)
        rays_b = lp.Rays(rays.directions, rays.origins, rays.grid_idx + 1,
                         rays.near, rays.far, rays.encoding)
        with pytest.raises(ValueError, match="grid_idx out of range"):
            lp.lightplane_renderer(rays_b, grid, dp, impl="cuda", **kw)
