"""The PyTorch port's renderer against the JAX package: the naive oracle,
the fused forward (plain PyTorch path on the CPU) and its dispatch.

The JAX side runs as its own CPU tests run it: ``impl="scan"``.  The
kernel itself is tested on the GPU by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_fw  # noqa: E402

from .port_utils import (  # noqa: E402
    compare_outputs,
    decoder_to_torch,
    grid_to_torch,
    rays_to_torch,
)
from .utils import random_decoder_params, random_grid, random_rays  # noqa: E402

torch.set_num_threads(1)


def _setup(seed, n_rays=64, batch=1, grid_type="triplane", channels=8,
           resolution=8, n_layers_trunk=2):
    k_rays, k_grid, k_dec = jax.random.split(jax.random.PRNGKey(seed), 3)
    dp = random_decoder_params(k_dec, input_chn=channels, hidden_chn=16,
                               n_layers_trunk=n_layers_trunk)
    rays = random_rays(k_rays, n_rays, batch,
                       encoding_dim=dp.n_hidden_color[0])
    grid = random_grid(k_grid, batch, channels, resolution, grid_type,
                       scale=0.5)
    return rays, grid, dp


NAIVE_CASES = {
    "triplane": (dict(), dict()),
    "voxel_batch2_mask": (dict(batch=2, grid_type="voxel"),
                          dict(mask_out_of_bounds_samples=True)),
    "contract": (dict(grid_type="mixed"), dict(contract_coords=True)),
    "noise_inf": (dict(), dict(inject_noise_sigma=0.7, inject_noise_seed=5,
                               num_samples_inf=3, disparity_at_inf=1e-3)),
}


@pytest.mark.parametrize("checkpointing", [False, True])
@pytest.mark.parametrize("case", sorted(NAIVE_CASES))
def test_naive_renderer_matches_jax(case, checkpointing):
    setup_kw, render_kw = NAIVE_CASES[case]
    rays, grid, dp = _setup(10, **setup_kw)
    kw = dict(num_samples=12, gain=1.5, **render_kw)
    want = lt.lightplane_renderer_naive(rays, grid, dp, **kw)
    got = lp.lightplane_renderer_naive(
        rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp),
        checkpointing=checkpointing, **kw,
    )
    compare_outputs(want, got,
                    magnitude_scaled="num_samples_inf" in render_kw)


RENDER_CASES = {
    "triplane": (dict(), dict()),
    "voxel": (dict(grid_type="voxel"), dict()),
    "mixed_batch2": (dict(grid_type="mixed", batch=2), dict()),
    "mask_oob": (dict(grid_type="voxel", batch=2),
                 dict(mask_out_of_bounds_samples=True)),
    "contract": (dict(), dict(contract_coords=True)),
    "noise": (dict(), dict(inject_noise_sigma=1.0, inject_noise_seed=3)),
    "samples_inf": (dict(), dict(num_samples_inf=4, disparity_at_inf=1e-3)),
    "samples_inf_noise": (dict(), dict(num_samples_inf=3,
                                       disparity_at_inf=1e-3,
                                       inject_noise_sigma=0.5,
                                       inject_noise_seed=-4)),
    "no_trunk": (dict(n_layers_trunk=0, channels=16), dict()),
    "image_size_noise": (dict(n_rays=16 * 24),
                         dict(image_size=(16, 24), inject_noise_sigma=1.0,
                              inject_noise_seed=9)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_renderer_matches_jax_scan(case):
    setup_kw, render_kw = RENDER_CASES[case]
    rays, grid, dp = _setup(20, **setup_kw)
    kw = dict(num_samples=16, gain=1.5, **render_kw)
    want = lt.lightplane_renderer(rays, grid, dp, impl="scan", **kw)
    before = renderer_fw.LAUNCHES
    got = lp.lightplane_renderer(
        rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp), **kw
    )
    assert renderer_fw.LAUNCHES == before  # CPU tensors never launch
    assert got[2].shape == (len(rays), dp.color_chn)
    # background samples reach nlt ~ 1e3: bounds scale with the magnitude,
    # as in the JAX package's own parity tests
    compare_outputs(want, got,
                    magnitude_scaled="num_samples_inf" in render_kw)


def test_renderer_far_background_matches_jax_naive():
    """At the default disparity_at_inf=1e-5 the last background sample sits
    at t = far * 1e5, where the depth schedule's ``1 - f`` term is
    ill-conditioned: the JAX scan path departs from the JAX naive oracle by
    about 0.3% of nlt there.  The port evaluates the schedule as written and
    is compared with the JAX oracle (the configs above use 1e-3 against the
    scan path)."""
    rays, grid, dp = _setup(20)
    kw = dict(num_samples=16, gain=1.5, num_samples_inf=3,
              inject_noise_sigma=0.5, inject_noise_seed=-4)
    want = lt.lightplane_renderer_naive(rays, grid, dp, **kw)
    got = lp.lightplane_renderer(
        rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp), **kw
    )
    compare_outputs(want, got, magnitude_scaled=True)


def test_flat_grid_input_matches_list():
    rays, grid, dp = _setup(30, grid_type="mixed")
    rt, gt, dt = rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp)
    flat, sizes = lp.flatten_grid(gt)
    a = lp.lightplane_renderer(rt, gt, dt, num_samples=8, gain=1.0)
    b = lp.lightplane_renderer(rt, flat, dt, num_samples=8, gain=1.0,
                               grid_sizes=sizes, tile_rays=256,
                               w3_budget=(12, 16, 16))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_plain_path_gradients_match_jax():
    """On the CPU the plain march is differentiable by autograd: its
    gradients match the JAX package's custom-VJP scan core."""
    rays, grid, dp = _setup(40, grid_type="voxel", n_rays=32)
    kw = dict(num_samples=10, gain=1.5)
    proj = [np.random.default_rng(i).standard_normal(s).astype(np.float32)
            for i, s in enumerate([(32,), (32,), (32, 3)])]

    def loss_j(grid, mlp_params, enc):
        r = dataclasses.replace(rays, encoding=enc)
        d = dataclasses.replace(dp, mlp_params=mlp_params)
        out = lt.lightplane_renderer(r, grid, d, impl="scan", **kw)
        return sum(jnp.sum(o * p) for o, p in zip(out, proj))

    g_want = jax.grad(loss_j, argnums=(0, 1, 2))(
        grid, dp.mlp_params, rays.encoding
    )
    rt, gt, dt = rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp)
    for t in gt + [dt.mlp_params, rt.encoding]:
        t.requires_grad_(True)
    out = lp.lightplane_renderer(rt, gt, dt, **kw)
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(out, proj)).backward()
    got = (gt[0].grad, dt.mlp_params.grad, rt.encoding.grad)
    compare_outputs(
        (g_want[0][0], g_want[1], g_want[2]), got,
        names=("g_grid", "g_mlp", "g_enc"),
    )


def test_dispatch_on_cpu():
    rays, grid, dp = _setup(50, n_rays=8)
    rt, gt, dt = rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp)
    before = renderer_fw.LAUNCHES
    auto = lp.lightplane_renderer(rt, gt, dt, num_samples=4, gain=1.0)
    plain = lp.lightplane_renderer(rt, gt, dt, num_samples=4, gain=1.0,
                                   impl="torch")
    for x, y in zip(auto, plain):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lp.lightplane_renderer(rt, gt, dt, num_samples=4, gain=1.0,
                               impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        lp.lightplane_renderer(rt, gt, dt, num_samples=4, gain=1.0,
                               impl="pallas")
    with pytest.raises(ValueError, match="inject_noise_seed"):
        lp.lightplane_renderer(rt, gt, dt, num_samples=4, gain=1.0,
                               inject_noise_sigma=1.0)
    assert renderer_fw.LAUNCHES == before
