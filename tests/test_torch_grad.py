"""Gradients of the PyTorch port against the JAX package: the recompute
backward (``_RenderCore`` with ``render_bwd_torch`` on the CPU), the module's
parameter gradients, the O(1)-in-samples memory of the backward, the
finite-gradient guard and the grid-list utilities.

The JAX side runs as its own CPU tests run it (``impl="scan"``).  The
backward kernel itself is tested on the GPU by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
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
from lightplane_tpu.utils import grid_utils as jgu  # noqa: E402
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_bw  # noqa: E402
from lightplane_tpu_torch.utils import grid_utils as tgu  # noqa: E402

from .port_utils import (  # noqa: E402
    compare_outputs,
    decoder_to_torch,
    grid_to_torch,
    rays_to_torch,
)
from .test_torch_renderer import RENDER_CASES, _setup  # noqa: E402
from .utils import random_grid, random_rays  # noqa: E402

torch.set_num_threads(1)


def _projections(seed, n_rays, color_chn=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(n_rays,), (n_rays,), (n_rays, color_chn)]]


def _torch_grads(rays, grid, dp, proj, **kw):
    """Gradients of ``sum(proj * outputs)`` w.r.t. the port's grid-list,
    ``mlp_params`` and ``rays.encoding``."""
    rt, gt, dt = rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp)
    for t in gt + [dt.mlp_params, rt.encoding]:
        t.requires_grad_(True)
    out = lp.lightplane_renderer(rt, gt, dt, **kw)
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(out, proj)).backward()
    return [g.grad for g in gt] + [dt.mlp_params.grad, rt.encoding.grad]


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_renderer_grads_match_jax_scan(case):
    setup_kw, render_kw = RENDER_CASES[case]
    if "n_rays" not in setup_kw:
        setup_kw = dict(setup_kw, n_rays=64)
    rays, grid, dp = _setup(60, **setup_kw)
    kw = dict(num_samples=10, gain=1.5, **render_kw)
    proj = _projections(1, len(rays))

    def loss_j(grid, mlp_params, enc):
        r = dataclasses.replace(rays, encoding=enc)
        d = dataclasses.replace(dp, mlp_params=mlp_params)
        out = lt.lightplane_renderer(r, grid, d, impl="scan", **kw)
        return sum(jnp.sum(o * p) for o, p in zip(out, proj))

    g_grid, g_mlp, g_enc = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        grid, dp.mlp_params, rays.encoding
    )
    before = renderer_bw.LAUNCHES
    got = _torch_grads(rays, grid, dp, proj, **kw)
    assert renderer_bw.LAUNCHES == before  # CPU tensors never launch
    names = [f"g_grid{i}" for i in range(len(grid))] + ["g_mlp", "g_enc"]
    # background samples put gradients at O(1/disparity_at_inf): bounds
    # scale with the magnitude, as in the JAX package's own parity tests
    compare_outputs(list(g_grid) + [g_mlp, g_enc], got, names=names,
                    magnitude_scaled="num_samples_inf" in kw)


@pytest.mark.parametrize("case", ["triplane", "mask_oob", "noise",
                                  "no_trunk", "contract"])
def test_grads_under_own_relu_masks_match_jax_scan(case):
    """The plain reverse march replaying the relu masks that its forward
    takes (the masks R2's recording build writes on the card) against
    ``jax.grad`` of ``impl="scan"``."""
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_fw

    setup_kw, render_kw = RENDER_CASES[case]
    rays, grid, dp = _setup(61, **dict(setup_kw, n_rays=48))
    kw = dict(num_samples=10, gain=1.5, **render_kw)
    proj = _projections(3, len(rays))

    def loss_j(grid, mlp_params, enc):
        r = dataclasses.replace(rays, encoding=enc)
        d = dataclasses.replace(dp, mlp_params=mlp_params)
        out = lt.lightplane_renderer(r, grid, d, impl="scan", **kw)
        return sum(jnp.sum(o * p) for o, p in zip(out, proj))

    g_grid, g_mlp, g_enc = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2)))(
        grid, dp.mlp_params, rays.encoding)
    flat, _, sizes, _ = lp.process_and_flatten_grid(grid_to_torch(grid),
                                                    None)
    cfg, geom, diff = rmod._march_inputs(rays_to_torch(rays), flat, None,
                                         sizes, None, decoder_to_torch(dp),
                                         **kw)
    nlt = renderer_fw.render_fwd_torch(cfg, geom, diff)[1]
    masks = renderer_bw.relu_masks_torch(cfg, geom, diff)
    got = renderer_bw.render_bwd_torch(
        cfg, geom, diff, nlt, tuple(torch.from_numpy(p) for p in proj),
        relu_masks=masks)
    want_grid = lp.process_and_flatten_grid(
        [torch.from_numpy(np.array(g)) for g in g_grid], None)[0]
    compare_outputs([want_grid.numpy(), g_mlp, g_enc],
                    [got[0], got[2], got[3]],
                    names=["g_grid", "g_mlp", "g_enc"])


MODULE = dict(num_samples=10, color_chn=3, grid_chn=8, mlp_hidden_chn=16,
              opacity_init_bias=-1.0, bg_color=0.3)


@pytest.mark.parametrize("module_kw", [dict(), dict(contract_coords=True,
                                                    mask_out_of_bounds_samples=True)])
def test_module_grads_match_flax(module_kw):
    kw = dict(MODULE, **module_kw)
    k_rays, k_grid, k_init = jax.random.split(jax.random.PRNGKey(7), 3)
    rays = random_rays(k_rays, 48, 1)
    grid = random_grid(k_grid, 1, kw["grid_chn"], 8, "triplane", scale=0.5)
    flax_m = lt.LightplaneRenderer(**kw)
    variables = flax_m.init(k_init, rays, grid)
    proj = _projections(2, len(rays))

    def loss_j(variables, grid):
        out = flax_m.apply(variables, rays, grid)
        return sum(jnp.sum(o * p) for o, p in zip(out, proj))

    g_vars, g_grid = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(variables,
                                                               grid)

    port_m = lp.LightplaneRenderer(device="cpu", **kw)
    port_m.load_state_dict(convert.renderer_module_state_from_flax(
        jax.device_get(variables), device="cpu"))
    gt = [g.requires_grad_(True) for g in grid_to_torch(grid)]
    out = port_m(rays_to_torch(rays), gt)
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(out, proj)).backward()

    want_state = convert.renderer_module_state_from_flax(
        jax.device_get(g_vars), device="cpu")
    names = sorted(want_state)
    params = dict(port_m.named_parameters())
    assert set(names) == set(params)
    compare_outputs(
        [want_state[n].numpy() for n in names] + list(g_grid),
        [params[n].grad for n in names] + [g.grad for g in gt],
        names=names + [f"g_grid{i}" for i in range(len(gt))],
    )


def _saved_bytes(num_samples):
    """Bytes autograd keeps between forward and backward for one
    ``lightplane_renderer`` call whose inputs all require grad."""
    rays, grid, dp = _setup(70, n_rays=32)
    rt, gt, dt = rays_to_torch(rays), grid_to_torch(grid), decoder_to_torch(dp)
    for t in gt + [dt.mlp_params, rt.encoding]:
        t.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = lp.lightplane_renderer(rt, gt, dt, num_samples=num_samples,
                                     gain=1.5)
    sum(o.sum() for o in out).backward()
    assert all(torch.isfinite(g.grad).all() for g in gt)
    return sum(saved)


def test_backward_memory_independent_of_samples():
    few, many = _saved_bytes(8), _saved_bytes(32)
    assert 0 < many <= few, (few, many)


def _guarded_grad(grid_np, num_samples=6):
    rays, _, dp = _setup(80, n_rays=8)
    rt, dt = rays_to_torch(rays), decoder_to_torch(dp)
    gt = [g.requires_grad_(True) for g in grid_to_torch(grid_np)]
    d, _, f = lp.lightplane_renderer(rt, gt, dt, num_samples=num_samples,
                                     gain=1.0)
    (f.sum() + d.sum()).backward()
    return gt[0].grad


def _triplane(nan=False):
    g = [np.array(a) for a in random_grid(jax.random.PRNGKey(2), 1, 8,
                                          resolution=4, grid_type="triplane")]
    if nan:
        g[0][0, 0, 0, 0, 0] = np.nan
    return g


def test_guard_passes_on_finite(monkeypatch):
    monkeypatch.setenv("LIGHTPLANE_CHECK_GRADS", "1")
    assert torch.isfinite(_guarded_grad(_triplane())).all()


def test_guard_raises_on_nonfinite(monkeypatch):
    monkeypatch.setenv("LIGHTPLANE_CHECK_GRADS", "1")
    with pytest.raises(FloatingPointError, match="non-finite gradient"):
        _guarded_grad(_triplane(nan=True))


def test_guard_off_is_silent(monkeypatch):
    monkeypatch.delenv("LIGHTPLANE_CHECK_GRADS", raising=False)
    g = _guarded_grad(_triplane(nan=True))  # no raise: guard disabled
    assert not torch.isfinite(g).all()


GRID_TYPES = ("voxel", "triplane", "mixed")


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_grid_losses_match_jax(grid_type):
    grid = random_grid(jax.random.PRNGKey(3), 2, 4, 6, grid_type, scale=1.0)

    for jfn, tfn in ((jgu.grid_tv_loss, tgu.grid_TV_loss),
                     (jgu.grid_l1_loss, tgu.grid_L1_loss)):
        want, g_want = jax.jit(jax.value_and_grad(jfn))(grid)
        gt = [g.requires_grad_(True) for g in grid_to_torch(grid)]
        got = tfn(gt)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        for a, b in zip(g_want, gt):
            np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("grid_type", GRID_TYPES)
def test_grid_up_sample_matches_jax(grid_type):
    grid = random_grid(jax.random.PRNGKey(4), 1, 3, 5, grid_type, scale=1.0)
    proj = [np.random.default_rng(i).standard_normal(
        tuple(n * 2 if 1 <= a <= 3 and n > 1 else n
              for a, n in enumerate(g.shape))).astype(np.float32)
            for i, g in enumerate(grid)]

    def loss_j(grid):
        return sum(jnp.sum(u * p)
                   for u, p in zip(jgu.grid_up_sample(grid, 2), proj))

    want = jax.jit(jgu.grid_up_sample)(grid)
    g_want = jax.jit(jax.grad(loss_j))(grid)
    gt = [g.requires_grad_(True) for g in grid_to_torch(grid)]
    got = tgu.grid_up_sample(gt, 2)
    sum((u * torch.from_numpy(p)).sum() for u, p in zip(got, proj)).backward()
    for a, b in zip(want, got):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(g_want, gt):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("representation", ["voxel_grid", "triplane"])
def test_init_3d_representation_shapes(representation):
    want = jgu.init_3d_representation(jax.random.PRNGKey(0), representation,
                                      6, 4, batch_size=2)
    got = tgu.init_3d_representation(torch.Generator().manual_seed(0),
                                     representation, 6, 4, batch_size=2,
                                     device="cpu")
    assert [tuple(g.shape) for g in got] == [a.shape for a in want]
    again = tgu.init_3d_representation(torch.Generator().manual_seed(0),
                                       representation, 6, 4, batch_size=2,
                                       device="cpu")
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.05 < float(torch.cat([g.flatten() for g in got]).std()) < 0.2
    with pytest.raises(ValueError, match="unknown representation"):
        tgu.init_3d_representation(None, "mesh", 4, 4, device="cpu")
