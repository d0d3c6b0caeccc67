"""The PyTorch port's scaffold gating and relu-field colour grid against the
JAX package: the fused renderer's forward and gradients (the plain PyTorch
marches on the CPU, which the CUDA kernels are held against on the card),
the nearest-sample rounding of the gate, and the module's
``eval_decoder_at_points``, ``eval_opacity_at_points`` and
``calculate_scaffold``.

The JAX side runs as its own CPU tests run it (``impl="scan"``).  Forward
outputs and gradients are held to ``tests/utils.py::compare_one``'s bounds
and ``max |diff| <= 1e-4`` (both packages are f32 on the CPU);
``calculate_scaffold``'s binary scaffold must be equal bit for bit.
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
from lightplane_tpu.ops.grid_sample import sample_grid_rep as j_sample  # noqa: E402
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.ops.grid_sample import sample_grid_rep  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_bw, renderer_fw  # noqa: E402

from .port_utils import (  # noqa: E402
    compare_outputs,
    decoder_to_torch,
    grid_to_torch,
    rays_to_torch,
    to_torch,
)
from .utils import random_decoder_params, random_grid, random_rays  # noqa: E402

torch.set_num_threads(1)


def _scaffold(key, mode, shape=(1, 6, 6, 6)):
    """The binary scaffolds of ``tests/test_pallas_interpret.py``'s
    ``test_pallas_scaffold_matches_scan``: random, empty, and random with
    the far half of z empty."""
    scaffold = (jax.random.uniform(key, shape) > 0.4).astype(jnp.float32)
    if mode == "empty":
        scaffold = jnp.zeros_like(scaffold)
    elif mode == "halfz":
        scaffold = scaffold.at[:, shape[1] // 2:].set(0.0)
    return scaffold


def _render_grads(rays, grid, cgrid, dp, kw, scaffold=None):
    """Outputs of both packages and the gradients of ``sum((i + 1) *
    output_i)`` w.r.t. the grid-list, the colour grid-list (if any),
    ``mlp_params`` and the encoding; JAX first."""

    def loss_j(grid, cgrid, mlp_params, enc):
        r = dataclasses.replace(rays, encoding=enc)
        d = dataclasses.replace(dp, mlp_params=mlp_params)
        out = lt.lightplane_renderer(r, grid, d, impl="scan", color_grid=cgrid,
                                     scaffold=scaffold, **kw)
        return sum(jnp.sum(o * (i + 1)) for i, o in enumerate(out)), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3), has_aux=True))(
        grid, cgrid, dp.mlp_params, rays.encoding)

    rt, dt = rays_to_torch(rays), decoder_to_torch(dp)
    gt = grid_to_torch(grid)
    ct = None if cgrid is None else grid_to_torch(cgrid)
    leaves = gt + (ct or []) + [dt.mlp_params, rt.encoding]
    for t in leaves:
        t.requires_grad_(True)
    st = None if scaffold is None else to_torch(scaffold)
    fw0, bw0 = renderer_fw.LAUNCHES, renderer_bw.LAUNCHES
    out_t = lp.lightplane_renderer(rt, gt, dt, color_grid=ct, scaffold=st,
                                   **kw)
    sum((o * (i + 1)).sum() for i, o in enumerate(out_t)).backward()
    # CPU tensors take the plain versions, never the kernels
    assert (renderer_fw.LAUNCHES, renderer_bw.LAUNCHES) == (fw0, bw0)
    g_want = list(g_j[0]) + list(g_j[1] or []) + [g_j[2], g_j[3]]
    return out_j, out_t, g_want, [t.grad for t in leaves]


@pytest.mark.parametrize("contract", [False, True])
@pytest.mark.parametrize("mode", ["random", "empty", "halfz"])
def test_scaffold_render_and_grads_match_jax_scan(mode, contract):
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(2), 4)
    dp = random_decoder_params(k3, input_chn=8, hidden_chn=8)
    rays = random_rays(k1, 40, 1, encoding_dim=dp.n_hidden_color[0])
    grid = random_grid(k2, 1, 8, 5, "triplane", scale=0.5)
    scaffold = _scaffold(k4, mode)
    kw = dict(num_samples=9, gain=1.3, contract_coords=contract)
    out_j, out_t, g_j, g_t = _render_grads(rays, grid, None, dp, kw,
                                           scaffold)
    compare_outputs(out_j, out_t)
    names = [f"g_grid{i}" for i in range(3)] + ["g_mlp", "g_enc"]
    compare_outputs(g_j, g_t, names=names)
    if mode == "empty":
        # every step is gated: nothing renders and no gradient flows
        for x in list(out_t) + g_t:
            assert float(x.detach().abs().max()) == 0.0
    else:
        # the scaffold gates some steps and passes others
        assert 0.0 < float(jnp.mean(scaffold)) < 1.0
        assert float(out_t[1].detach().abs().max()) > 0.0


@pytest.mark.parametrize("with_scaffold", [False, True])
def test_relu_field_render_and_grads_match_jax_scan(with_scaffold):
    """The separate colour grid (relu-field): relu(grid) feeds the opacity
    head and relu(colour grid) + encoding the colour head, with no trunk;
    the colour grid gets its own gradient."""
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(4), 5)
    dp = random_decoder_params(k1, input_chn=8, hidden_chn=16,
                               n_layers_trunk=0, use_separate_color_grid=True)
    rays = random_rays(k2, 48, 2, encoding_dim=dp.n_hidden_color[0])
    grid = random_grid(k3, 2, 8, 6, "mixed", scale=0.5)
    cgrid = random_grid(k4, 2, 8, 5, "triplane", scale=0.5)
    scaffold = _scaffold(k5, "random", (2, 6, 6, 6)) if with_scaffold else None
    kw = dict(num_samples=10, gain=1.4, mask_out_of_bounds_samples=True)
    out_j, out_t, g_j, g_t = _render_grads(rays, grid, cgrid, dp, kw,
                                           scaffold)
    compare_outputs(out_j, out_t)
    names = ([f"g_grid{i}" for i in range(2)]
             + [f"g_color_grid{i}" for i in range(3)] + ["g_mlp", "g_enc"])
    compare_outputs(g_j, g_t, names=names)
    for name, g in zip(names, g_t):
        assert float(g.abs().max()) > 0.0, name


def test_scaffold_gate_rounds_half_to_even():
    """The gate samples the scaffold at its nearest cell: a coordinate that
    lies exactly half way between two cells rounds to the even one in both
    packages (``jnp.round``, ``torch.round``; ``rintf`` in the kernels)."""
    size = (1, 4, 4, 4, 1)
    vals = np.arange(64, dtype=np.float32).reshape(-1, 1)
    # the cell coordinate i = ((p + 1) / 2) * 4 - 0.5 = 2p + 1.5 lies on the
    # half-integers 0.5, 1.5, 2.5 at p = -0.5, 0, 0.5, and at -0.5 and 3.5
    # on the faces of the cube
    half = np.array([-0.5, 0.0, 0.5], np.float32)
    pts = np.stack(np.meshgrid(half, half, half, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    pts = np.concatenate([pts, np.array([[1.0, -1.0, 0.999],
                                         [-1.0, 0.0, 0.999]], np.float32)])
    idx = np.zeros(len(pts), np.int32)
    want = np.asarray(j_sample(jnp.asarray(vals), (size,), jnp.asarray(pts),
                               jnp.asarray(idx), True, mode="nearest"))
    got = sample_grid_rep(torch.from_numpy(vals), (size,),
                          torch.from_numpy(pts), torch.from_numpy(idx), True,
                          mode="nearest")
    np.testing.assert_array_equal(got.numpy(), want)
    # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2 along z for x = y = cell 0 (p = -0.5);
    # 3.5 rounds out of the grid, -0.5 to cell 0
    assert got[:3, 0].tolist() == [0.0, 32.0, 32.0]
    assert got[-2:, 0].tolist() == [0.0, 56.0]


MODULE = dict(num_samples=8, color_chn=3, grid_chn=8, mlp_hidden_chn=16,
              opacity_init_bias=-2.0)


def _modules(kw, grid, key=3):
    """The Flax module with its variables, and the port's with the same
    weights carried across by ``convert``."""
    rays = random_rays(jax.random.PRNGKey(key), 8, 1)
    flax_m = lt.LightplaneRenderer(**kw)
    variables = flax_m.init(jax.random.PRNGKey(key + 1), rays, grid)
    # a wider spread of weights than the initialiser's, so that opacities
    # vary over the grid
    variables = jax.tree_util.tree_map(lambda x: x * 3.0, variables)
    port_m = lp.LightplaneRenderer(device="cpu", **kw)
    port_m.load_state_dict(convert.renderer_module_state_from_flax(
        jax.device_get(variables), device="cpu"))
    return flax_m, variables, port_m


@pytest.mark.parametrize("grid_type, dilate",
                         [("triplane", 2), ("voxel", 0), ("mixed", 1)])
def test_calculate_scaffold_matches_flax(grid_type, dilate):
    grid = random_grid(jax.random.PRNGKey(5), 2, MODULE["grid_chn"], 6,
                       grid_type, scale=1.0)
    flax_m, variables, port_m = _modules(MODULE, grid)
    size = (2, 7, 6, 5)
    # a threshold inside the range of the dense opacity, so the scaffold is
    # neither empty nor full
    D, H, W = size[1:]
    axes = [np.linspace(0.0, 1.0, n, dtype=np.float32) for n in (D, H, W)]
    gz, gy, gx = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], -1) * 2.0 - 1.0
    op = flax_m.apply(variables, jnp.asarray(pts.reshape(D, H * W, 3)),
                      jnp.zeros((D,), jnp.int32), grid,
                      method=lt.LightplaneRenderer.eval_opacity_at_points)
    threshold = float(np.quantile(np.asarray(op), (0.5, 0.9, 0.98)[dilate]))
    want = np.asarray(flax_m.apply(
        variables, grid, size, threshold=threshold, dilate_scaffold=dilate,
        method=lt.LightplaneRenderer.calculate_scaffold))
    got = port_m.calculate_scaffold(grid_to_torch(grid), size,
                                    threshold=threshold,
                                    dilate_scaffold=dilate)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < float(want.mean()) < 1.0


@pytest.mark.parametrize("relu_field", [False, True])
def test_eval_decoder_at_points_matches_flax(relu_field):
    kw = dict(MODULE, use_separate_color_grid=relu_field,
              contract_coords=not relu_field)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(6), 4)
    grid = random_grid(k1, 2, kw["grid_chn"], 6, "triplane", scale=1.0)
    cgrid = (random_grid(k2, 2, kw["grid_chn"], 5, "voxel", scale=1.0)
             if relu_field else None)
    flax_m, variables, port_m = _modules(kw, grid)
    pts = jax.random.normal(k3, (5, 7, 3)) * 0.8
    idx = jnp.array([0, 1, 1, 0, 1], jnp.int32)
    dirs = jax.random.normal(k4, (5, 3))
    scaffold = _scaffold(k4, "random", (2, 6, 6, 6))
    want = flax_m.apply(variables, pts, idx, None, grid, cgrid,
                        scaffold=scaffold, directions=dirs,
                        method=lt.LightplaneRenderer.eval_decoder_at_points)
    got = port_m.eval_decoder_at_points(
        to_torch(pts), to_torch(idx, torch.int64), None, grid_to_torch(grid),
        None if cgrid is None else grid_to_torch(cgrid),
        scaffold=to_torch(scaffold), directions=to_torch(dirs))
    compare_outputs(want, got, names=("opacity", "color"))
    assert float(got[0].abs().max()) > 0.0


def test_eval_opacity_at_points_matches_flax():
    k1, k2 = jax.random.split(jax.random.PRNGKey(8))
    grid = random_grid(k1, 1, MODULE["grid_chn"], 6, "mixed", scale=1.0)
    flax_m, variables, port_m = _modules(
        dict(MODULE, mask_out_of_bounds_samples=True), grid)
    pts = jax.random.normal(k2, (6, 9, 3)) * 0.9
    idx = jnp.zeros((6,), jnp.int32)
    want = flax_m.apply(variables, pts, idx, grid,
                        method=lt.LightplaneRenderer.eval_opacity_at_points)
    got = port_m.eval_opacity_at_points(to_torch(pts),
                                        to_torch(idx, torch.int64),
                                        grid_to_torch(grid))
    compare_outputs([want], [got], names=("opacity",))
