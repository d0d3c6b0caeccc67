"""Opt-in exhaustive parity of the port against the JAX package, over the
cartesian configurations of ``tests/test_exhaustive.py``:

    LT_EXHAUSTIVE=1 python -m pytest tests/test_torch_exhaustive.py -q

Every renderer configuration (``exhaustive_configs``, 6144) is held against
the JAX renderer at ``impl="scan"``, and every splatter configuration
(``splatter_exhaustive_configs``, 192) against the JAX fused splatter: the
forward outputs and the gradients of a fixed random projection of them
w.r.t. the grid-lists, the MLPs' ``mlp_params`` and the ray encodings,
within ``compare_one``'s bounds (scaled by magnitude where
``tests/test_exhaustive.py`` scales them: with background samples).  The
inputs are the JAX suite's (``tests/test_renderer_parity.py::_setup`` and
its splatter fixtures), passed to the port as numpy arrays; the port runs
its plain PyTorch path on the CPU.

The switches are those of ``tests/test_exhaustive.py``:
``LT_EXHAUSTIVE_SHARD=i/n`` runs configurations ``i, i + n, ...``,
``LT_EXHAUSTIVE_SEEDS`` (default 3) the seeds of each, and
``LT_EXHAUSTIVE_LIMIT`` caps the configurations run.  Without
``LT_EXHAUSTIVE`` both tests skip, so the tier-1 run does not grow.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402

from .port_utils import decoder_to_torch, rays_to_torch, to_torch  # noqa: E402,E501
from .test_exhaustive import (  # noqa: E402
    _shard_select,
    exhaustive_configs,
    splatter_exhaustive_configs,
)
from .test_renderer_parity import _setup  # noqa: E402
from .utils import (  # noqa: E402
    compare_one,
    random_grid,
    random_rays,
    random_splatter_params,
)

opt_in = pytest.mark.skipif(
    not os.environ.get("LT_EXHAUSTIVE"),
    reason="exhaustive cartesian sweep is opt-in: set LT_EXHAUSTIVE=1",
)


def _selected(configs):
    sel = _shard_select(configs, os.environ.get("LT_EXHAUSTIVE_SHARD", ""))
    limit = int(os.environ.get("LT_EXHAUSTIVE_LIMIT", "0"))
    return sel[:limit] if limit else sel


def _seeds():
    return int(os.environ.get("LT_EXHAUSTIVE_SEEDS", "3"))


def _rows(sizes):
    return [int(np.prod(s[:-1])) for s in sizes]


def _unflatten(flat, sizes, split):
    return [p.reshape(s) for p, s in zip(split(flat, sizes), sizes)]


def _jax_split(flat, sizes):
    return jnp.split(flat, np.cumsum(_rows(sizes))[:-1].tolist(), axis=0)


def _torch_split(flat, sizes):
    return torch.split(flat, _rows(sizes), dim=0)


def _flat(grid):
    return np.concatenate([np.asarray(g).reshape(-1, g.shape[-1])
                           for g in grid])


def _compare(failures, name, want, got, scaled=False):
    try:
        compare_one(np.asarray(want), got.detach().double().numpy(), name,
                    magnitude_scaled=scaled)
    except AssertionError as e:
        failures.append(str(e))


def run_renderer_config(cfg, seeds):
    """Port vs JAX ``impl="scan"`` on one renderer configuration; returns
    the failures."""
    failures = []
    for seed in range(seeds):
        rays, grid, color_grid, dp, kwargs = _setup(cfg, seed)
        scaffold = kwargs.pop("scaffold")
        sizes = [tuple(g.shape) for g in grid]
        csizes = None if color_grid is None else [tuple(g.shape)
                                                  for g in color_grid]
        flat_in = cfg["flat_grid_input"]
        gf = _flat(grid)
        cgf = None if color_grid is None else _flat(color_grid)
        rng = np.random.default_rng(1000 + seed)
        n = cfg["n_rays"]
        proj = [rng.standard_normal(s).astype(np.float32)
                for s in [(n,), (n,), (n, 3)]]

        def grids(split, gf, cgf):
            extra = {}
            if flat_in:
                extra["grid_sizes"] = [list(s) for s in sizes]
                if cgf is not None:
                    extra["color_grid_sizes"] = [list(s) for s in csizes]
                return gf, cgf, extra
            return (_unflatten(gf, sizes, split),
                    None if cgf is None else _unflatten(cgf, csizes, split),
                    extra)

        def loss_j(gf, cgf, mlp, enc):
            g_in, cg_in, extra = grids(_jax_split, gf, cgf)
            out = lt.lightplane_renderer(
                dataclasses.replace(rays, encoding=enc), g_in,
                dataclasses.replace(dp, mlp_params=mlp), color_grid=cg_in,
                scaffold=scaffold, impl="scan", **extra, **kwargs)
            return sum(jnp.sum(p * o) for p, o in zip(proj, out)), out

        argnums = (0, 1, 2, 3) if cgf is not None else (0, 2, 3)
        (_, out_j), g_j = jax.jit(jax.value_and_grad(
            loss_j, argnums=argnums, has_aux=True))(
            jnp.asarray(gf), None if cgf is None else jnp.asarray(cgf),
            dp.mlp_params, rays.encoding)

        leaves = [to_torch(gf).requires_grad_(True)]
        if cgf is not None:
            leaves.append(to_torch(cgf).requires_grad_(True))
        dt = decoder_to_torch(dp)
        rt = rays_to_torch(rays)
        leaves += [dt.mlp_params.requires_grad_(True),
                   rt.encoding.requires_grad_(True)]
        g_in, cg_in, extra = grids(_torch_split, leaves[0],
                                   leaves[1] if cgf is not None else None)
        out_t = lp.lightplane_renderer(
            rt, g_in, dt, color_grid=cg_in,
            scaffold=None if scaffold is None else to_torch(scaffold),
            **extra, **kwargs)
        sum((o * torch.from_numpy(p)).sum()
            for p, o in zip(proj, out_t)).backward()

        bg = cfg["num_samples_inf"] > 0
        for name, a, b in zip(("depth", "nlt", "features"), out_j, out_t):
            _compare(failures, f"s{seed}/{name}", a, b,
                     scaled=bg and name == "nlt")
        names = (["grid", "color_grid", "mlp", "enc"] if cgf is not None
                 else ["grid", "mlp", "enc"])
        for name, a, leaf in zip(names, g_j, leaves):
            _compare(failures, f"s{seed}/grad_{name}", a, leaf.grad,
                     scaled=bg)
    return failures


def run_splatter_config(cfg, seeds):
    """Port vs the JAX fused splatter on one splatter configuration;
    returns the failures (the fixtures of
    ``tests/test_exhaustive.py::run_one_splatter_config``)."""
    failures = []
    B, r, C = cfg["batch_size"], cfg["resolution"], cfg["out_chn"]
    if cfg["grid_type"] == "voxel":
        out_sizes = [(B, r, r, r, C)]
    else:
        out_sizes = [(B, 1, r, r, C), (B, r, 1, r, C), (B, r, r, 1, C)]
    kw = dict(num_samples=cfg["num_samples"],
              num_samples_inf=cfg["num_samples_inf"],
              mask_out_of_bounds_samples=cfg["mask_out_of_bounds_samples"],
              contract_coords=cfg["contract_coords"], return_list=False)
    for seed in range(seeds):
        k_rays, k_igrid, k_mlp = jax.random.split(jax.random.PRNGKey(seed), 3)
        enc_dim = 8 if cfg["use_mlp"] else C
        rays = random_rays(k_rays, cfg["n_rays"], B, encoding_dim=enc_dim)
        proj = np.random.default_rng(1000 + seed).standard_normal(
            (sum(_rows(out_sizes)), C)).astype(np.float32)
        rt = rays_to_torch(rays)
        enc_t = rt.encoding.requires_grad_(True)
        if cfg["use_mlp"]:
            sp = random_splatter_params(k_mlp, input_chn=enc_dim,
                                        hidden_chn=16, out_chn=C,
                                        n_layers=cfg["n_layers"])
            igrid = random_grid(k_igrid, B, enc_dim, r, cfg["grid_type"],
                                scale=0.5)

            def loss_j(enc, ig, mlp):
                out = lt.lightplane_mlp_splatter(
                    dataclasses.replace(rays, encoding=enc), out_sizes,
                    dataclasses.replace(sp, mlp_params=mlp), ig, **kw)
                return jnp.sum(proj * out), out

            (_, out_j), g_j = jax.jit(jax.value_and_grad(
                loss_j, argnums=(0, 1, 2), has_aux=True))(
                rays.encoding, igrid, sp.mlp_params)
            ig_t = [to_torch(g).requires_grad_(True) for g in igrid]
            mlp_t = to_torch(sp.mlp_params).requires_grad_(True)
            out_t = lp.lightplane_mlp_splatter(
                rt, out_sizes, lp.SplatterParams(mlp_t, sp.n_hidden), ig_t,
                **kw)
            names, got = ["enc", "input_grid", "mlp"], [enc_t, ig_t, mlp_t]
        else:
            def loss_j(enc):
                out = lt.lightplane_splatter(
                    dataclasses.replace(rays, encoding=enc), out_sizes, **kw)
                return jnp.sum(proj * out), out

            (_, out_j), g_j = jax.jit(jax.value_and_grad(
                loss_j, argnums=(0,), has_aux=True))(rays.encoding)
            out_t = lp.lightplane_splatter(rt, out_sizes, **kw)
            names, got = ["enc"], [enc_t]
        (out_t * torch.from_numpy(proj)).sum().backward()
        _compare(failures, f"s{seed}/grid", out_j, out_t)
        for name, a, b in zip(names, g_j, got):
            if isinstance(b, list):
                for i, (x, y) in enumerate(zip(a, b)):
                    _compare(failures, f"s{seed}/grad_{name}[{i}]", x,
                             y.grad)
            else:
                _compare(failures, f"s{seed}/grad_{name}", a, b.grad)
    return failures


def _sweep(configs, runner, what):
    sel = _selected(configs)
    failed = {}
    for ci, cfg in sel:
        fails = runner(cfg, _seeds())
        if fails:
            failed[ci] = fails
    assert not failed, (
        f"{len(failed)} / {len(sel)} {what} configs failed: "
        + json.dumps({str(k): v for k, v in list(failed.items())[:10]},
                     indent=2))


@opt_in
def test_exhaustive_renderer_port_vs_jax():
    _sweep(exhaustive_configs(), run_renderer_config, "renderer")


@opt_in
def test_exhaustive_splatter_port_vs_jax():
    _sweep(splatter_exhaustive_configs(), run_splatter_config, "splatter")
