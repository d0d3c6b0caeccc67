"""The splatter adjoint's two-pass design (``splat_bwd_two_pass_torch``, the
plain PyTorch version of S2's pass A and pass B) against the reference
plain adjoint ``splat_bwd_torch`` and against the JAX package's gradients
of the raw splat, with and without the rays cut into slices.

The variants are three of tests/test_splatter_parity.py, each with the
splatter MLP (the two passes exist only with it), at 8^3 grids, 12 samples
and 80 rays.  The JAX side runs as its own CPU tests run it: ``impl="auto"``,
its scan core on the CPU.  The kernel itself is held against these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
from lightplane_tpu.ops.splatter import lightplane_splatter_raw  # noqa: E402
from lightplane_tpu_torch.ops import splatter as smod  # noqa: E402
from lightplane_tpu_torch.ops.kernels import splatter_bw  # noqa: E402
from lightplane_tpu_torch.ops.kernels import splatter_fw  # noqa: E402

from .port_utils import compare_outputs, rays_to_torch, to_torch  # noqa: E402
from .test_torch_splatter import BASE, VARIANTS, _sizes  # noqa: E402

torch.set_num_threads(1)


def _case(variant):
    """Variant ``variant`` of tests/test_splatter_parity.py with the MLP
    (8 -> 16 -> 16) at 8^3 grids, 12 samples and 80 rays, made with numpy
    from a seed (tests/utils.py::random_rays' shell of rays): the JAX rays,
    sizes, keywords and splatter params, the flat input grid, and a
    cotangent of the raw splat."""
    cfg = dict(BASE, **dict(VARIANTS[variant], resolution=8, num_samples=12,
                            use_mlp=True, n_rays=80))
    rng = np.random.default_rng(variant)
    R, B, res, C = (cfg["n_rays"], cfg["batch_size"], cfg["resolution"],
                    cfg["out_chn"])
    out_sizes = _sizes(cfg["grid_type"], B, res, C)
    in_sizes = tuple(tuple(gs[:4]) + (8,) for gs in out_sizes)
    origins = rng.standard_normal((R, 3)) / 3.0 + np.array([0.0, 0.0, -2.0])
    f32 = np.float32
    rays = lt.Rays(
        directions=jnp.asarray(rng.standard_normal((R, 3)) * 0.2 - origins,
                               f32),
        origins=jnp.asarray(origins, f32),
        grid_idx=jnp.asarray(rng.integers(0, B, R), jnp.int32),
        near=jnp.asarray(0.1 + 0.05 * rng.random(R), f32),
        far=jnp.asarray(3.0 + 0.2 * rng.random(R), f32),
        encoding=jnp.asarray(rng.standard_normal((R, 8)) * 0.1, f32))
    n_hidden = (8, 16, C)
    n_params = sum(a * b + b for a, b in zip(n_hidden, n_hidden[1:]))
    sp = lt.SplatterParams(
        jnp.asarray(rng.standard_normal(n_params) * 0.3, f32), n_hidden)
    v_in = sum(int(np.prod(gs[:-1])) for gs in in_sizes)
    igrid = (rng.standard_normal((v_in, 8)) * 0.5).astype(f32)
    kw = dict(num_samples=cfg["num_samples"],
              num_samples_inf=cfg["num_samples_inf"],
              mask_out_of_bounds_samples=cfg["mask_out_of_bounds_samples"],
              contract_coords=cfg["contract_coords"])
    if cfg["num_samples_inf"]:
        # as tests/test_torch_splatter.py: the JAX scan's default
        # disparity_at_inf misplaces its last background sample
        kw["disparity_at_inf"] = 1e-3
    v_out = sum(int(np.prod(gs[:-1])) for gs in out_sizes)
    g_out = rng.standard_normal((v_out, C)).astype(f32)
    return rays, out_sizes, kw, sp, igrid, in_sizes, g_out


def _jax_grads(rays, out_sizes, kw, sp, igrid, in_sizes, g_out):
    """The JAX package's gradients of ``<g_out, feat>`` (the raw splat's
    features) w.r.t. the encoding, the flat input grid and the MLP."""

    def feat(enc, grid, mlp):
        r = dataclasses.replace(rays, encoding=enc)
        return lightplane_splatter_raw(
            r, out_sizes, dataclasses.replace(sp, mlp_params=mlp), grid,
            input_grid_sizes=in_sizes, **kw)[0]

    @jax.jit
    def grads(enc, grid, mlp, g):
        return jax.vjp(feat, enc, grid, mlp)[1](g)

    return grads(rays.encoding, jnp.asarray(igrid), sp.mlp_params,
                 jnp.asarray(g_out))


# variants of tests/test_splatter_parity.py, each with the MLP: a triplane
# with masking, a voxel grid with contraction, one with background samples
@pytest.mark.parametrize("variant", [7, 3, 4])
def test_two_pass_adjoint_matches_plain_and_jax(variant, monkeypatch):
    rays, out_sizes, kw, sp, igrid, in_sizes, g_out = _case(variant)
    want = _jax_grads(rays, out_sizes, kw, sp, igrid, in_sizes, g_out)
    r = rays_to_torch(rays)
    cfg = smod._SplatCfg(
        kw["num_samples"], kw["num_samples_inf"],
        kw["mask_out_of_bounds_samples"], kw["contract_coords"],
        kw.get("disparity_at_inf", 1e-5), tuple(map(tuple, out_sizes)),
        in_sizes, tuple(sp.n_hidden))
    geom = (r.directions, r.origins, r.near, r.far,
            r.grid_idx.to(torch.int32))
    diff = (r.encoding, to_torch(igrid), to_torch(np.asarray(sp.mlp_params)))
    g_feat = to_torch(g_out)
    plain = splatter_bw.splat_bwd_torch(cfg, geom, diff, g_feat)
    names = ["g_enc", "g_input_grid", "g_mlp"]
    got = splatter_bw.splat_bwd_two_pass_torch(cfg, geom, diff, g_feat)
    compare_outputs(plain, got, names=names)
    compare_outputs(want, got, names=names, magnitude_scaled=True)
    # one slice of 32 rays at a time
    bricks = splatter_fw.pick_bricks(cfg, grid_sizes=in_sizes)
    monkeypatch.setattr(splatter_fw, "PLAN_MAX_RUNS", 1)
    slices = splatter_bw.adjoint_slices(cfg, bricks, r.directions.shape[0])
    assert len(slices) == -(-r.directions.shape[0] // 32)
    sliced = splatter_bw.splat_bwd_two_pass_torch(cfg, geom, diff, g_feat)
    compare_outputs(plain, sliced, names=names)
    assert float(sliced[1].abs().sum()) > 0
