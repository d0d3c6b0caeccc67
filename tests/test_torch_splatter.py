"""The PyTorch port's splatter against the JAX package: ``splat_grid_rep``,
the naive oracles, the fused splatter's forward grids and gradients (the
plain PyTorch path of ``_SplatCore`` on the CPU), the raw accumulators, the
input validation, the O(1)-in-samples memory of the backward, the modules
and the cameras.

The JAX side runs as its own CPU tests run it: ``impl="auto"``, which on the
CPU is its scan core, and its naive oracles.  The kernels themselves are
tested on the GPU by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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
from lightplane_tpu.ops import grid_sample as jgs  # noqa: E402
from lightplane_tpu.ops.splatter import lightplane_splatter_raw  # noqa: E402
from lightplane_tpu.utils import cameras as jcam  # noqa: E402
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from lightplane_tpu_torch.ops.kernels import splatter_bw, splatter_fw  # noqa: E402,E501
from lightplane_tpu_torch.utils import cameras as tcam  # noqa: E402

from .port_utils import compare_outputs, rays_to_torch, to_torch  # noqa: E402
from .utils import random_grid, random_rays, random_splatter_params  # noqa: E402,E501

torch.set_num_threads(1)


def _sizes(kind, batch, res, chn):
    if kind == "voxel":
        return [(batch, res, res, res, chn)]
    return [(batch, 1, res, res, chn), (batch, res, 1, res, chn),
            (batch, res, res, 1, chn)]


SPLAT_GRID_CASES = {
    "voxel": dict(kind="voxel", batch=1, mask=False),
    "triplane": dict(kind="triplane", batch=1, mask=False),
    "batched": dict(kind="voxel", batch=3, mask=False),
    "masked": dict(kind="triplane", batch=2, mask=True),
}


@pytest.mark.parametrize("case", sorted(SPLAT_GRID_CASES))
def test_splat_grid_rep_matches_jax(case):
    c = SPLAT_GRID_CASES[case]
    rng = np.random.default_rng(0)
    sizes = tuple(_sizes(c["kind"], c["batch"], 5, 6))
    R, S = 20, 7
    # points reach past the [-1, 1] cube, so some corners fall outside
    pts = rng.uniform(-1.3, 1.3, (R, S, 3)).astype(np.float32)
    feats = rng.standard_normal((R, S, 6)).astype(np.float32)
    gidx = rng.integers(0, c["batch"], R).astype(np.int32)
    acc = rng.standard_normal((sum(int(np.prod(s[:-1])) for s in sizes),
                               6)).astype(np.float32)
    want = jgs.splat_grid_rep(jnp.asarray(feats), jnp.asarray(acc), sizes,
                              jnp.asarray(pts), jnp.asarray(gidx), c["mask"])
    got = tgs.splat_grid_rep(to_torch(feats), to_torch(acc), sizes,
                             to_torch(pts), to_torch(gidx, torch.int64),
                             c["mask"])
    compare_outputs([want], [got], names=["acc"])
    # splatting is the transpose of sampling: <splat(f), g> = <f, sample(g)>
    g = rng.standard_normal(acc.shape).astype(np.float32)
    fresh = tgs.splat_grid_rep(to_torch(feats), acc.shape[0], sizes,
                               to_torch(pts), to_torch(gidx, torch.int64),
                               c["mask"])
    sampled = tgs.sample_grid_rep(to_torch(g), sizes, to_torch(pts),
                                  to_torch(gidx, torch.int64), c["mask"])
    np.testing.assert_allclose(float((fresh * to_torch(g)).sum()),
                               float((sampled * to_torch(feats)).sum()),
                               rtol=1e-4)


# the variants of tests/test_splatter_parity.py
BASE = dict(n_rays=24, batch_size=2, num_samples=8, num_samples_inf=0,
            mask_out_of_bounds_samples=False, contract_coords=False,
            grid_type="voxel", resolution=5, use_mlp=False, out_chn=16)
VARIANTS = [
    {},
    {"grid_type": "triplane"},
    {"mask_out_of_bounds_samples": True},
    {"contract_coords": True},
    {"num_samples_inf": 3},
    {"n_rays": 3},
    {"use_mlp": True},
    {"use_mlp": True, "grid_type": "triplane",
     "mask_out_of_bounds_samples": True},
]


def _variant(variant):
    """The JAX fixtures of one parity variant: rays, output sizes, keyword
    arguments and, with the MLP, the splatter params and the flat input
    grid with its sizes."""
    cfg = dict(BASE, **VARIANTS[variant])
    k_rays, k_igrid, k_mlp = jax.random.split(jax.random.PRNGKey(0), 3)
    out_sizes = _sizes(cfg["grid_type"], cfg["batch_size"],
                       cfg["resolution"], cfg["out_chn"])
    sp = igrid = in_sizes = None
    enc_dim = cfg["out_chn"]
    if cfg["use_mlp"]:
        enc_dim = 8
        sp = random_splatter_params(k_mlp, input_chn=enc_dim, hidden_chn=16,
                                    out_chn=cfg["out_chn"], n_layers=2)
        grid = random_grid(k_igrid, cfg["batch_size"], enc_dim,
                           cfg["resolution"], cfg["grid_type"], scale=0.5)
        igrid = np.concatenate([np.asarray(g).reshape(-1, enc_dim)
                                for g in grid])
        in_sizes = tuple(tuple(g.shape) for g in grid)
    rays = random_rays(k_rays, cfg["n_rays"], cfg["batch_size"],
                       encoding_dim=enc_dim)
    kw = dict(num_samples=cfg["num_samples"],
              num_samples_inf=cfg["num_samples_inf"],
              mask_out_of_bounds_samples=cfg["mask_out_of_bounds_samples"],
              contract_coords=cfg["contract_coords"])
    if cfg["num_samples_inf"]:
        # the JAX scan misplaces the last background sample at the default
        # 1e-5 (ROADMAP section 3); the naive comparison below covers it
        kw["disparity_at_inf"] = 1e-3
    return rays, out_sizes, kw, sp, igrid, in_sizes


def _jax_splat(rays, out_sizes, kw, sp, in_sizes, enc, igrid=None, mlp=None):
    r = dataclasses.replace(rays, encoding=enc)
    if sp is None:
        return lt.lightplane_splatter(r, out_sizes, return_list=False, **kw)
    return lt.lightplane_mlp_splatter(
        r, out_sizes, dataclasses.replace(sp, mlp_params=mlp), igrid,
        input_grid_sizes=in_sizes, return_list=False, **kw)


def _port_splat(rays, out_sizes, kw, sp, in_sizes, enc, igrid=None,
                mlp=None):
    r = rays_to_torch(rays)
    r = lp.Rays(r.directions, r.origins, r.grid_idx, r.near, r.far, enc)
    if sp is None:
        return lp.lightplane_splatter(r, out_sizes, return_list=False, **kw)
    return lp.lightplane_mlp_splatter(
        r, out_sizes, lp.SplatterParams(mlp, sp.n_hidden), igrid,
        input_grid_sizes=in_sizes, return_list=False, **kw)


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
def test_splatter_matches_jax(variant):
    rays, out_sizes, kw, sp, igrid, in_sizes = _variant(variant)
    args_j = [rays.encoding]
    if sp is not None:
        args_j += [jnp.asarray(igrid), sp.mlp_params]
    shape = (sum(int(np.prod(gs[:-1])) for gs in out_sizes),
             out_sizes[0][-1])
    proj = np.random.default_rng(1000 + variant).standard_normal(
        shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(*a):
        out, vjp = jax.vjp(
            lambda *a: _jax_splat(rays, out_sizes, kw, sp, in_sizes, *a), *a)
        return out, vjp(jnp.asarray(proj))

    want, g_want = fwd_bwd(*args_j)

    args_t = [to_torch(a).requires_grad_(True) for a in args_j]
    before = (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES,
              splatter_bw.MLP_LAUNCHES)
    got = _port_splat(rays, out_sizes, kw, sp, in_sizes, *args_t)
    (got * torch.from_numpy(proj)).sum().backward()
    assert (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES,
            splatter_bw.MLP_LAUNCHES) == before
    compare_outputs([want], [got], names=["grid"])
    names = ["g_enc", "g_input_grid", "g_mlp"][:len(args_j)]
    # gradients are bounded relative to their magnitude (max(1, max |g|))
    compare_outputs(g_want, [a.grad for a in args_t], names=names,
                    magnitude_scaled=True)


NAIVE_CASES = {
    "voxel": (0, dict()),
    "triplane_checkpointing": (1, dict(checkpointing=True)),
    "mlp_mask_checkpointing": (7, dict(checkpointing=True)),
    # the default disparity_at_inf, where the JAX scan departs from its
    # naive oracle: the port follows the oracle
    "far_background": (4, dict(disparity_at_inf=1e-5)),
}


@pytest.mark.parametrize("case", sorted(NAIVE_CASES))
def test_naive_splatter_matches_jax(case):
    variant, extra = NAIVE_CASES[case]
    rays, out_sizes, kw, sp, igrid, in_sizes = _variant(variant)
    kw = dict(kw, **extra)
    ckpt = kw.pop("checkpointing", False)
    r = rays_to_torch(rays)
    if sp is None:
        want = lt.lightplane_splatter_naive(rays, out_sizes,
                                            return_list=False, **kw)
        got = lp.lightplane_splatter_naive(r, out_sizes, return_list=False,
                                           checkpointing=ckpt, **kw)
        fused = lp.lightplane_splatter(r, out_sizes, return_list=False, **kw)
    else:
        want = lt.lightplane_mlp_splatter_naive(
            rays, out_sizes, sp, jnp.asarray(igrid),
            input_grid_sizes=in_sizes, return_list=False, **kw)
        sp_t = convert.splatter_params_from_numpy(
            np.asarray(sp.mlp_params), sp.n_hidden, device="cpu")
        got = lp.lightplane_mlp_splatter_naive(
            r, out_sizes, sp_t, to_torch(igrid), input_grid_sizes=in_sizes,
            return_list=False, checkpointing=ckpt, **kw)
        fused = lp.lightplane_mlp_splatter(
            r, out_sizes, sp_t, to_torch(igrid), input_grid_sizes=in_sizes,
            return_list=False, **kw)
    compare_outputs([want, want], [got, fused], names=["naive", "fused"])


def test_splatter_raw_matches_jax():
    rays, out_sizes, kw, sp, igrid, in_sizes = _variant(7)
    want = lightplane_splatter_raw(
        rays, out_sizes, sp, jnp.asarray(igrid), input_grid_sizes=in_sizes,
        **kw)
    sp_t = convert.splatter_params_from_numpy(np.asarray(sp.mlp_params),
                                              sp.n_hidden, device="cpu")
    mlp = sp_t.mlp_params.requires_grad_(True)
    got = lp.lightplane_splatter_raw(
        rays_to_torch(rays), out_sizes, sp_t, to_torch(igrid),
        input_grid_sizes=in_sizes, **kw)
    assert got[1].shape == (got[0].shape[0], 1)
    assert got[0].requires_grad and not got[1].requires_grad
    compare_outputs(want, got, names=("feat", "w"))
    got[0].sum().backward()
    assert torch.isfinite(mlp.grad).all()


def _bad_calls():
    """(name, port call) pairs the JAX package rejects with ValueError."""
    rays16 = rays_to_torch(random_rays(jax.random.PRNGKey(3), 6, 1,
                                       encoding_dim=16))
    rays8 = rays_to_torch(random_rays(jax.random.PRNGKey(3), 6, 1,
                                      encoding_dim=8))
    no_enc = rays_to_torch(random_rays(jax.random.PRNGKey(3), 6, 1))
    sp = lp.init_splatter_params(None, 2, input_chn=8, hidden_chn=8,
                                 out_chn=16, device="cpu")
    igrid8 = [torch.zeros((1, 4, 4, 4, 8))]
    igrid4 = [torch.zeros((1, 4, 4, 4, 4))]
    v16 = [(1, 4, 4, 4, 16)]
    return {
        "no_encoding": lambda: lp.lightplane_splatter(no_enc, v16, 4),
        "mixed_channels": lambda: lp.lightplane_splatter(
            rays16, [(1, 4, 4, 4, 16), (1, 1, 4, 4, 8)], 4),
        "mixed_batches": lambda: lp.lightplane_splatter(
            rays16, [(1, 4, 4, 4, 16), (2, 1, 4, 4, 16)], 4),
        "encoding_vs_grid": lambda: lp.lightplane_splatter(
            rays8, v16, 4),
        "mlp_out_vs_grid": lambda: lp.lightplane_mlp_splatter(
            rays8, [(1, 4, 4, 4, 12)], sp, igrid8, 4),
        "encoding_vs_mlp_in": lambda: lp.lightplane_mlp_splatter(
            rays16, v16, sp, igrid8, 4),
        "input_grid_vs_mlp_in": lambda: lp.lightplane_mlp_splatter(
            rays8, v16, sp, igrid4, 4),
    }


BAD_CASES = ("no_encoding", "mixed_channels", "mixed_batches",
             "encoding_vs_grid", "mlp_out_vs_grid", "encoding_vs_mlp_in",
             "input_grid_vs_mlp_in")


@pytest.mark.parametrize("case", BAD_CASES)
def test_validation_errors_match_jax(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_impl_dispatch_on_cpu():
    rays, out_sizes, kw, _, _, _ = _variant(0)
    r = rays_to_torch(rays)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lp.lightplane_splatter(r, out_sizes, impl="cuda", **kw)
    with pytest.raises(ValueError, match="impl"):
        lp.lightplane_splatter(r, out_sizes, impl="sorted", **kw)
    a = lp.lightplane_splatter(r, out_sizes, return_list=False, **kw)
    b = lp.lightplane_splatter(r, out_sizes, return_list=False,
                               impl="torch", **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _saved_bytes(num_samples, use_mlp):
    """Bytes autograd keeps between forward and backward for one splat
    whose differentiable inputs all require grad."""
    rays, out_sizes, kw, sp, igrid, in_sizes = _variant(6 if use_mlp else 0)
    kw = dict(kw, num_samples=num_samples)
    args = [to_torch(rays.encoding).requires_grad_(True)]
    if use_mlp:
        args += [to_torch(igrid).requires_grad_(True),
                 to_torch(sp.mlp_params).requires_grad_(True)]
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = _port_splat(rays, out_sizes, kw, sp, in_sizes, *args)
    out.square().sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in args)
    return sum(saved)


@pytest.mark.parametrize("use_mlp", [False, True])
def test_backward_memory_independent_of_samples(use_mlp):
    few, many = _saved_bytes(8, use_mlp), _saved_bytes(32, use_mlp)
    assert 0 < many <= few, (few, many)


@pytest.mark.parametrize("mlp", [False, True])
def test_splatter_modules_match_flax(mlp):
    k_rays, k_grid, k_init = jax.random.split(jax.random.PRNGKey(6), 3)
    sizes = [(1, 4, 4, 4, 16)]
    if mlp:
        rays = random_rays(k_rays, 12, 1, encoding_dim=8)
        igrid = random_grid(k_grid, 1, 8, 4, "voxel", scale=0.5)
        flax_m = lt.LightplaneMLPSplatter(num_samples=6, grid_chn=16,
                                          input_grid_chn=8, mlp_hidden_chn=8)
        variables = flax_m.init(k_init, rays, sizes, igrid)
        port_m = lp.LightplaneMLPSplatter(num_samples=6, grid_chn=16,
                                          input_grid_chn=8, mlp_hidden_chn=8,
                                          device="cpu")
        port_m.load_state_dict(convert.mlp_splatter_module_state_from_flax(
            jax.device_get(variables), device="cpu"))
        extra_j, extra_t = [igrid], [[to_torch(g) for g in igrid]]
    else:
        rays = random_rays(k_rays, 12, 1, encoding_dim=16)
        flax_m = lt.LightplaneSplatter(num_samples=6, grid_chn=16)
        variables = flax_m.init(k_init, rays, sizes)
        port_m = lp.LightplaneSplatter(num_samples=6, grid_chn=16)
        extra_j, extra_t = [], []

    def loss_j(params, enc):
        out = flax_m.apply({"params": params}, dataclasses.replace(
            rays, encoding=enc), sizes, *extra_j)
        return jnp.sum(out[0] ** 2)

    want = jax.jit(lambda v, *e: flax_m.apply(v, rays, sizes, *e))(
        variables, *extra_j)
    g_params, g_enc = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(
        variables.get("params", {}), rays.encoding)
    r = rays_to_torch(rays)
    r.encoding.requires_grad_(True)
    got = port_m(r, sizes, *extra_t)
    (got[0] ** 2).sum().backward()
    names = ["grid", "g_enc"]
    wants = [want[0], g_enc]
    gots = [got[0], r.encoding.grad]
    if mlp:
        names.append("g_mlp_params")
        wants.append(g_params["mlp_params"])
        gots.append(port_m.mlp_params.grad)
        assert dict(port_m.named_parameters()).keys() == {"mlp_params"}
    else:
        assert not list(port_m.parameters())
    compare_outputs(wants, gots, names=names, magnitude_scaled=True)


def test_module_jitter_and_naive_switch():
    rays = rays_to_torch(random_rays(jax.random.PRNGKey(8), 16, 1,
                                     encoding_dim=8))
    sizes = [(1, 1, 4, 4, 8), (1, 4, 1, 4, 8), (1, 4, 4, 1, 8)]
    m = lp.LightplaneSplatter(num_samples=6, grid_chn=8,
                              rays_jitter_near_far=True)
    a = m(rays, sizes, generator=torch.Generator().manual_seed(1))
    b = m(rays, sizes, generator=torch.Generator().manual_seed(1))
    c = m(rays, sizes, generator=torch.Generator().manual_seed(2))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    fused = lp.LightplaneSplatter(num_samples=6, grid_chn=8)(rays, sizes)
    naive = lp.LightplaneSplatter(num_samples=6, grid_chn=8,
                                  use_naive_impl=True)(rays, sizes)
    compare_outputs([n.numpy() for n in naive], fused,
                    names=[f"grid{i}" for i in range(3)])
    with pytest.raises(ValueError, match="wrong dimension"):
        lp.LightplaneSplatter(num_samples=6, grid_chn=16)(rays, sizes)


def test_cameras_match_jax():
    cams_j = jcam.sphere_cameras(5, radius=2.5, elevation_deg=25.0)
    cams_t = tcam.sphere_cameras(5, radius=2.5, elevation_deg=25.0)
    np.testing.assert_array_equal(cams_t, cams_j)
    np.testing.assert_array_equal(tcam.pixel_ray_directions(6, 8, 7.5),
                                  jcam.pixel_ray_directions(6, 8, 7.5))
    for a, b in zip(tcam.camera_rays(cams_t[2], 6, 8, 7.5, 0.5, 3.5),
                    jcam.camera_rays(cams_j[2], 6, 8, 7.5, 0.5, 3.5)):
        np.testing.assert_array_equal(a, b)
    enc = torch.zeros((48, 4))
    want = jcam.rays_for_camera(cams_j[1], 6, 8, 7.5, 0.5, 3.5, grid_idx=1)
    got = tcam.rays_for_camera(cams_t[1], 6, 8, 7.5, 0.5, 3.5, grid_idx=1,
                               encoding=enc, device="cpu")
    for name in ("directions", "origins", "grid_idx", "near", "far"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.encoding is enc and got.grid_idx.dtype == torch.int64
