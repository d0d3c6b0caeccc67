"""The PyTorch port's building blocks against the JAX package: counter RNG,
harmonic embedding, MLP parameter layout, grid sampling, grid-list
utilities and ray helpers.  Inputs are made with numpy from a seed and
handed to both packages."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu.ops import grid_sample as jgs  # noqa: E402
from lightplane_tpu.ops import mlp_utils as jmlp  # noqa: E402
from lightplane_tpu.ops import naive_renderer as jnr  # noqa: E402
from lightplane_tpu.ops import rand as jrand  # noqa: E402
from lightplane_tpu_torch.ops import grid_sample as tgs  # noqa: E402
from lightplane_tpu_torch.ops import mlp_utils as tmlp  # noqa: E402
from lightplane_tpu_torch.ops import naive_renderer as tnr  # noqa: E402
from lightplane_tpu_torch.ops import rand as trand  # noqa: E402

from .port_utils import to_torch  # noqa: E402

torch.set_num_threads(1)

INT32_EDGE = np.array(
    [0, 1, -1, 2**31 - 1, -(2**31), 2**31 - 17, -(2**31) + 5, 65536, -65537,
     123456789, -987654321],
    dtype=np.int64,
)


def _counters(seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(-(2**31), 2**31, size=200, dtype=np.int64)
    x1 = np.concatenate([INT32_EDGE, rand]).astype(np.int32)
    x2 = np.roll(x1, 3)
    return x1, x2


@pytest.mark.parametrize("seed", [0, 3, -7, 2**31 - 1, -(2**31)])
def test_int_to_randn_hash_bit_exact(seed):
    x1, x2 = _counters(abs(seed) % 1000)
    prime = jnp.int32(jrand.INT32_PRIME)
    s = jnp.int32(seed)
    jh1 = jrand._pair_hash(jrand._pair_hash(prime, s), jrand._hash(x1))
    jh2 = jrand._pair_hash(jrand._pair_hash(prime, s + 1), jrand._hash(x2))
    th1, th2 = trand._hashes(torch.from_numpy(x1), torch.from_numpy(x2), seed)
    np.testing.assert_array_equal(np.asarray(jh1), th1.numpy())
    np.testing.assert_array_equal(np.asarray(jh2), th2.numpy())

    want = np.asarray(jrand.int_to_randn(x1, x2, seed))
    got = trand.int_to_randn(torch.from_numpy(x1), torch.from_numpy(x2),
                             seed).numpy()
    # transcendental functions differ by an ulp or so between the two
    # libraries; near 0 the bound is absolute
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_get_sample_randn_table():
    want = np.asarray(jrand.get_sample_randn(24, 37, 11))
    got = trand.get_sample_randn(24, 37, 11).numpy()
    assert got.shape == (37, 24)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_harmonics", [0, 1, 3])
def test_harmonic_embedding(n_harmonics):
    d = np.random.default_rng(1).standard_normal((17, 3)).astype(np.float32)
    want = np.asarray(lt.calc_harmonic_embedding(jnp.asarray(d), n_harmonics))
    got = lp.calc_harmonic_embedding(torch.from_numpy(d), n_harmonics).numpy()
    assert got.shape == want.shape
    assert want.shape[-1] == lp.calc_harmonic_embedding_dim(n_harmonics)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _random_mlp(rng, widths):
    ws = [rng.standard_normal((a, b)).astype(np.float32)
          for a, b in zip(widths[:-1], widths[1:])]
    bs = [rng.standard_normal(b).astype(np.float32) for b in widths[1:]]
    return ws, bs


@pytest.mark.parametrize(
    "trunk,opacity,color,pad",
    [
        ((8, 16, 16), (16, 16, 1), (16, 16, 3), True),
        ((8, 16, 16), (16, 16, 1), (16, 16, 3), False),
        ((), (8, 1), (8, 12, 12, 20), True),
        ((8, 32), (32, 32, 32, 1), (32, 3), True),
    ],
)
def test_decoder_params_flat_layout(trunk, opacity, color, pad):
    rng = np.random.default_rng(2)
    parts = []
    for widths in (trunk, opacity, color):
        parts += list(_random_mlp(rng, widths) if widths else ([], []))
    want = jmlp.flatten_decoder_params(
        *[[jnp.asarray(t) for t in p] for p in parts], pad
    )
    got = tmlp.flatten_decoder_params(
        *[[torch.from_numpy(t) for t in p] for p in parts], pad
    )
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert tuple(want[1:]) == tuple(got[1:])
    assert tmlp._mlp_numel(got[1]) == jmlp._mlp_numel(want[1])

    unj = jmlp.flattened_decoder_params_to_list(want[0], *want[1:])
    unt = lp.flattened_decoder_params_to_list(got[0], *got[1:])
    for gj, gt in zip(unj, unt):
        assert len(gj) == len(gt)
        for a, b in zip(gj, gt):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("separate_color_grid", [False, True])
def test_init_decoder_params_matches_layout(separate_color_grid):
    kw = dict(n_layers_opacity=3, n_layers_trunk=0 if separate_color_grid
              else 2, n_layers_color=2, input_chn=8, hidden_chn=16,
              color_chn=3, opacity_init_bias=-2.0,
              use_separate_color_grid=separate_color_grid)
    dj = lt.init_decoder_params(jax.random.PRNGKey(0), **kw)
    dt = lp.init_decoder_params(torch.Generator().manual_seed(0),
                                device="cpu", **kw)
    assert (dt.n_hidden_trunk, dt.n_hidden_opacity, dt.n_hidden_color) == (
        dj.n_hidden_trunk, dj.n_hidden_opacity, dj.n_hidden_color
    )
    assert dt.mlp_params.shape == dj.mlp_params.shape
    # the opacity head's last bias is opacity_init_bias; padded color
    # channels are zero
    _, _, _, b_o, w_c, b_c = lp.flattened_decoder_params_to_list(
        dt.mlp_params, dt.n_hidden_trunk, dt.n_hidden_opacity,
        dt.n_hidden_color,
    )
    assert float(b_o[-1][0]) == -2.0
    assert torch.all(w_c[-1][:, 3:] == 0) and torch.all(b_c[-1] == 0)


GRID_CASES = {
    "voxel": ([(1, 8, 8, 8, 16)], 1, False, "linear"),
    "triplane": ([(1, 1, 8, 8, 16), (1, 8, 1, 8, 16), (1, 8, 8, 1, 16)], 1,
                 False, "linear"),
    "mixed": ([(1, 8, 8, 8, 8), (1, 1, 6, 10, 8)], 1, False, "linear"),
    "batch2": ([(2, 6, 7, 5, 8)], 2, False, "linear"),
    "mask_oob": ([(2, 8, 8, 8, 8), (2, 8, 1, 8, 8)], 2, True, "linear"),
    "nearest": ([(2, 5, 6, 7, 1)], 2, True, "nearest"),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_sample_grid_rep(case):
    shapes, batch, mask, mode = GRID_CASES[case]
    rng = np.random.default_rng(3)
    grid = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    pts = rng.uniform(-1.3, 1.3, (32, 5, 3)).astype(np.float32)
    gidx = rng.integers(0, batch, 32).astype(np.int32)
    flat_j, sizes = lt.flatten_grid([jnp.asarray(g) for g in grid])
    want = jgs.sample_grid_rep(flat_j, sizes, jnp.asarray(pts),
                               jnp.asarray(gidx), mask, mode)
    flat_t, sizes_t = lp.flatten_grid([torch.from_numpy(g) for g in grid])
    assert sizes_t == sizes
    got = tgs.sample_grid_rep(flat_t, sizes_t, torch.from_numpy(pts),
                              torch.from_numpy(gidx), mask, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    got_list = tgs.sample_grid_list(
        [torch.from_numpy(g) for g in grid], torch.from_numpy(pts),
        torch.from_numpy(gidx), mask, mode,
    )
    np.testing.assert_array_equal(got_list.numpy(), got.numpy())


def test_process_and_flatten_grid():
    rng = np.random.default_rng(4)
    shapes = [(2, 4, 5, 6, 3), (2, 1, 5, 6, 3)]
    grid = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    flat, cflat, sizes, csizes = lp.process_and_flatten_grid(
        [torch.from_numpy(g) for g in grid], None
    )
    fj, _, sj, _ = lt.process_and_flatten_grid(
        [jnp.asarray(g) for g in grid], None
    )
    assert sizes == sj and cflat is None and csizes is None
    np.testing.assert_array_equal(flat.numpy(), np.asarray(fj))
    for a, b in zip(lp.unflatten_grid(flat, sizes), grid):
        np.testing.assert_array_equal(a.numpy(), b)
    # a flat tensor passes through with normalized sizes
    flat2, _, sizes2, _ = lp.process_and_flatten_grid(
        flat, None, [list(s) for s in shapes]
    )
    assert flat2 is flat and sizes2 == tuple(shapes)
    lp.check_grid(flat, shapes)
    with pytest.raises(ValueError):
        lp.check_grid(flat, [(2, 4, 5, 6, 3)])
    with pytest.raises(ValueError):
        lp.check_grid_and_color_grid(flat, flat, shapes, None)


def test_point_helpers():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 3)) * 2).astype(np.float32)
    x[0] = [3.0, -3.0, 1.0]      # ties on the max norm
    x[1] = [0.0, 0.0, 0.0]
    np.testing.assert_array_equal(
        lp.is_in_bounds(torch.from_numpy(x)).numpy(),
        np.asarray(lt.is_in_bounds(jnp.asarray(x))),
    )
    np.testing.assert_allclose(
        tnr._contract_pi(torch.from_numpy(x)).numpy(),
        np.asarray(jnr._contract_pi(jnp.asarray(x))), rtol=1e-6, atol=1e-7,
    )
    far = np.linspace(2.0, 4.0, 9).astype(np.float32)
    for step in range(4):
        np.testing.assert_allclose(
            tnr._depth_inv_sphere(torch.from_numpy(far), 1e-3, 4, step),
            np.asarray(jnr._depth_inv_sphere(jnp.asarray(far), 1e-3, 4, step)),
            rtol=1e-6,
        )


@pytest.mark.parametrize("hw", [(64, 48), (256, 256), (24, 20)])
def test_tile_ray_order(hw):
    h, w = hw
    assert lp.default_tile(h, w) == lt.default_tile(h, w)
    for tile in (None, (16, 16)):
        ot, it = lp.tile_ray_order(h, w, tile)
        oj, ij = lt.tile_ray_order(h, w, tile)
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_array_equal(it, ij)


def test_rays_indexing_and_validation():
    rng = np.random.default_rng(6)
    n = 10
    rays = lp.Rays(
        directions=to_torch(rng.standard_normal((n, 3))),
        origins=to_torch(rng.standard_normal((n, 3))),
        grid_idx=torch.zeros(n, dtype=torch.int64),
        near=torch.ones(n), far=torch.full((n,), 2.0),
    )
    assert len(rays) == n
    sub = rays[torch.tensor([3, 1])]
    assert len(sub) == 2 and sub.encoding is None
    torch.testing.assert_close(sub.origins[0], rays.origins[3])
    assert rays.to("cpu").near.shape == (n,)
    with pytest.raises(ValueError):
        lp.Rays(directions=rays.directions, origins=rays.origins,
                grid_idx=rays.near, near=rays.near, far=rays.far)
    with pytest.raises(ValueError):
        lp.Rays(directions=rays.directions[:, :2], origins=rays.origins,
                grid_idx=rays.grid_idx, near=rays.near, far=rays.far)


def test_jitter_near_far_generator():
    near, far = torch.full((50,), 1.0), torch.full((50,), 3.0)
    a = lp.jitter_near_far(near, far, 8, torch.Generator().manual_seed(1))
    b = lp.jitter_near_far(near, far, 8, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b)
    offs = a[0] - near
    assert float(offs.abs().max()) <= 2.0 / 8
    torch.testing.assert_close(a[1] - far, offs)
