"""Four places where the port's public surface once differed from the JAX
package's, each held against the JAX function on the same numpy inputs:
``lightplane_eval_mlp_opacity_only``'s ``checkpointing`` (called by
position in the JAX order), ``Rays.clone`` and ``Rays.to(..., copy=)``,
``colorize_depth``'s ``cmap`` and matplotlib's "magma" colours, and
``get_sample_randn``'s ``min_block``.

Tolerances: ``compare_one`` at its defaults plus 1e-5 on the opacities (f32
on both sides); exact for copies and for ``colorize_depth``'s bytes; 1e-6
for the counter RNG's floats, as ``tests/test_torch_ops.py`` holds it.
"""

import sys
import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu.ops import rand as jrand  # noqa: E402
from lightplane_tpu.utils import io_utils as jio  # noqa: E402
from lightplane_tpu_torch.ops import rand as trand  # noqa: E402
from lightplane_tpu_torch.utils import io_utils  # noqa: E402

from .port_utils import decoder_to_torch, rays_to_torch  # noqa: E402
from .utils import compare_one, random_decoder_params, random_rays  # noqa: E402,E501


@pytest.mark.parametrize("checkpointing", [False, True])
@pytest.mark.parametrize("contract_coords", [False, True])
def test_eval_mlp_opacity_only_matches_jax(checkpointing, contract_coords):
    rng = np.random.default_rng(0)
    sizes = ((1, 6, 6, 6, 8), (1, 1, 5, 7, 8))
    grid = rng.standard_normal((6 ** 3 + 35, 8)).astype(np.float32) * 0.5
    points = (rng.standard_normal((9, 5, 3)) * 0.8).astype(np.float32)
    noise = rng.standard_normal((9, 5)).astype(np.float32)
    scaffold = (rng.random((1, 4, 4, 4)) > 0.3).astype(np.float32)
    idx = np.zeros(9, np.int32)
    dp = random_decoder_params(jax.random.PRNGKey(0), input_chn=8,
                               hidden_chn=8)
    want = lt.lightplane_eval_mlp_opacity_only(
        jnp.asarray(points), jnp.asarray(grid), sizes, jnp.asarray(idx), dp,
        1.5, True, jnp.asarray(noise), jnp.asarray(scaffold), checkpointing,
        contract_coords)
    t = torch.from_numpy
    tdp = decoder_to_torch(dp)
    tdp.mlp_params.requires_grad_(True)
    got = lp.lightplane_eval_mlp_opacity_only(
        t(points), t(grid), sizes, t(idx), tdp, 1.5, True, t(noise),
        t(scaffold), checkpointing, contract_coords)
    want = np.asarray(want)
    compare_one(want, got.detach().numpy(), "opacity")
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    # the checkpointed evaluation gives the same gradient
    (g,) = torch.autograd.grad(got.sum(), tdp.mlp_params)
    plain = lp.lightplane_eval_mlp_opacity_only(
        t(points), t(grid), sizes, t(idx), tdp, 1.5, True, t(noise),
        t(scaffold), False, contract_coords)
    (g_plain,) = torch.autograd.grad(plain.sum(), tdp.mlp_params)
    torch.testing.assert_close(g, g_plain, rtol=0, atol=0)


def test_rays_clone_and_copy_do_not_alias():
    jrays = random_rays(jax.random.PRNGKey(1), 12, 2, encoding_dim=4)
    rays = rays_to_torch(jrays)
    want = jrays.clone()
    for copy in (rays.clone(), rays.to("cpu", copy=True)):
        for name in ("directions", "origins", "grid_idx", "near", "far",
                     "encoding"):
            src, dst = getattr(rays, name), getattr(copy, name)
            np.testing.assert_array_equal(dst.numpy(),
                                          np.asarray(getattr(want, name)))
            assert dst.data_ptr() != src.data_ptr(), name
            before = src.clone()
            dst.add_(1)
            torch.testing.assert_close(src, before, rtol=0, atol=0)
    same = rays.to("cpu")
    assert same.directions.data_ptr() == rays.directions.data_ptr()


@pytest.mark.parametrize("cmap", ["magma", "viridis"])
def test_colorize_depth_matches_jax_bytes(cmap):
    if cmap != "magma":
        pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    ramp = np.linspace(0.5, 4.0, 64 * 48, dtype=np.float32).reshape(64, 48)
    noisy = (ramp + rng.standard_normal(ramp.shape) * 0.3).astype(np.float32)
    with warnings.catch_warnings():
        # the JAX package calls matplotlib.cm.get_cmap, deprecated there
        warnings.simplefilter("ignore")
        for depth in (ramp, noisy):
            for kw in ({}, dict(near=1.0, far=3.0), dict(near=0.5, far=4.0)):
                want = jio.colorize_depth(depth, cmap=cmap, **kw)
                got = io_utils.colorize_depth(depth, cmap=cmap, **kw)
                assert got.dtype == np.uint8 and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


def test_colorize_depth_without_matplotlib(monkeypatch):
    depth = np.linspace(1.0, 2.0, 20, dtype=np.float32).reshape(4, 5)
    want = io_utils.colorize_depth(depth)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    np.testing.assert_array_equal(io_utils.colorize_depth(depth), want)
    with pytest.raises(ValueError, match="'viridis'"):
        io_utils.colorize_depth(depth, cmap="viridis")


@pytest.mark.parametrize("min_block", [16, 64])
@pytest.mark.parametrize("num_rays", [5, 37, 100])
def test_get_sample_randn_min_block(min_block, num_rays):
    want = np.asarray(jrand.get_sample_randn(24, num_rays, 11, min_block))
    got = trand.get_sample_randn(24, num_rays, 11, min_block).numpy()
    assert got.shape == (num_rays, 24)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    by_name = trand.get_sample_randn(24, num_rays, 11, min_block=min_block,
                                     device="cpu")
    np.testing.assert_array_equal(by_name.numpy(), got)
