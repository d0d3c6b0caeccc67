"""The PyTorch port's scene-fitting pieces against the JAX package: PSNR and
SSIM, the synthetic scene, the optimiser and its learning-rate schedule, the
image writers, and a CPU run of the port's trainer
(``lightplane_tpu_torch.examples.fit_single_scene``) with a scaffold
update, an upsample, evals, checkpoints and a restore.

Tolerances: PSNR within 1e-4, SSIM within 1e-5 (f32 on both sides, sums in
another order); the synthetic scene within 1e-5 (the same numpy code on the
port's copy of the cameras); Adam within ``compare_one``'s bounds and
``max |diff| <= 1e-6`` after three updates of O(1e-2); three training steps
of the trainer against the JAX app's: losses within 1e-6, the grid within
``compare_one``'s bounds and 1e-4.
"""

import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
from lightplane_tpu.utils import grid_utils as jgu  # noqa: E402
from lightplane_tpu.utils import metrics as jmetrics  # noqa: E402
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.examples import datasets as tds  # noqa: E402
from lightplane_tpu_torch.examples import fit_single_scene as tfit  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_bw, renderer_fw  # noqa: E402
from lightplane_tpu_torch.utils import io_utils, metrics  # noqa: E402

from .port_utils import compare_outputs  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

torch.set_num_threads(1)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(24, 20, 3), (16, 19)])
def test_psnr_ssim_match_jax(shape):
    a, b = _images(0, shape)
    want_psnr = float(jmetrics.calc_psnr(jnp.asarray(a), jnp.asarray(b)))
    want_ssim = float(jmetrics.calc_ssim(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(metrics.calc_psnr(ta, tb)) - want_psnr) <= 1e-4
    assert abs(float(metrics.calc_ssim(ta, tb)) - want_ssim) <= 1e-5
    # identical images: SSIM 1, PSNR at its 1e-10 MSE floor
    assert abs(float(metrics.calc_ssim(ta, ta)) - 1.0) <= 1e-6
    assert float(metrics.calc_psnr(ta, ta)) == pytest.approx(100.0)


def test_synthetic_scene_matches_jax():
    from utils.datasets import make_synthetic_scene

    want = make_synthetic_scene(n_views=3, image_size=16, seed=2)
    got = tds.make_synthetic_scene(n_views=3, image_size=16, seed=2)
    for name in ("origins", "directions", "gt"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-5, err_msg=name)
    assert (got.height, got.width, got.n_images, got.near, got.far) == (
        want.height, want.width, want.n_images, want.near, want.far)
    o, d, img = got.image(2)
    np.testing.assert_array_equal(img, want.image(2)[2])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tds.auto_dataset("/", "nerf")


def test_adam_and_schedule_match_optax():
    """Three updates of both parameter groups with the same gradients, from
    n_iter_done = 5, against the JAX app's ``make_optimizer``."""
    import fit_single_scene as japp

    args = tfit.parse_args(["--lr_grid", "0.05", "--lr_mlp", "0.01",
                            "--lr_decay_iters", "4", "--lr_decay_rate", "0.5",
                            "--device", "cpu"])
    rng = np.random.default_rng(3)
    p_grid = rng.standard_normal((4, 5)).astype(np.float32)
    p_mlp = rng.standard_normal((7,)).astype(np.float32)
    grads = [(rng.standard_normal((4, 5)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32))
             for _ in range(3)]

    opt_j = japp.make_optimizer(args, n_iter_done=5)
    params = {"grid": jnp.asarray(p_grid), "mlp": jnp.asarray(p_mlp)}
    state = opt_j.init(params)
    for gg, gm in grads:
        upd, state = opt_j.update({"grid": jnp.asarray(gg),
                                   "mlp": jnp.asarray(gm)}, state, params)
        params = optax.apply_updates(params, upd)

    grid = [torch.nn.Parameter(torch.from_numpy(p_grid.copy()))]
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(p_mlp.copy()))
    opt, sched = tfit.make_optimizer(args, grid, module, n_iter_done=5)
    for gg, gm in grads:
        grid[0].grad = torch.from_numpy(gg)
        module.w.grad = torch.from_numpy(gm)
        opt.step()
        sched.step()
    compare_outputs([params["grid"], params["mlp"]], [grid[0], module.w],
                    names=("grid", "mlp"), max_abs=1e-6)
    assert sched.get_last_lr()[0] == pytest.approx(0.05 * 0.5 ** (8 / 4))


def _jax_rays(r):
    """The port's rays as the JAX package's."""
    return lt.Rays(directions=jnp.asarray(r.directions.numpy()),
                   origins=jnp.asarray(r.origins.numpy()),
                   grid_idx=jnp.asarray(r.grid_idx.numpy(), jnp.int32),
                   near=jnp.asarray(r.near.numpy()),
                   far=jnp.asarray(r.far.numpy()))


def test_train_step_matches_jax_app(tmp_path):
    """Three training steps of the port's trainer and of the JAX app's
    (its renderer, loss and ``make_optimizer``) from the same state on the
    same 512-ray spans: the losses within 1e-6, the grid after them within
    ``compare_one``'s bounds and 1e-4 (f32 rounding through Adam)."""
    import fit_single_scene as japp

    argv = _fit_argv(tmp_path)
    fit = tfit.SceneFit(tfit.parse_args(argv))
    jargs = japp.parse_args(argv[2:] + ["--impl", "scan"])
    renderer = japp.build_renderer(jargs)
    params = {"grid": [jnp.asarray(g.detach().numpy()) for g in fit.grid]}
    variables = renderer.init(jax.random.PRNGKey(2),
                              _jax_rays(fit.rays(torch.arange(4))),
                              params["grid"], num_samples=2)
    params["mlp"] = variables["params"]
    fit.renderer.load_state_dict(convert.renderer_module_state_from_flax(
        jax.device_get(variables), device="cpu"))
    fit.opt, fit.sched = tfit.make_optimizer(fit.args, fit.grid, fit.renderer)
    opt = japp.make_optimizer(jargs)
    state = opt.init(params)

    @jax.jit
    def loss_and_grad(params, rays, gt):
        def loss(params):
            _, _, rgb = renderer.apply({"params": params["mlp"]}, rays,
                                       params["grid"], num_samples=8)
            return (jnp.mean((rgb - gt) ** 2)
                    + 1e-3 * jgu.grid_tv_loss(params["grid"]))
        return jax.value_and_grad(loss)(params)

    rng = np.random.default_rng(4)
    for _ in range(3):
        idx = (rng.integers(0, 24) * 4096 + rng.integers(0, 8) * 512
               + np.arange(512))
        want, g = loss_and_grad(params, _jax_rays(fit.rays(
            torch.from_numpy(idx))), jnp.asarray(fit.ds.gt[idx]))
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        got, _ = fit.train_step(torch.from_numpy(idx))
        assert abs(float(got) - float(want)) <= 1e-6
    compare_outputs(params["grid"], fit.grid, names=("g0", "g1", "g2"))


def test_png_and_depth_colours(tmp_path):
    from PIL import Image

    a, _ = _images(1, (9, 13, 3))
    io_utils.save_image(str(tmp_path / "rgb.png"), a)
    io_utils.save_image(str(tmp_path / "gray.png"), a[..., 0])
    got = np.asarray(Image.open(tmp_path / "rgb.png"))
    np.testing.assert_array_equal(got, io_utils.to_uint8(a))
    gray = np.asarray(Image.open(tmp_path / "gray.png"))
    np.testing.assert_array_equal(gray, io_utils.to_uint8(a[..., 0]))
    depth = np.linspace(1.0, 3.0, 50, dtype=np.float32).reshape(5, 10)
    rgb = io_utils.colorize_depth(depth)
    assert rgb.shape == (5, 10, 3) and rgb.dtype == np.uint8
    # the JAX package's matplotlib "magma" at the same normalised depths
    matplotlib = pytest.importorskip("matplotlib")
    lo, hi = np.percentile(depth, 1), np.percentile(depth, 99)
    want = matplotlib.colormaps["magma"](
        np.clip((depth - lo) / (hi - lo), 0, 1))[..., :3] * 255
    assert np.abs(rgb.astype(np.float64) - want).max() <= 12.0


def _fit_argv(out, *extra):
    return ["--device", "cpu", "--grid_resolution", "8", "--grid_channels",
            "16", "--mlp_hidden_chn", "16", "--num_samples", "8",
            "--rays_per_batch", "256", "--scaffold_resolution", "8",
            "--output_dir", str(out), *extra]


def test_trainer_runs_on_cpu_and_restores(tmp_path):
    """Three iterations with a scaffold update, an upsample and an eval
    after each of the last two steps; then a restore of the last
    checkpoint."""
    out = tmp_path / "fit"
    fw0, bw0 = renderer_fw.LAUNCHES, renderer_bw.LAUNCHES
    fit = tfit.main(_fit_argv(out, "--n_iter", "3", "--update_scaffold_steps",
                              "0", "--upsample_steps", "1", "--eval_rate",
                              "2", "--opacity_init_bias", "-1"))
    assert (renderer_fw.LAUNCHES, renderer_bw.LAUNCHES) == (fw0, bw0)
    for name in ("render", "depth"):
        for step in (2, 3):
            assert (out / f"{name}_{step:06d}.png").exists()
    ckpt = out / "ckpt_000003.pt"
    assert ckpt.exists()
    h = fit.history
    assert h["upsamples"] == [1] and [s for s, _ in h["scaffolds"]] == [0]
    assert 0.0 < h["scaffolds"][0][1] <= 1.0
    assert [e[0] for e in h["evals"]] == [2, 3]
    assert all(np.isfinite(e[1]) and 0.0 < e[2] <= 1.0 for e in h["evals"])
    assert [tuple(g.shape) for g in fit.grid] == [
        (1, 1, 16, 16, 16), (1, 16, 1, 16, 16), (1, 16, 16, 1, 16)]
    assert fit.num_samples == 16 and fit.scaffold.shape == (1, 8, 8, 8)
    assert h["segments"][0][:2] == (0, 1)

    restored = tfit.SceneFit(tfit.parse_args(_fit_argv(
        tmp_path / "again", "--init_ckpt", str(ckpt))))
    assert restored.num_samples == 16
    for a, b in zip(restored.grid, fit.grid):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=0, atol=0)
    for k, v in fit.renderer.state_dict().items():
        torch.testing.assert_close(restored.renderer.state_dict()[k], v,
                                   rtol=0, atol=0)
    # the restored state renders as the fitted one does
    fit.scaffold = None
    torch.testing.assert_close(restored.render_image(0)[0],
                               fit.render_image(0)[0], rtol=0, atol=0)


def test_trainer_image_mode_smoke(tmp_path):
    """Whole-image training (``--ray_sampling image``): two steps on the
    procedural scene, each one raster-order image rendered in the tile order
    (``image_size``), as the JAX app's smoke test runs it
    (``tests/test_examples_utils.py::test_fit_app_image_mode_smoke``)
    without the perceptual term, which the port refuses."""
    out = tmp_path / "img"
    fit = tfit.main(["--device", "cpu", "--dataset_type", "synthetic",
                     "--n_iter", "2", "--ray_sampling", "image",
                     "--grid_resolution", "8", "--grid_channels", "16",
                     "--num_samples", "8", "--eval_rate", "1000",
                     "--impl", "scan", "--output_dir", str(out)])
    assert (out / "ckpt_000002.pt").exists()
    assert [e[0] for e in fit.history["evals"]] == [2]
    assert np.isfinite(fit.history["evals"][0][1])
    # one step draws one whole image and trains on every pixel of it
    before = [g.detach().clone() for g in fit.grid]
    loss, mse = fit.step()
    assert np.isfinite(float(loss)) and 0.0 < float(mse) < float(loss)
    assert all(not torch.equal(a, b.detach())
               for a, b in zip(before, fit.grid))


def test_trainer_flags(tmp_path):
    """The JAX app's JSON configs and ``--impl`` spellings carry over; the
    perceptual loss is refused; 'auto' sampling draws 512-pixel spans on a
    small grid and 8 x 8 patches once a sub-grid passes 8192 cells."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"impl": "scan", "n_iter": 7,
                               "grid_resolution": 8}))
    args = tfit.parse_args(["--config", str(cfg), "--device", "cpu"])
    assert (args.impl, args.n_iter, tfit.IMPLS[args.impl]) == (
        "scan", 7, "torch")
    assert tfit.IMPLS["pallas"] == "cuda"
    with pytest.raises(NotImplementedError, match="perceptual"):
        tfit.parse_args(["--perceptual_weight", "0.1"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"not_a_flag": 1}))
    with pytest.raises(ValueError, match="invalid config keys"):
        tfit.parse_args(["--config", str(bad)])

    fit = tfit.SceneFit(tfit.parse_args(_fit_argv(tmp_path)))
    assert fit.sampling_mode() == "span"
    idx = fit.sample_ray_idx("span")
    assert idx.shape == (512,) and bool((idx.diff() == 1).all())
    fit.grid = [torch.zeros((1, 1, 96, 96, 16))]  # 9216 cells
    assert fit.sampling_mode() == "patch"
    idx = fit.sample_ray_idx("patch").reshape(-1, 8, 8)
    assert idx.shape == (4, 8, 8)
    assert bool((idx[:, :, 1:] - idx[:, :, :-1] == 1).all())
    assert bool((idx[:, 1:, 0] - idx[:, :-1, 0] == 64).all())
