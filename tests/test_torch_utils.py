"""The rest of the PyTorch port's public surface against the JAX package's:
the timers and memory counters of ``utils/profiling.py``, the ray plots of
``utils/visualize.py`` (``rays_plot_data`` equal to JAX's), ``write_video``,
the surface functions that the JAX package exports
(``pad_feature_to_block_size``, ``Rays.pad_to_block_size``,
``flattened_triton_decoder_to_list``, ``get_triton_function_input_dims``,
``int_to_randn_naive``, ``suggest_w3_budget``,
``LightplaneRenderer.get_decoder_params_list``), and that the port exports
every public name of ``lightplane_tpu``.  Mirrors
``tests/test_utils_extra.py``'s profiling and visualisation tests and
``tests/test_examples_utils.py::test_write_video``.

Tolerances: exact for integer and layout functions (padding, unflattening,
the counter RNG's integer part), 1e-6 for the RNG's floats and the plot
geometry (f32 on both sides).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu.utils import visualize as jvis  # noqa: E402
from lightplane_tpu_torch.utils import io_utils, profiling, visualize  # noqa: E402,E501

from .port_utils import decoder_to_torch, rays_to_torch  # noqa: E402
from .utils import random_rays  # noqa: E402

torch.set_num_threads(1)


def test_port_exports_every_public_name():
    """The names of a fresh ``import lightplane_tpu`` (in this process,
    other tests may have imported more of its subpackages)."""
    code = ("import lightplane_tpu as lt; print(' '.join(n for n in dir(lt) "
            "if not n.startswith('_')))")
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr
    want = set(proc.stdout.split())
    assert {"Rays", "lightplane_renderer", "utils"} <= want
    missing = sorted(n for n in want if not hasattr(lp, n))
    assert not missing, missing
    import lightplane_tpu_torch.utils as pu
    assert lp.utils is pu


def test_timer_and_memory_on_the_cpu(capsys, monkeypatch):
    x = torch.ones((128, 128))
    with profiling.Timer("matmul", device="cpu") as t:
        y = x @ x
    assert y[0, 0] == 128 and t.ms is not None and t.ms >= 0.0
    assert profiling.device_memory_stats("cpu") == {}
    with profiling.Memory("matmul", device="cpu") as m:
        _ = x @ x
    assert m.delta_mb is None and m.peak_mb is None
    monkeypatch.setattr(profiling, "PROFILE", True)
    with profiling.Timer("named", device="cpu"):
        pass
    assert "[lightplane profile] named:" in capsys.readouterr().out


@pytest.mark.cuda
def test_timer_and_memory_on_the_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones((1024, 1024), device="cuda")
    with profiling.Timer("matmul") as t:
        y = x @ x
    assert t.ms > 0.0 and float(y[0, 0]) == 1024
    stats = profiling.device_memory_stats()
    assert stats["bytes_in_use"] >= x.numel() * 4
    with profiling.Memory("alloc") as m:
        z = torch.empty((1 << 20,), device="cuda")
    assert m.delta_mb >= 4.0 and m.peak_mb >= m.delta_mb and z.numel()


def _plot_rays():
    n = 8
    return lt.Rays(
        directions=jnp.tile(jnp.array([[0.0, 0.3, 1.0]]), (n, 1)),
        origins=jnp.tile(jnp.array([[0.1, 0.0, -3.0]]), (n, 1))
        + jnp.arange(n)[:, None] * 0.05,
        grid_idx=jnp.asarray([0] * 5 + [1] * 3, jnp.int32),
        near=jnp.linspace(0.5, 0.9, n),
        far=jnp.full((n,), 5.0),
    )


@pytest.mark.parametrize("colors,cap", [(True, 512), (False, 2)])
def test_rays_plot_data_matches_jax(colors, cap):
    rays = _plot_rays()
    pix = np.linspace(0.0, 1.0, 24).reshape(8, 3) if colors else None
    want = jvis.rays_plot_data(rays, pixel_colors=pix, max_display_rays=cap)
    got = visualize.rays_plot_data(
        rays_to_torch(rays), max_display_rays=cap,
        pixel_colors=None if pix is None else torch.from_numpy(pix))
    assert [s["grid_idx"] for s in got] == [s["grid_idx"] for s in want]
    for g, w in zip(got, want):
        for k in ("p_near", "p_far", "axis_range"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)
        assert g["near_colors"] == w["near_colors"]
    assert got[0]["p_near"].shape == (min(5, cap), 3)


def test_visualize_rays_plotly_figure():
    pytest.importorskip("plotly")
    fig = lp.visualize_rays_plotly(rays_to_torch(_plot_rays()))
    names = [t.name for t in fig.data]
    assert "near_0" in names and "far_1" in names and "rays_0" in names


def test_write_video(tmp_path):
    pytest.importorskip("imageio")
    frames = [np.zeros((8, 8, 3), np.float32) + i / 4 for i in range(4)]
    out = io_utils.write_video(str(tmp_path / "v.mp4"), frames, fps=4)
    assert os.path.exists(out)


def test_padding_to_block_size():
    rays = random_rays(jax.random.PRNGKey(0), 13, 2)
    rays = lt.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, encoding=jnp.ones((13, 5)))
    for block in (4, 13, 16):
        want, n_want = rays.pad_to_block_size(block)
        got, n_got = rays_to_torch(rays).pad_to_block_size(block)
        assert n_got == n_want
        for f in ("directions", "origins", "grid_idx", "near", "far",
                  "encoding"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert got.grid_idx.dtype == torch.int64
        feat = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
        np.testing.assert_array_equal(
            lp.pad_feature_to_block_size(torch.from_numpy(feat), block),
            np.asarray(lt.pad_feature_to_block_size(jnp.asarray(feat), block)))


@pytest.mark.parametrize("layers", [(2, 2, 2), (0, 1, 3), (3, 2, 1)])
def test_decoder_unflattening_matches_jax(layers):
    t, o, c = layers
    dp = lt.init_decoder_params(
        jax.random.PRNGKey(3), n_layers_trunk=t, n_layers_opacity=o,
        n_layers_color=c, input_chn=8, hidden_chn=16, color_chn=3)
    tdp = decoder_to_torch(dp)
    want = lt.flattened_triton_decoder_to_list(dp.mlp_params, t, o, c, 8, 16,
                                               3)
    got = lp.flattened_triton_decoder_to_list(tdp.mlp_params, t, o, c, 8, 16,
                                              3)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert lp.get_triton_function_input_dims(
        tdp.n_hidden_trunk, tdp.n_hidden_opacity, tdp.n_hidden_color) == \
        lt.get_triton_function_input_dims(dp.n_hidden_trunk,
                                          dp.n_hidden_opacity,
                                          dp.n_hidden_color)


def test_module_decoder_params_list():
    kw = dict(num_samples=8, color_chn=3, grid_chn=8, mlp_hidden_chn=16)
    module = lp.LightplaneRenderer(device="cpu", **kw)
    got = module.get_decoder_params_list()
    dp = module.get_decoder_params()
    want = lp.flattened_decoder_params_to_list(
        dp.mlp_params, dp.n_hidden_trunk, dp.n_hidden_opacity,
        dp.n_hidden_color)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # gradients reach the flat parameters through the list
    sum(w.sum() for w in got[0]).backward()
    assert module.mlp_params.grad is not None


def test_int_to_randn_naive_and_w3_budget():
    rng = np.random.default_rng(0)
    i1 = rng.integers(0, 1 << 30, 200).astype(np.int32)
    i2 = rng.integers(0, 1 << 30, 200).astype(np.int32)
    want = np.asarray(lt.int_to_randn_naive(jnp.asarray(i1), jnp.asarray(i2),
                                            5))
    got = lp.int_to_randn_naive(torch.from_numpy(i1).long(),
                                torch.from_numpy(i2).long(), 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert lp.int_to_randn_naive is lp.int_to_randn
    # the port's kernels take no TPU window budget: None, which the JAX
    # package returns for a configuration that needs none
    rays = random_rays(jax.random.PRNGKey(1), 16, 1)
    dp = lt.init_decoder_params(jax.random.PRNGKey(2), n_layers_opacity=2,
                                n_layers_trunk=2, n_layers_color=2,
                                input_chn=8, hidden_chn=16, color_chn=3)
    grid = [jnp.zeros((1, 8, 8, 8, 8))]
    assert lt.suggest_w3_budget(rays, grid, dp, num_samples=8) is None
    assert lp.suggest_w3_budget(rays_to_torch(rays), [torch.zeros(
        (1, 8, 8, 8, 8))], decoder_to_torch(dp), num_samples=8) is None
