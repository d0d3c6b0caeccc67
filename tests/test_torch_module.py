"""The whole forward slice at small width: the Flax ``LightplaneRenderer``
and the port's ``nn.Module``, with the Flax variables carried across by
``convert.renderer_module_state_from_flax``, render the same rays."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.ops.kernels import renderer_fw  # noqa: E402

from .port_utils import compare_outputs, grid_to_torch, rays_to_torch  # noqa: E402,E501
from .utils import random_grid, random_rays  # noqa: E402

torch.set_num_threads(1)

MODULE = dict(num_samples=12, color_chn=3, grid_chn=8, mlp_hidden_chn=16,
              opacity_init_bias=-1.0)


def _pair(seed, n_rays=48, module_kw=None, grid_type="triplane"):
    k_rays, k_grid, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
    kw = dict(MODULE, **(module_kw or {}))
    rays = random_rays(k_rays, n_rays, 1)
    grid = random_grid(k_grid, 1, kw["grid_chn"], 8, grid_type, scale=0.5)
    flax_m = lt.LightplaneRenderer(**kw)
    variables = flax_m.init(k_init, rays, grid)
    port_m = lp.LightplaneRenderer(device="cpu", **kw)
    port_m.load_state_dict(
        convert.renderer_module_state_from_flax(jax.device_get(variables),
                                                device="cpu")
    )
    return flax_m, variables, port_m, rays, grid


CASES = {
    "bg_scalar": (dict(bg_color=1.0), dict()),
    "bg_vector": (dict(), dict(bg_color=(0.2, 0.5, 0.9))),
    "log_transmittance": (dict(return_log_transmittance=True), dict()),
    "contract_mask": (dict(contract_coords=True,
                           mask_out_of_bounds_samples=True), dict()),
    "noise_image_size": (dict(inject_noise_sigma=1.0, inject_noise_seed=7),
                         dict(image_size=(6, 8))),
    "samples_inf": (dict(num_samples_inf=3, disparity_at_inf=1e-3), dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_flax(case):
    module_kw, call_kw = CASES[case]
    flax_m, variables, port_m, rays, grid = _pair(3, module_kw=module_kw)
    want = flax_m.apply(variables, rays, grid, **call_kw)
    before = renderer_fw.LAUNCHES
    with torch.no_grad():
        got = port_m(rays_to_torch(rays), grid_to_torch(grid), **call_kw)
    assert renderer_fw.LAUNCHES == before
    compare_outputs(want, got, names=("depth", "alpha", "rgb"),
                    magnitude_scaled="num_samples_inf" in module_kw)


def test_module_naive_matches_fused():
    _, _, port_m, rays, grid = _pair(4, module_kw=dict(bg_color=0.5))
    naive_m = lp.LightplaneRenderer(use_naive_impl=True, device="cpu",
                                    **dict(MODULE, bg_color=0.5))
    naive_m.load_state_dict(port_m.state_dict())
    rt, gt = rays_to_torch(rays), grid_to_torch(grid)
    with torch.no_grad():
        fused = port_m(rt, gt)
        naive = naive_m(rt, gt)
    compare_outputs([o.numpy() for o in naive], fused,
                    names=("depth", "alpha", "rgb"))


def test_state_dict_from_flax_layout():
    _, variables, port_m, _, _ = _pair(5)
    params = jax.device_get(variables)["params"]
    state = convert.renderer_module_state_from_flax({"params": params},
                                                    device="cpu")
    kernel = np.asarray(params["harmonic_ray_embedding_linear"]["kernel"])
    assert kernel.shape == (21, 16)
    assert port_m.harmonic_ray_embedding_linear.in_features == 21
    np.testing.assert_array_equal(
        state["harmonic_ray_embedding_linear.weight"].numpy(), kernel.T
    )
    np.testing.assert_array_equal(
        port_m.mlp_params.detach().numpy(), np.asarray(params["mlp_params"])
    )
    assert set(state) == set(port_m.state_dict())


def test_module_generators():
    """Explicit generators make jitter and drawn noise seeds reproducible."""
    gen = torch.Generator().manual_seed(0)
    m = lp.LightplaneRenderer(generator=gen, rays_jitter_near_far=True,
                              inject_noise_sigma=1.0, device="cpu", **MODULE)
    m2 = lp.LightplaneRenderer(generator=torch.Generator().manual_seed(0),
                               rays_jitter_near_far=True,
                               inject_noise_sigma=1.0, device="cpu", **MODULE)
    torch.testing.assert_close(m.state_dict(), m2.state_dict())
    rays = rays_to_torch(random_rays(jax.random.PRNGKey(6), 16, 1))
    grid = grid_to_torch(random_grid(jax.random.PRNGKey(7), 1, 8, 6))
    with torch.no_grad():
        a = m(rays, grid, generator=torch.Generator().manual_seed(1))
        b = m(rays, grid, generator=torch.Generator().manual_seed(1))
        c = m(rays, grid, generator=torch.Generator().manual_seed(2))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])


def test_ray_encoding_checks():
    m = lp.LightplaneRenderer(device="cpu", **MODULE)
    rays = rays_to_torch(random_rays(jax.random.PRNGKey(8), 8, 1,
                                     encoding_dim=16))
    grid = grid_to_torch(random_grid(jax.random.PRNGKey(9), 1, 8, 6))
    with pytest.raises(ValueError, match="Set only one"):
        m(rays, grid)
    m_enc = lp.LightplaneRenderer(ray_embedding_num_harmonics=None,
                                  device="cpu", **MODULE)
    with torch.no_grad():
        out = m_enc(rays, grid)
    assert out[2].shape == (8, 3)
    with pytest.raises(ValueError, match="bg_color"):
        m_enc(rays, grid, bg_color=(0.0, 1.0))


def test_import_does_not_load_jax():
    code = (
        "import sys\n"
        "import lightplane_tpu_torch, lightplane_tpu_torch.convert\n"
        "import lightplane_tpu_torch.ops.kernels.renderer_fw\n"
        "import lightplane_tpu_torch.ops.kernels.renderer_bw\n"
        "import lightplane_tpu_torch.ops.kernels.splatter_fw\n"
        "import lightplane_tpu_torch.ops.kernels.splatter_bw\n"
        "import lightplane_tpu_torch.ops.kernels._build\n"
        "import lightplane_tpu_torch.utils.grid_utils\n"
        "import lightplane_tpu_torch.utils.cameras\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'lightplane_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
