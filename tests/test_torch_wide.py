"""The port at the widths that its kernels' wide builds take (padded widths
96, 128, 192, 256, and for the renderer 384 and 512:
``csrc/renderer_wide.cuh``, ``csrc/wide_mlp.cuh`` and the wide builds of S1
and S2), against the JAX package on the CPU: decoder widths 72, 96, 128,
160, 256, 320 and 512 and grid channels 96, 128 and 160 through the
renderer's forward and gradients (with relu-field and scaffold cases at
128, 256 and 512), the feature-field lift-then-render at 384 and 512
channels, the MLP splatter at widths 72, 128 and 256 and into 100, 128 and
256 output channels, the Flax modules at width 128 carried over by
``convert``, and the plain path at 9 layers and 9 sub-grids (the kernels'
caps are 16 of each).  The wide builds' host-side plans, their refusals
and the pre-pass's plain version are checked by hand.

Inputs are made from numpy seeds; the JAX side runs ``impl="scan"``, as its
own CPU tests run it.  On the CPU the port takes its plain versions; the
kernels themselves are held against those on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 12.
"""

import dataclasses
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
import lightplane_tpu_torch as lp  # noqa: E402
from lightplane_tpu.ops.splatter import lightplane_splatter_raw  # noqa: E402
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.ops import splatter as smod  # noqa: E402
from lightplane_tpu_torch.ops.kernels import (  # noqa: E402
    renderer_fw,
    splatter_bw,
    splatter_fw,
)

from .port_utils import (  # noqa: E402
    compare_outputs,
    grid_to_torch,
    rays_to_torch,
    to_torch,
)
from .test_torch_scaffold import _render_grads  # noqa: E402
from .test_torch_splatter import _jax_splat, _port_splat  # noqa: E402

torch.set_num_threads(1)
F32 = jnp.float32


def _rays(rng, n_rays, enc_dim):
    """Rays aimed from a shell at z = -2 toward the origin (as
    ``tests/utils.py::random_rays``), from a numpy generator."""
    origins = rng.standard_normal((n_rays, 3)) / 3.0 + np.array([0, 0, -2.0])
    directions = rng.standard_normal((n_rays, 3)) * 0.2 - origins
    return lt.Rays(
        directions=jnp.asarray(directions, F32),
        origins=jnp.asarray(origins, F32),
        grid_idx=jnp.zeros((n_rays,), jnp.int32),
        near=jnp.asarray(0.1 + 0.05 * rng.random(n_rays), F32),
        far=jnp.asarray(3.0 + 0.2 * rng.random(n_rays), F32),
        encoding=jnp.asarray(rng.standard_normal((n_rays, enc_dim)) * 0.1,
                             F32),
    )


def _planes(rng, chn, res=6, scale=0.5):
    """A triplane grid-list of ``chn`` channels."""
    shapes = [(1, 1, res, res, chn), (1, res, 1, res, chn),
              (1, res, res, 1, chn)]
    return [jnp.asarray(rng.standard_normal(s) * scale, F32) for s in shapes]


def _decoder(rng, chn, hidden, layers=(2, 2, 2), relu_field=False,
             color_chn=3):
    """The JAX package's decoder layout at these widths, its parameters
    drawn from ``rng`` (N(0, 0.1^2); N(0, 1 / hidden) past 256): wide
    layers then carry activations of the same order as their inputs."""
    dp = lt.init_decoder_params(
        jax.random.PRNGKey(0), n_layers_opacity=layers[1],
        n_layers_trunk=layers[0], n_layers_color=layers[2], input_chn=chn,
        hidden_chn=hidden, color_chn=color_chn,
        use_separate_color_grid=relu_field)
    scale = 0.1 if hidden <= 256 else hidden ** -0.5
    mlp = rng.standard_normal(dp.mlp_params.shape) * scale
    return dataclasses.replace(dp, mlp_params=jnp.asarray(mlp, F32))


def _grad_names(grid, cgrid):
    return ([f"g_grid{i}" for i in range(len(grid))]
            + [f"g_cgrid{i}" for i in range(len(cgrid or ()))]
            + ["g_mlp", "g_enc"])


# grid channels and decoder width, and the padded width the kernels take
# (each case a JAX compile of a few seconds, so the widths share cases)
RENDER_WIDE = {
    "grid8_hidden72": (dict(chn=8, hidden=72), 96),
    "grid96_hidden96_scaffold": (dict(chn=96, hidden=96, scaffold=True), 96),
    "grid128_hidden128": (dict(chn=128, hidden=128), 128),
    "grid8_hidden128_relu_field": (dict(chn=8, hidden=128, relu_field=True),
                                   128),
    "grid8_hidden160": (dict(chn=8, hidden=160), 192),
    "grid160_hidden32": (dict(chn=160, hidden=32), 192),
    "grid8_hidden256": (dict(chn=8, hidden=256), 256),
    "grid8_hidden256_relu_field_scaffold": (
        dict(chn=8, hidden=256, relu_field=True, scaffold=True), 256),
    # past 256: hidden 320 (padded to 384) and 512, and the relu-field
    # colour grid with a scaffold at 512
    "grid8_hidden320": (dict(chn=8, hidden=320), 384),
    "grid8_hidden512": (dict(chn=8, hidden=512), 512),
    "grid8_hidden512_relu_field_scaffold": (
        dict(chn=8, hidden=512, relu_field=True, scaffold=True), 512),
}


def _cfg(dp, chn):
    """What ``renderer_fw._kernel_width`` reads of a march config."""
    return types.SimpleNamespace(n_hidden_trunk=dp.n_hidden_trunk,
                                 n_hidden_opacity=dp.n_hidden_opacity,
                                 n_hidden_color=dp.n_hidden_color)


@pytest.mark.parametrize("case", sorted(RENDER_WIDE))
def test_renderer_wide_matches_jax_scan(case):
    c, width = RENDER_WIDE[case]
    rng = np.random.default_rng(sorted(RENDER_WIDE).index(case))
    relu_field = c.get("relu_field", False)
    dp = _decoder(rng, c["chn"], c["hidden"], relu_field=relu_field,
                  layers=(0, 2, 2) if relu_field else (2, 2, 2))
    assert renderer_fw._kernel_width(_cfg(dp, c["chn"]), c["chn"]) == width
    rays = _rays(rng, 24, dp.n_hidden_color[0])
    grid = _planes(rng, c["chn"])
    cgrid = _planes(rng, c["chn"]) if relu_field else None
    scaffold = None
    if c.get("scaffold"):
        scaffold = jnp.asarray(rng.random((1, 6, 6, 6)) > 0.4, F32)
    kw = dict(num_samples=8, gain=1.5)
    out_j, out_t, g_j, g_t = _render_grads(rays, grid, cgrid, dp, kw,
                                           scaffold)
    compare_outputs(out_j, out_t)
    assert float(out_t[1].detach().abs().max()) > 0.0
    # gradients are bounded relative to their magnitude (max(1, max |g|))
    compare_outputs(g_j, g_t, names=_grad_names(grid, cgrid),
                    magnitude_scaled=True)


@pytest.mark.parametrize("widest, width", [(16, 32), (64, 64), (65, 96),
                                           (96, 96), (100, 128), (128, 128),
                                           (129, 192), (192, 192), (200, 256),
                                           (256, 256), (257, 384),
                                           (384, 384), (385, 512),
                                           (512, 512), (513, 768),
                                           (768, 768)])
def test_kernel_width_pads_up_to_the_next_build(widest, width):
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, widest, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    assert renderer_fw._kernel_width(cfg, 8) == width


def test_kernel_width_refuses_above_512():
    """Past the widest build: 520 now pads up to 768, 776 raises."""
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, 520, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    assert renderer_fw._kernel_width(cfg, 8) == 768
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, 776, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    with pytest.raises(ValueError, match="widths up to 768"):
        renderer_fw._kernel_width(cfg, 8)
    # and a grid wider than 768 channels
    cfg = types.SimpleNamespace(n_hidden_trunk=(776, 8, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    with pytest.raises(ValueError, match="widths up to 768"):
        renderer_fw._kernel_width(cfg, 776)


# the splatter MLP's n_hidden (input 8 channels)
SPLAT_WIDE = {
    "hidden128_out128": (8, 128, 128),
    "hidden72_out100": (8, 72, 100),
    # 32 -> 256 -> 256 into a 256-channel triplane (W = 256)
    "in32_hidden256_out256": (32, 256, 256),
}


def _splat_fixture(rng, n_hidden, n_rays=32, res=6, n_grids=1):
    """Rays with 8-channel encodings, output triplanes (``n_grids`` of them)
    of the MLP's output width, and an 8-channel input triplane, flat."""
    out_chn = n_hidden[-1]
    out_sizes = [s for k in range(n_grids)
                 for s in [(1, 1, res + k, res + k, out_chn),
                           (1, res + k, 1, res + k, out_chn),
                           (1, res + k, res + k, 1, out_chn)]]
    in_grid = _planes(rng, n_hidden[0], res)
    igrid = np.concatenate([np.asarray(g).reshape(-1, n_hidden[0])
                            for g in in_grid])
    in_sizes = tuple(tuple(g.shape) for g in in_grid)
    n_params = sum(a * b + b for a, b in zip(n_hidden[:-1], n_hidden[1:]))
    mlp = rng.standard_normal(n_params) * 0.1
    sp = lt.SplatterParams(mlp_params=jnp.asarray(mlp, F32),
                           n_hidden=tuple(n_hidden))
    rays = _rays(rng, n_rays, n_hidden[0])
    return rays, out_sizes, sp, igrid, in_sizes


def _splat_matches_jax(rays, out_sizes, sp, igrid, in_sizes, seed):
    kw = dict(num_samples=8)
    args_j = [rays.encoding, jnp.asarray(igrid), sp.mlp_params]
    shape = (sum(int(np.prod(gs[:-1])) for gs in out_sizes),
             out_sizes[0][-1])
    proj = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)

    @jax.jit
    def fwd_bwd(*a):
        out, vjp = jax.vjp(
            lambda *a: _jax_splat(rays, out_sizes, kw, sp, in_sizes, *a), *a)
        return out, vjp(jnp.asarray(proj))

    want, g_want = fwd_bwd(*args_j)
    args_t = [to_torch(a).requires_grad_(True) for a in args_j]
    before = (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES)
    got = _port_splat(rays, out_sizes, kw, sp, in_sizes, *args_t)
    (got * torch.from_numpy(proj)).sum().backward()
    # CPU tensors take the plain versions, never the kernels
    assert (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES) == before
    compare_outputs([want], [got], names=["grid"])
    compare_outputs(g_want, [a.grad for a in args_t],
                    names=["g_enc", "g_input_grid", "g_mlp"],
                    magnitude_scaled=True)


@pytest.mark.parametrize("case", sorted(SPLAT_WIDE))
def test_mlp_splatter_wide_matches_jax(case):
    rng = np.random.default_rng(100 + sorted(SPLAT_WIDE).index(case))
    fixture = _splat_fixture(rng, SPLAT_WIDE[case])
    _splat_matches_jax(*fixture, seed=7)


@pytest.mark.parametrize("kind", ["renderer", "mlp_splatter"])
def test_convert_carries_wide_modules(kind):
    """The Flax modules at width 128 (a 128-channel grid and a 128-wide
    decoder; a 128-wide splatter MLP into a 128-channel grid) and the port's,
    with the Flax variables carried over by ``convert``, give the same
    outputs."""
    rng = np.random.default_rng(5)
    k_init = jax.random.PRNGKey(5)
    if kind == "renderer":
        kw = dict(num_samples=8, color_chn=3, grid_chn=128,
                  mlp_hidden_chn=128, opacity_init_bias=-1.0)
        rays = _rays(rng, 24, 8)
        rays = dataclasses.replace(rays, encoding=None)
        grid = _planes(rng, 128)
        flax_m = lt.LightplaneRenderer(**kw)
        variables = flax_m.init(k_init, rays, grid)
        port_m = lp.LightplaneRenderer(device="cpu", **kw)
        port_m.load_state_dict(convert.renderer_module_state_from_flax(
            jax.device_get(variables), device="cpu"))
        want = flax_m.apply(variables, rays, grid)
        with torch.no_grad():
            got = port_m(rays_to_torch(rays), grid_to_torch(grid))
        compare_outputs(want, got, names=("depth", "alpha", "rgb"))
    else:
        kw = dict(num_samples=6, grid_chn=128, input_grid_chn=8,
                  mlp_hidden_chn=128)
        rays = _rays(rng, 24, 8)
        sizes = [(1, 6, 6, 6, 128)]
        igrid = [jnp.asarray(rng.standard_normal((1, 6, 6, 6, 8)) * 0.5,
                             F32)]
        flax_m = lt.LightplaneMLPSplatter(**kw)
        variables = flax_m.init(k_init, rays, sizes, igrid)
        port_m = lp.LightplaneMLPSplatter(device="cpu", **kw)
        port_m.load_state_dict(convert.mlp_splatter_module_state_from_flax(
            jax.device_get(variables), device="cpu"))
        assert tuple(port_m.mlp_params.shape) == tuple(
            variables["params"]["mlp_params"].shape)
        want = flax_m.apply(variables, rays, sizes, igrid)
        with torch.no_grad():
            got = port_m(rays_to_torch(rays), sizes,
                         [to_torch(g) for g in igrid])
        compare_outputs([want[0]], [got[0]], names=["grid"])


def test_renderer_plain_path_at_nine_layers_and_nine_grids():
    """A nine-layer MLP and nine sub-grids (three triplanes), past the 8 of
    each that the kernels took before their caps rose to 16."""
    assert renderer_fw.MAX_LAYERS == 16 and renderer_fw.MAX_GRIDS == 16
    rng = np.random.default_rng(9)
    dp = _decoder(rng, 8, 16, layers=(9, 1, 1))
    rays = _rays(rng, 24, dp.n_hidden_color[0])
    grid = [g for res in (4, 5, 6) for g in _planes(rng, 8, res)]
    assert len(grid) == 9
    kw = dict(num_samples=8, gain=1.5)
    out_j, out_t, g_j, g_t = _render_grads(rays, grid, None, dp, kw)
    compare_outputs(out_j, out_t)
    compare_outputs(g_j, g_t, names=_grad_names(grid, None),
                    magnitude_scaled=True)


def test_mlp_splatter_plain_path_at_nine_layers_and_nine_grids():
    rng = np.random.default_rng(10)
    n_hidden = (8,) + (16,) * 8 + (12,)
    fixture = _splat_fixture(rng, n_hidden, res=4, n_grids=3)
    assert len(fixture[1]) == 9 and len(n_hidden) - 1 == 9
    _splat_matches_jax(*fixture, seed=8)


# ---- the wide builds' host-side plan (csrc/renderer_wide.cuh) --------------

def _head(n_t, n_o, n_c, hidden, chn=32, colours=3):
    """The n_hidden tuples of a decoder of n_t / n_o / n_c layers at
    ``hidden`` (the trunk from ``chn`` channels; no trunk: the heads read
    the grid's ``chn`` channels)."""
    trunk = (chn,) + (hidden,) * n_t if n_t else ()
    head_in = hidden if n_t else chn
    opacity = (head_in,) + (hidden,) * (n_o - 1) + (1,)
    color = (head_in,) + (hidden,) * (n_c - 1) + (colours,)
    return trunk + opacity + color


def _ring_by_hand(width):
    """Three ring slots of two k-steps of W / 8 N-tiles (16 at most: past
    W = 128 a slot keeps its size at 128) of 32 lanes' 16 bytes."""
    return 3 * 2 * min(width // 8, 16) * 32 * 16


def _fw_smem_by_hand(width, warps):
    """R1's wide block: per warp two [16][W + 4] f32 tiles, then the ring."""
    return warps * 2 * 16 * (width + 4) * 4 + _ring_by_hand(width)


def _bw_smem_by_hand(width, n_t, n_o, n_c, color_grid, warps, colours=3):
    """R2's wide block, counted from its parts: per warp a [16][W + 4] f32
    tile for each of the n_total - 1 layer inputs, one more for a colour
    grid's sample and one more for a one-layer colour head's input, the
    heads' gradient tile [16][8 + 4] (colours and opacity up to 8; past
    W = 256 in device memory instead) and the ray's encoding; then the
    ring, and 4 bytes of flag for each of 8 warps."""
    n_total = n_t + n_o + n_c
    tiles = n_total - 1 + int(color_grid) + int(n_c == 1)
    gt_cols = -(-max(colours, 1) // 8) * 8
    heads = 0 if width > 256 else 16 * (gt_cols + 4)
    per_warp = 4 * (tiles * 16 * (width + 4) + heads + width)
    return warps * per_warp + _ring_by_hand(width) + 4 * 8


@pytest.mark.parametrize("width", [96, 128, 192, 256])
@pytest.mark.parametrize("layers, color_grid", [
    ((2, 2, 2), False), ((0, 2, 2), True), ((1, 1, 1), False),
    ((0, 1, 1), False), ((3, 4, 4), False), ((8, 4, 4), False)])
def test_wide_plan_warps_and_shared_memory(width, layers, color_grid):
    """R2's warps a block (the most, up to 8, that fit in 227 KB, whole
    warpgroups past 4) and its shared memory, and R1's (8 warps of two
    [16][W + 4] tiles and the ring where they fit, else 4), as the wrapper
    plans them, against the same arithmetic done by hand."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    n_t, n_o, n_c = layers
    fits = [w for w in range(1, 9)
            if _bw_smem_by_hand(width, *layers, color_grid, w) <= 232448]
    if not fits:
        # 16 layers at W = 192 and 256: not even one warp
        with pytest.raises(ValueError, match="bytes of shared memory"):
            renderer_bw.wide_bw_plan(width, n_t, n_o, n_c,
                                     _head(*layers, width), color_grid)
        assert width > 128
        return
    plan = renderer_bw.wide_bw_plan(width, n_t, n_o, n_c,
                                    _head(*layers, width), color_grid)
    # whole warpgroups of 4 where more than 4 fit
    assert plan.warps == (max(fits) if max(fits) <= 4
                          else max(fits) // 4 * 4)
    assert plan.smem_bytes == _bw_smem_by_hand(width, *layers, color_grid,
                                               plan.warps)
    fw_warps = 8 if _fw_smem_by_hand(width, 8) <= 232448 else 4
    assert renderer_fw.wide_fw_warps(width) == fw_warps
    assert renderer_fw.wide_fw_smem_bytes(width) == _fw_smem_by_hand(
        width, fw_warps)
    assert renderer_fw.wide_fw_smem_bytes(width) <= 232448


def test_wide_plan_at_the_render_headline():
    """The numbers of renderer_wide.cuh's note: at the 2/2/2 decoder R2
    takes 4 warps a block at W = 128 (223,264 bytes) and at 96 (five fit);
    R1 8 at both (184,320 and 139,264 bytes)."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    p128 = renderer_bw.wide_bw_plan(128, 2, 2, 2, _head(2, 2, 2, 128), False)
    p96 = renderer_bw.wide_bw_plan(96, 2, 2, 2, _head(2, 2, 2, 96), False)
    assert (p128.warps, p128.smem_bytes) == (4, 223264)
    assert (p96.warps, p96.smem_bytes) == (4, 169504)
    assert renderer_fw.WIDE_FW_WARPS == 8
    assert (renderer_fw.wide_fw_smem_bytes(128),
            renderer_fw.wide_fw_smem_bytes(96)) == (184320, 139264)


def test_wide_plan_at_192_and_256():
    """The numbers of renderer_wide.cuh's note past 128: R2 at the 2/2/2
    decoder takes 2 warps at W = 256 (219,168 bytes; one warp 84,992) and
    at 192 (177,696); the 3/3/3 decoder at 256 one warp (184,096); R1 4
    warps at both (182,272 and 149,504 bytes); the deepest MLP R2 takes at
    one warp is 11 layers at 256 and 15 at 192 (3 colours), one more
    raises."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    def plan(width, layers, cgrid=False):
        return renderer_bw.wide_bw_plan(width, *layers,
                                        _head(*layers, width), cgrid)

    p256, p192 = plan(256, (2, 2, 2)), plan(192, (2, 2, 2))
    assert (p256.warps, p256.smem_bytes) == (2, 219168)
    assert (p192.warps, p192.smem_bytes) == (2, 177696)
    p333 = plan(256, (3, 3, 3))
    assert (p333.warps, p333.smem_bytes) == (1, 184096)
    assert renderer_fw.wide_fw_warps(256) == renderer_fw.wide_fw_warps(
        192) == 4
    assert (renderer_fw.wide_fw_smem_bytes(256),
            renderer_fw.wide_fw_smem_bytes(192)) == (182272, 149504)
    assert renderer_fw.wide_ring_bytes(256) == renderer_fw.wide_ring_bytes(
        192) == renderer_fw.wide_ring_bytes(128) == 49152
    assert plan(256, (3, 4, 4)).warps == 1
    assert plan(192, (5, 5, 5)).warps == 1
    for width, layers in ((256, (4, 4, 4)), (192, (6, 5, 5))):
        with pytest.raises(ValueError,
                           match=r"needs \d+ bytes of shared memory"):
            plan(width, layers)


@pytest.mark.parametrize("width", [384, 512, 768])
@pytest.mark.parametrize("layers, color_grid", [
    ((2, 2, 2), False), ((0, 2, 2), True), ((1, 1, 1), False),
    ((0, 1, 1), False), ((3, 3, 3), False)])
def test_wide_plan_past_256(width, layers, color_grid):
    """Past W = 256 R2 takes one warp a block (by mma.sync), its region
    without the heads' tile, which lies with its stash of 32 x 128 floats
    an N-part but the last (one at 384 and 512, two at 768) in a scratch in
    device memory.  Where the warp's tiles do not fit with the ring (the
    3/3/3 decoder at 384 and 512, every decoder here but the one-layer
    heads at 768), they follow into the scratch: shared memory keeps the
    encoding and the ring, and an SM as many blocks as that fits (4).  R1
    the most warps, up to 4, whose two [16][W + 4] tiles a warp fit with
    the ring, each with a stash of its own in device memory."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    stash = 32 * 128 * (2 if width == 768 else 1)
    one = _bw_smem_by_hand(width, *layers, color_grid, 1)
    plan = renderer_bw.wide_bw_plan(width, *layers, _head(*layers, width),
                                    color_grid)
    if one > 232448:
        n_t, n_o, n_c = layers
        tiles = (n_t + n_o + n_c - 1 + int(color_grid) + int(n_c == 1)) * (
            16 * (width + 4))
        smem = 4 * width + _ring_by_hand(width) + 4 * 8
        assert (plan.warps, plan.smem_bytes, plan.tiles_in_device_memory) == (
            1, smem, True)
        assert plan.scratch_bytes == 4 * (stash + 16 * (8 + 4) + tiles)
        assert plan.blocks_per_sm == 233472 // (smem + 1024) == 4
        assert plan.partial_rows(132) == 528
        assert layers == (3, 3, 3) or width == 768
    else:
        assert (plan.warps, plan.smem_bytes, plan.tiles_in_device_memory) == (
            1, one, False)
        assert plan.scratch_bytes == 4 * (stash + 16 * (8 + 4))
        assert plan.partial_rows(132) == 132
    fw_warps = max(w for w in range(1, 5)
                   if _fw_smem_by_hand(width, w) <= 232448)
    assert renderer_fw.wide_fw_warps(width) == fw_warps
    assert renderer_fw.wide_fw_smem_bytes(width) == _fw_smem_by_hand(
        width, fw_warps)
    assert renderer_fw.wide_fw_scratch_bytes(width) == (
        fw_warps * stash * 4)


def test_wide_plan_at_384_and_512():
    """The numbers of renderer_wide.cuh's note past 256: R1 3 warps at 384
    (198,144 bytes) and 2 at 512 (181,248); R2 at the 2/2/2 decoder one
    warp, 174,880 bytes at 384 and 216,352 at 512, the same at the feature
    path's 512 colours, whose heads' tile makes its scratch 49,408 bytes;
    the weight-gradient partials at that decoder 1,317,384 floats a row, a
    row a block (695.6 MB on 132 SMs)."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    assert [renderer_fw.wide_fw_warps(w) for w in (384, 512)] == [3, 2]
    assert [renderer_fw.wide_fw_smem_bytes(w) for w in (384, 512)] == [
        198144, 181248]
    p384 = renderer_bw.wide_bw_plan(384, 2, 2, 2, _head(2, 2, 2, 384),
                                    False)
    p512 = renderer_bw.wide_bw_plan(512, 2, 2, 2, _head(2, 2, 2, 512),
                                    False)
    feat = renderer_bw.wide_bw_plan(
        512, 2, 2, 2, _head(2, 2, 2, 512, chn=512, colours=512), False)
    assert (p384.warps, p384.smem_bytes) == (1, 174880)
    assert (p512.warps, p512.smem_bytes) == (1, 216352)
    assert (feat.warps, feat.smem_bytes, feat.scratch_bytes) == (
        1, 216352, 49408)
    assert feat.row_floats == 1317384
    assert 4 * feat.row_floats * feat.partial_rows(132) == 695578752


def test_wide_plan_at_768():
    """The numbers of renderer_wide.cuh's note at 768: R1 one warp,
    147,968 bytes (two [16][772] tiles and the ring), a 32 KB stash (two
    N-parts of 32 x 128 floats: a product 768 wide runs in three); R2 at
    the feature path's 2/2/2 decoder 768 wide with 768 colours would need
    299,296 bytes for one warp (five tiles of 49,408, the encoding and the
    ring), so its tiles lie in device memory: 52,256 bytes of shared
    memory, 4 blocks an SM, a scratch of 329,216 bytes a block (the stash,
    the heads' [16][772] tile, the five tiles); the weight-gradient rows
    2,959,112 floats, one per block: 528 on 132 SMs, 6.25 GB."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    assert renderer_fw.wide_fw_warps(768) == 1
    assert renderer_fw.wide_fw_smem_bytes(768) == 147968 == (
        2 * 16 * 772 * 4 + 49152)
    assert renderer_fw.wide_fw_smem_bytes(768, 2) > 232448
    assert renderer_fw.wide_fw_scratch_bytes(768) == 32768
    head = _head(2, 2, 2, 768, chn=768, colours=768)
    assert _bw_smem_by_hand(768, 2, 2, 2, False, 1, colours=768) == 299296
    plan = renderer_bw.wide_bw_plan(768, 2, 2, 2, head, False)
    assert plan.tiles_in_device_memory
    assert (plan.warps, plan.smem_bytes) == (1, 52256)
    assert plan.scratch_bytes == 329216 == 4 * (2 * 4096 + 16 * 772
                                                + 5 * 16 * 772)
    # each (768, 768) layer: 48 M-tiles by 96 N-tiles of 128 sums and 8 x
    # 96 bias sums; the opacity head's last (768, 1): 48 x 1 x 128 + 8
    assert plan.row_floats == 5 * (48 * 96 * 128 + 8 * 96) + 48 * 128 + 8
    assert plan.row_floats == 2959112
    assert (plan.blocks_per_sm, plan.partial_rows(132)) == (4, 528)
    assert 4 * plan.row_floats * plan.partial_rows(132) == 6249644544


@pytest.mark.parametrize("width, parts", [(256, 0), (384, 1), (512, 1),
                                          (768, 2)])
def test_wide_stash_by_parts(width, parts):
    """A warp's stash holds every N-part but the last of a product
    ``width`` wide: 32 x 128 floats a part.  R1's scratch is a stash a
    warp; pass F's stays as it is at 384 and 512 (7 and 5 warps)."""
    assert renderer_fw.wide_parts(width // 8)[:-1] == [32] * parts
    assert renderer_fw.wide_stash_floats(width) == parts * 32 * 128
    assert renderer_fw.wide_fw_scratch_bytes(width) == (
        renderer_fw.wide_fw_warps(width) * parts * 32 * 128 * 4)
    if width in (384, 512):
        assert splatter_fw.pass_f_scratch_bytes(width) == (
            splatter_fw.pass_f_warps(width) * 16384)


@pytest.mark.parametrize("width, layers, color_grid", [
    # 11 layers in all at 128 (10 with a colour grid), 16 (15) at 96, and
    # deeper ones
    (128, (3, 4, 4), False), (128, (0, 5, 5), True), (128, (9, 1, 1), False),
    (96, (6, 5, 5), False), (96, (0, 8, 7), True), (96, (14, 1, 1), False),
    (128, (7, 7, 7), False), (96, (10, 10, 9), False),
    # 11 layers in all at 256 (10 with a colour grid), 15 at 192
    (256, (3, 4, 4), False), (256, (0, 5, 5), True), (256, (3, 3, 3), False),
    (192, (5, 5, 5), False), (192, (0, 7, 7), True), (192, (12, 1, 1), False),
])
def test_wide_plan_takes_deep_configs(width, layers, color_grid):
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    plan = renderer_bw.wide_bw_plan(width, *layers, _head(*layers, width),
                                    color_grid)
    assert plan.warps >= 1 and plan.smem_bytes <= 232448


def test_wide_plan_refuses_what_does_not_fit():
    """48 layers at W = 128 need more than a block's shared memory for one
    warp: ValueError with the bytes; and widths above 768 stay refused."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        renderer_bw.wide_bw_plan(128, 16, 16, 16, _head(16, 16, 16, 128),
                                 False)
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, 776, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    with pytest.raises(ValueError, match="widths up to 768"):
        renderer_fw._kernel_width(cfg, 8)


@pytest.mark.parametrize("num_sms", [132, 114])
def test_wide_partial_buffer_has_a_row_per_block(num_sms):
    """R2's partial sums: one row per block of the resident wave (one block
    a SM), whatever the warps a block, each row every layer's sums."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    for width, layers in ((128, (2, 2, 2)), (96, (1, 1, 1)),
                          (256, (2, 2, 2)), (192, (2, 2, 2))):
        plan = renderer_bw.wide_bw_plan(width, *layers,
                                        _head(*layers, width), False)
        assert plan.warps > 1
        assert plan.partial_rows(num_sms) == num_sms
        dims = renderer_fw.wide_layers(*layers, _head(*layers, width))
        floats = sum(-(-i // 16) * -(-o // 8) * 128 + 8 * -(-o // 8)
                     for i, o, _, _ in dims)
        assert plan.row_floats == -(-floats // 4) * 4


def _tf32_by_frexp(x):
    """x rounded to 10 mantissa bits, to nearest, ties away from zero, in
    float64 arithmetic."""
    m, e = np.frexp(x.astype(np.float64))
    scaled = np.abs(m) * 2.0**11
    return (np.sign(m) * np.floor(scaled + 0.5) / 2.0**11 * 2.0**e).astype(
        np.float32)


@pytest.mark.parametrize("backward", [False, True])
def test_wide_pack_round_trips(backward):
    """The plain version of the pre-pass: every weight of every product in
    its place among wgmma's K-major core matrices, hi the TF32 rounding of
    w, lo = w - hi, hi + lo == w; zero past a layer's widths; the schedule
    a slice of two k-steps each, in the products' order."""
    n_t, n_o, n_c = 1, 2, 2
    head = (8, 40, 40, 72, 1, 40, 72, 3)
    layers = renderer_fw.wide_layers(n_t, n_o, n_c, head)
    n_params = sum(i * o + o for i, o, _, _ in layers)
    rng = np.random.default_rng(3)
    w_np = (rng.standard_normal(n_params) * 0.3).astype(np.float32)
    w_np[:3] = [1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-12]
    products = renderer_fw.wide_products(layers, n_t, n_o, backward)
    assert [(l, t) for l, t, _, _ in products][:3] == [
        (0, False), (1, False), (3, False)]
    if backward:
        assert [l for l, t, _, _ in products if t] == [4, 3, 2, 1, 0]
    _check_pack(w_np, layers, products)
    # the ties round away from zero
    assert float(renderer_fw.tf32_round(torch.tensor([1.0 + 2.0**-11]))) == (
        1.0 + 2.0**-10)


@pytest.mark.parametrize("backward", [False, True])
def test_wide_pack_round_trips_at_256(backward):
    """The pre-pass's plain version at W = 256: products of 1 to 32 N-tiles,
    those wider than 16 one k-step a ring slice, the rest two."""
    n_t, n_o, n_c = 1, 2, 2
    head = (8, 256, 256, 200, 1, 256, 160, 3)
    layers = renderer_fw.wide_layers(n_t, n_o, n_c, head)
    products = renderer_fw.wide_products(layers, n_t, n_o, backward)
    fwd = [(0, False, 1, 32), (1, False, 32, 25), (3, False, 32, 20)]
    if backward:
        assert products == fwd + [(4, True, 1, 20), (3, True, 20, 32),
                                  (2, True, 1, 25), (1, True, 25, 32),
                                  (0, True, 32, 1)]
    else:
        assert products == fwd
    # one slice a k-step past 16 N-tiles, two k-steps a slice up to it
    assert renderer_fw.wide_slices(products) == sum(
        ks if nt > 16 else -(-ks // 2) for _, _, ks, nt in products)
    n_params = sum(i * o + o for i, o, _, _ in layers)
    w_np = (np.random.default_rng(4).standard_normal(n_params) * 0.3
            ).astype(np.float32)
    _check_pack(w_np, layers, products)


def _check_pack(w_np, layers, products):
    """``pack_wide_torch``'s workspace for ``products`` read back by hand:
    every weight of every product in its place among wgmma's K-major core
    matrices, hi the TF32 rounding of w, lo = w - hi, hi + lo == w; zero
    past a layer's widths; a product of more than 32 N-tiles in N-parts of
    32 (the last the rest), each laid out as a product of its own; the
    schedule a slice of two k-steps each (one past 16 N-tiles), in the
    products' and the parts' order."""
    pack = renderer_fw.pack_wide_torch(torch.from_numpy(w_np), layers,
                                       products)
    assert pack.shape[0] * 16 == renderer_fw.wide_pack_bytes(products)

    def parts(nt):
        return [min(32, nt - q) for q in range(0, nt, 32)]

    slices = sum(-(-ks // (1 if pt > 16 else 2))
                 for _, _, ks, nt in products for pt in parts(nt))
    head_rows = -(-slices // 2)
    sched = pack[:head_rows].reshape(-1)[:2 * slices].reshape(-1, 2).numpy()
    at = head_rows
    k = 0
    for layer, transposed, ks, nt in products:
        d_in, d_out, w_off, _ = layers[layer]
        w = w_np[w_off:w_off + d_in * d_out].reshape(d_in, d_out)
        b = w.T if transposed else w
        assert (ks, nt) == (-(-b.shape[0] // 8), -(-b.shape[1] // 8))
        want = np.zeros((8 * ks, 8 * nt), np.float32)
        want[:b.shape[0], :b.shape[1]] = b
        for q, pt in enumerate(parts(nt)):
            # per k-step s: hi, lo; each N-tile j of the part, k-half h: 8
            # rows of 4 k
            region = pack[at:at + ks * pt * 32].numpy().view(np.float32)
            region = region.reshape(ks, 2, pt, 2, 8, 4)
            for s in range(ks):
                for j in range(pt):
                    n0 = 8 * (32 * q + j)
                    for h in range(2):
                        # rows n = n0 + r, columns k = 8 s + 4 h + c
                        wv = want[8 * s + 4 * h:8 * s + 4 * h + 4,
                                  n0:n0 + 8].T
                        hi, lo = region[s, 0, j, h], region[s, 1, j, h]
                        assert np.array_equal(hi, _tf32_by_frexp(wv))
                        assert np.array_equal(lo, wv - hi)
                        assert np.array_equal(hi + lo, wv)
            steps = 1 if pt > 16 else 2
            for k0 in range(0, ks, steps):
                assert tuple(sched[k]) == (at + k0 * pt * 32,
                                           min(steps, ks - k0) * pt * 32)
                k += 1
            at += ks * pt * 32
    assert k == slices and at == pack.shape[0]
    # an odd count of slices leaves the schedule's last int2 at 0
    assert not pack[:head_rows].reshape(-1)[2 * slices:].any()


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("width", [384, 512, 768])
def test_wide_pack_round_trips_past_256(width, backward):
    """The pre-pass's plain version past W = 256: products wider than 32
    N-tiles in N-parts of 32 (256 + 128 columns at 384, 256 + 256 at 512,
    and 256 + 64 at 320 wide; at 768 three, 256 + 256 + 256, and 256 +
    256 + 88 at 600 wide), one k-step a slice; the colour head's last
    layer among the forward's products (its outputs as many as the
    hidden units, or the 768 colours)."""
    n_t, n_o, n_c = 1, 2, 2
    hidden, colours = {384: (384, 320), 512: (512, 512),
                       768: (600, 768)}[width]
    head = (8, hidden, hidden, 200, 1, hidden, hidden, colours)
    layers = renderer_fw.wide_layers(n_t, n_o, n_c, head)
    assert renderer_fw.wide_head_product(layers)
    products = renderer_fw.wide_products(layers, n_t, n_o, backward)
    h = hidden // 8
    fwd = [(0, False, 1, h), (1, False, h, 25), (3, False, h, h),
           (4, False, h, colours // 8)]
    if backward:
        assert products == fwd + [(4, True, colours // 8, h),
                                  (3, True, h, h), (2, True, 1, 25),
                                  (1, True, 25, h), (0, True, h, 1)]
    else:
        assert products == fwd
    assert [renderer_fw.wide_parts(nt)
            for nt in (48, 40, 64, 25, 96, 75)] == [
        [32, 16], [32, 8], [32, 32], [25], [32, 32, 32], [32, 32, 11]]
    n_params = sum(i * o + o for i, o, _, _ in layers)
    w_np = (np.random.default_rng(6).standard_normal(n_params) * 0.3
            ).astype(np.float32)
    _check_pack(w_np, layers, products)


def _fake_cuda(t):
    """A CPU tensor that reports a CUDA device: the wrappers' checks run
    on it (shapes, types, the widths) up to the launch."""
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 dtype=t.dtype, shape=t.shape,
                                 is_contiguous=t.is_contiguous,
                                 numel=t.numel, data_ptr=lambda: 16)


def _fake_render_inputs(chn, hidden, colours=3, n_rays=4):
    from lightplane_tpu_torch.ops import renderer as rmod

    dp = lp.init_decoder_params(None, 2, 2, 2, input_chn=chn,
                                hidden_chn=hidden, color_chn=colours,
                                device="cpu")
    res = 4
    grid = [torch.zeros(s) for s in _tri_sizes(res, chn)]
    rays = lp.Rays(torch.zeros((n_rays, 3)), torch.zeros((n_rays, 3)),
                   torch.zeros((n_rays,), dtype=torch.int64),
                   torch.zeros((n_rays,)), torch.ones((n_rays,)),
                   torch.zeros((n_rays, dp.n_hidden_color[0])))
    flat = lp.process_and_flatten_grid(grid, None)
    cfg, geom, diff = rmod._march_inputs(rays, *flat, dp, num_samples=4,
                                         gain=1.0)
    fake = lambda x: x if x is None or not torch.is_tensor(x) else (  # noqa
        _fake_cuda(x))
    return cfg, tuple(map(fake, geom)), tuple(map(fake, diff))


@pytest.mark.parametrize("hidden, width", [(512, 512), (320, 384),
                                           (520, 768), (768, 768), (776, 0)])
def test_cuda_tensors_take_the_kernels_or_raise(hidden, width):
    """A launch on CUDA tensors (``impl="auto"`` or ``"cuda"``) takes the
    kernels at every width up to 768 and raises past it: no CUDA call
    reaches the plain version."""
    cfg, geom, diff = _fake_render_inputs(8, hidden)
    for impl in ("auto", "cuda"):
        assert not renderer_fw.check_impl(impl, True, "cuda")
    if width:
        a = renderer_fw.launch_args(cfg, geom, diff, "render_fwd_cuda")
        assert a.width == width
    else:
        with pytest.raises(ValueError, match="widths up to 768"):
            renderer_fw.launch_args(cfg, geom, diff, "render_fwd_cuda")


@pytest.mark.parametrize("chn", [384, 512, 768])
def test_feature_lift_then_render_matches_jax(chn):
    """The feature-field lift-then-render at the features' own width:
    ``chn``-channel features of a few rays splatted into a 3 x 8^2 x chn
    triplane and rendered back through a 2/2/2 decoder ``chn`` wide with
    ``chn`` colours (the kernels' builds at 384, 512 and 768; the splat's
    adjoint at 768 channels), the L2 loss
    against the features; the loss and its gradients with respect to the
    features and the decoder against the JAX package (``impl="scan"``)."""
    rng = np.random.default_rng(300 + chn)
    rays = _rays(rng, 12, chn)
    feats = rays.encoding
    sizes = _tri_sizes(8, chn)
    dp = _decoder(rng, chn, chn, color_chn=chn)
    zeros = jnp.zeros_like(feats)
    kw_s, kw_r = dict(num_samples=10), dict(num_samples=12, gain=1.5)

    def loss_j(enc, mlp):
        lifted = lt.lightplane_splatter(
            dataclasses.replace(rays, encoding=enc), sizes, **kw_s)
        _, _, feat = lt.lightplane_renderer(
            dataclasses.replace(rays, encoding=zeros), lifted,
            dataclasses.replace(dp, mlp_params=mlp), impl="scan", **kw_r)
        return jnp.sum((feat - enc) ** 2)

    loss_jax, g_jax = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1)))(
        feats, dp.mlp_params)
    rt = rays_to_torch(rays)
    enc = rt.encoding.clone().requires_grad_(True)
    mlp = to_torch(dp.mlp_params).requires_grad_(True)
    dt = lp.DecoderParams(mlp, dp.n_hidden_trunk, dp.n_hidden_opacity,
                          dp.n_hidden_color, dp.color_chn)
    assert renderer_fw._kernel_width(_cfg(dp, chn), chn) == chn
    lifted = lp.lightplane_splatter(
        lp.Rays(rt.directions, rt.origins, rt.grid_idx, rt.near, rt.far,
                enc), sizes, **kw_s)
    _, _, feat = lp.lightplane_renderer(
        lp.Rays(rt.directions, rt.origins, rt.grid_idx, rt.near, rt.far,
                torch.zeros_like(enc)), lifted, dt, **kw_r)
    loss = ((feat - enc) ** 2).sum()
    loss.backward()
    assert float(loss.detach()) > 0.0
    names = ["loss", "g_feat", "g_mlp"]
    got = [loss, enc.grad, mlp.grad]
    if chn < 768:
        compare_outputs([loss_jax, *g_jax], got, names=names,
                        magnitude_scaled=True)
        return
    # At 768 the JAX package's f32 run lies on the other side of a relu
    # kink from its own f64 run (its g_feat 5.2e-3 from it, of 3.35; its
    # g_mlp's mean relative difference 9.8e-4), where the port's f32 run is
    # 8.6e-7 from the f64 one: the port is held to the JAX package's f64
    # run, the oracle, at compare_outputs' bounds, and its loss to the f32
    # run's too.
    compare_outputs([loss_jax], [loss], names=["loss"],
                    magnitude_scaled=True)
    with jax.enable_x64(True):
        f64 = jnp.float64
        rays64 = lt.Rays(*(
            x.astype(f64) if x.dtype.kind == "f" else x
            for x in (getattr(rays, f.name)
                      for f in dataclasses.fields(rays))))

        def loss_64(enc, mlp):
            lifted = lt.lightplane_splatter(
                dataclasses.replace(rays64, encoding=enc), sizes, **kw_s)
            _, _, feat = lt.lightplane_renderer(
                dataclasses.replace(rays64, encoding=zeros.astype(f64)),
                lifted, dataclasses.replace(dp, mlp_params=mlp),
                impl="scan", **kw_r)
            return jnp.sum((feat - enc) ** 2)

        loss64, g64 = jax.jit(jax.value_and_grad(loss_64, argnums=(0, 1)))(
            feats.astype(f64), dp.mlp_params.astype(f64))
    compare_outputs([loss64, *g64], got, names=names, magnitude_scaled=True)


# ---- the splatter MLP's wide builds (csrc/splatter_fw.cu, splatter_bw.cu) --

@pytest.mark.parametrize("backward", [False, True])
def test_splat_products_and_pack(backward):
    """The splatter's schedules of a chunk's products (S1's pass F: every
    layer; S2's pass A: the relu layers, then every input gradient, last
    layer first), counted by hand, and their pack read back by hand."""
    n_hidden = (8, 40, 72, 100)
    layers = renderer_fw.wide_layers(3, 0, 0, n_hidden)
    assert [l[:2] for l in layers] == [(8, 40), (40, 72), (72, 100)]
    products = splatter_fw.splat_products(layers, backward)
    fwd = [(0, False, 1, 5), (1, False, 5, 9), (2, False, 9, 13)]
    if backward:
        assert products == fwd[:2] + [(2, True, 13, 9), (1, True, 9, 5),
                                      (0, True, 5, 1)]
    else:
        assert products == fwd
    # an int2 a slice of two k-steps (1 + 3 + 5 slices forward, + 7 + 5 +
    # 3 backward), then 32 lanes' uint4 a k-step and N-tile
    rows = 5 + (1 * 5 + 5 * 9 + 9 * 13) * 32
    if backward:
        rows = 10 + (1 * 5 + 5 * 9 + 13 * 9 + 9 * 5 + 5 * 1) * 32
    assert renderer_fw.wide_pack_bytes(products) == 16 * rows
    n_params = sum(i * o + o for i, o, _, _ in layers)
    w_np = (np.random.default_rng(5).standard_normal(n_params) * 0.3
            ).astype(np.float32)
    _check_pack(w_np, layers, products)


def _by_hand_stride(d):
    """A wide pass A tile row for d channels: d rounded up to 16, plus 4."""
    return (d + 15) // 16 * 16 + 4


@pytest.mark.parametrize("width, n_hidden", [
    (128, (32, 128, 128)), (96, (32, 96, 96)), (96, (32, 72, 72)),
    (128, (32, 128, 100)), (128, (128, 32, 128)), (128, (8,) + (128,) * 9),
    (96, (32,) + (96,) * 16), (256, (32, 256, 256)), (192, (32, 192, 192)),
    (256, (32, 160, 256)), (256, (256, 256, 256)), (192, (32,) + (160,) * 9),
    (256, (8,) + (256,) * 4)])
def test_wide_pass_a_plan(width, n_hidden):
    """S2's wide pass A: per warp a [16][stride] f32 tile for each layer's
    input and one for g_vec, then the ring (three slots of two k-steps of
    W / 8 N-tiles, at most 16, of 32 lanes' 16 bytes) and a 4-byte flag for
    each of 8 warps; the most warps, up to 8, that fit in 227 KB, in whole
    warpgroups past 4.  S1's pass F: 8 warps of one [16][W + 4] tile and
    the ring."""
    per_warp = 4 * 16 * sum(_by_hand_stride(d) for d in n_hidden)
    ring = _ring_by_hand(width)

    def smem(w):
        return w * per_warp + ring + 4 * 8

    fits = [w for w in range(1, 9) if smem(w) <= 232448]
    warps = max(fits) if max(fits) <= 4 else max(fits) // 4 * 4
    assert splatter_bw.wide_a_plan(width, n_hidden) == (warps, smem(warps))
    assert splatter_fw.pass_f_smem_bytes(width) == (
        8 * 16 * (width + 4) * 4 + ring)
    assert splatter_fw.PASS_F_WARPS == 8


def test_wide_pass_a_plan_at_the_mlp_splat():
    """The numbers of splatter_bw.cu's note, at 32 -> 128 -> 128: tiles 36,
    132 and 132 floats wide, 19,200 bytes a warp, 8 warps and the ring in
    202,784 bytes; pass F 116,736 bytes a block."""
    assert [_by_hand_stride(d) for d in (32, 128, 128)] == [36, 132, 132]
    assert splatter_bw.wide_a_plan(128, (32, 128, 128)) == (8, 202784)
    assert splatter_fw.pass_f_smem_bytes(128) == 116736


def test_wide_pass_a_plan_at_256_and_192():
    """The numbers of splatter_bw.cu's note past 128: at 32 -> 256 -> 256
    tiles 36, 260 and 260 floats wide, 35,584 bytes a warp, 4 warps (five
    fit, not eight) and the ring in 191,520 bytes; at 32 -> 192 -> 192
    27,392 bytes a warp, 4 warps in 158,752; pass F 182,272 and 149,504
    bytes a block."""
    assert [_by_hand_stride(d) for d in (32, 256, 256)] == [36, 260, 260]
    assert splatter_bw.wide_a_plan(256, (32, 256, 256)) == (4, 191520)
    assert splatter_bw.wide_a_plan(192, (32, 192, 192)) == (4, 158752)
    assert splatter_fw.pass_f_smem_bytes(256) == 182272
    assert splatter_fw.pass_f_smem_bytes(192) == 149504


def test_pass_s_bricks_at_256_channels():
    """Pass S (the per-step splat) into 3 x 128^2 x 256ch: the smallest
    brick (1 x 2 x 2 cells) exceeds the budget of three blocks an SM but
    fits a block, so it stays, and fewer blocks share an SM; no error."""
    cfg = smod._SplatCfg(96, 0, False, False, 1e-5,
                         tuple(_tri_sizes(128, 256)),
                         tuple(_tri_sizes(128, 32)), (32, 256, 256))
    bricks = splatter_fw.pick_bricks(cfg)
    assert bricks == ((1, 2, 2), (2, 1, 2), (2, 2, 1))
    smem = splatter_fw.splat_smem_bytes(0, 0, 9, 256, 2 * 64)
    assert splatter_fw.BLOCK_SMEM_BUDGET < smem <= 232448


@pytest.mark.parametrize("steps, C, want, n", [
    # 49,152 bytes of staged outputs a ray at 128 channels and 96 steps:
    # 5,440 rays a slice, 49 slices at the splat headline's 262,144 rays
    (96, 128, 5440, 49), (192, 128, 2720, 97), (96, 96, 7264, 37),
    # 98,304 bytes a ray at 256 channels: 2,720 rays a slice, 97 slices
    (96, 256, 2720, 97)])
def test_mlp_slices_cap_staging_and_run_lists(steps, C, want, n):
    """The wide MLP build's slices: each one's staged outputs and its run
    lists over the output sub-grids within PLAN_MAX_RUNS runs' bytes; the
    slices cover the rays, all but the last a multiple of 32 rays."""
    cfg = smod._SplatCfg(steps, 0, False, False, 1e-5,
                         tuple(_tri_sizes(128, C)), tuple(_tri_sizes(128, 32)),
                         (32, C, C))
    bricks = splatter_fw.pick_bricks(cfg)
    R = 262144
    slices = splatter_fw.mlp_slices(cfg, bricks, R)
    assert slices[0] == (0, want) and len(slices) == n
    assert slices[-1][1] == R
    cap = 8 * splatter_fw.PLAN_MAX_RUNS
    for (a, b), (c, _) in zip(slices, slices[1:] + [(R, None)]):
        assert b == c and a % 32 == 0
        assert 4 * (b - a) * steps * C <= cap
        for gs, brick in zip(cfg.output_grid_sizes, bricks):
            runs = splatter_fw.plan_shape(cfg, (brick,), b - a, (gs,))
            assert 8 * runs.capacity <= cap


def _tri_sizes(res, chn):
    return [(1, 1, res, res, chn), (1, res, 1, res, chn),
            (1, res, res, 1, chn)]


@pytest.mark.parametrize("hidden", [96, 128])
def test_two_pass_wide_splat_matches_jax(hidden, monkeypatch):
    """The wide MLP build's two passes in plain PyTorch (each step's MLP
    output staged once, then splatted by S1's plan into each output
    sub-grid), with the rays in slices of 32, against the JAX fused
    splatter's raw accumulators and against ``splat_fwd_torch``."""
    rng = np.random.default_rng(200 + hidden)
    n_rays = 72
    rays, out_sizes, sp, igrid, in_sizes = _splat_fixture(
        rng, (8, hidden, hidden), n_rays=n_rays)
    kw = dict(num_samples=8, mask_out_of_bounds_samples=hidden == 96)
    want = lightplane_splatter_raw(rays, out_sizes, sp, jnp.asarray(igrid),
                                   input_grid_sizes=in_sizes, **kw)
    cfg = smod._SplatCfg(8, 0, kw["mask_out_of_bounds_samples"], False,
                         1e-5, tuple(out_sizes), tuple(in_sizes),
                         tuple(sp.n_hidden))
    r = rays_to_torch(rays)
    geom = (r.directions, r.origins, r.near, r.far,
            r.grid_idx.to(torch.int32))
    diff = (r.encoding, to_torch(igrid), to_torch(sp.mlp_params))
    plain = splatter_fw.splat_fwd_torch(cfg, geom, diff)
    monkeypatch.setattr(splatter_fw, "PLAN_MAX_RUNS", 1)
    slices = splatter_fw.mlp_slices(cfg, splatter_fw.pick_bricks(cfg),
                                    n_rays)
    assert slices == [(0, 32), (32, 64), (64, 72)]
    got = splatter_fw.splat_fwd_two_pass_torch(cfg, geom, diff)
    compare_outputs(want, got, names=("feat", "w"))
    for a, b in zip(plain, got):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * scale
    assert float(got[1].sum()) > 0
