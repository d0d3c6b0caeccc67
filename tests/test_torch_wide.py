"""The port at the widths that its kernels' wide builds take (padded widths
96 and 128: ``csrc/renderer_wide.cu``, ``csrc/wide_mlp.cuh`` and the wide
builds of S1 and S2), against the JAX package on the CPU: decoder widths 72,
96 and 128 and grid channels 96 and 128 through the renderer's forward and
gradients (with one relu-field and one scaffold case), the MLP splatter at
widths 72 and 128 and into 100 and 128 output channels, the Flax modules at
those widths carried over by ``convert``, and the plain path at 9 layers and
9 sub-grids (the kernels' caps are 16 of each).

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
from lightplane_tpu_torch import convert  # noqa: E402
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


def _decoder(rng, chn, hidden, layers=(2, 2, 2), relu_field=False):
    """The JAX package's decoder layout at these widths, its parameters
    drawn from ``rng`` (N(0, 0.1^2)): wide layers then carry activations of
    the same order as their inputs."""
    dp = lt.init_decoder_params(
        jax.random.PRNGKey(0), n_layers_opacity=layers[1],
        n_layers_trunk=layers[0], n_layers_color=layers[2], input_chn=chn,
        hidden_chn=hidden, color_chn=3, use_separate_color_grid=relu_field)
    mlp = rng.standard_normal(dp.mlp_params.shape) * 0.1
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
                                           (96, 96), (100, 128), (128, 128)])
def test_kernel_width_pads_up_to_the_next_build(widest, width):
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, widest, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    assert renderer_fw._kernel_width(cfg, 8) == width


def test_kernel_width_refuses_above_128():
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, 136, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    with pytest.raises(ValueError, match="widths up to 128"):
        renderer_fw._kernel_width(cfg, 8)


# the splatter MLP's n_hidden (input 8 channels)
SPLAT_WIDE = {
    "hidden128_out128": (8, 128, 128),
    "hidden72_out100": (8, 72, 100),
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


# ---- the wide builds' host-side plan (csrc/renderer_wide.cu) ---------------

def _head(n_t, n_o, n_c, hidden, chn=32, colours=3):
    """The n_hidden tuples of a decoder of n_t / n_o / n_c layers at
    ``hidden`` (the trunk from ``chn`` channels; no trunk: the heads read
    the grid's ``chn`` channels)."""
    trunk = (chn,) + (hidden,) * n_t if n_t else ()
    head_in = hidden if n_t else chn
    opacity = (head_in,) + (hidden,) * (n_o - 1) + (1,)
    color = (head_in,) + (hidden,) * (n_c - 1) + (colours,)
    return trunk + opacity + color


def _bw_smem_by_hand(width, n_t, n_o, n_c, color_grid, warps, colours=3):
    """R2's wide block, counted from its parts: per warp a [16][W + 4] f32
    tile for each of the n_total - 1 layer inputs, one more for a colour
    grid's sample and one more for a one-layer colour head's input, the
    heads' gradient tile [16][8 + 4] (colours and opacity up to 8) and the
    ray's encoding; then three ring slots of two k-steps of W / 8 N-tiles
    of 32 lanes' 16 bytes, and 4 bytes of flag for each of 8 warps."""
    n_total = n_t + n_o + n_c
    tiles = n_total - 1 + int(color_grid) + int(n_c == 1)
    gt_cols = -(-max(colours, 1) // 8) * 8
    per_warp = 4 * (tiles * 16 * (width + 4) + 16 * (gt_cols + 4) + width)
    return warps * per_warp + 3 * 2 * (width // 8) * 32 * 16 + 4 * 8


@pytest.mark.parametrize("width", [96, 128])
@pytest.mark.parametrize("layers, color_grid", [
    ((2, 2, 2), False), ((0, 2, 2), True), ((1, 1, 1), False),
    ((0, 1, 1), False), ((3, 4, 4), False), ((8, 4, 4), False)])
def test_wide_plan_warps_and_shared_memory(width, layers, color_grid):
    """R2's warps a block (the most, up to 8, that fit in 227 KB, whole
    warpgroups past 4) and its shared memory, and R1's (8 warps of two
    [16][W + 4] tiles and the ring), as the wrapper plans them, against
    the same arithmetic done by hand."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    n_t, n_o, n_c = layers
    plan = renderer_bw.wide_bw_plan(width, n_t, n_o, n_c,
                                    _head(*layers, width), color_grid)
    fits = [w for w in range(1, 9)
            if _bw_smem_by_hand(width, *layers, color_grid, w) <= 232448]
    # whole warpgroups of 4 where more than 4 fit
    assert plan.warps == (max(fits) if max(fits) <= 4
                          else max(fits) // 4 * 4)
    assert plan.smem_bytes == _bw_smem_by_hand(width, *layers, color_grid,
                                               plan.warps)
    assert renderer_fw.wide_fw_smem_bytes(width) == (
        8 * 2 * 16 * (width + 4) * 4 + 3 * 2 * (width // 8) * 32 * 16)
    assert renderer_fw.wide_fw_smem_bytes(width) <= 232448


def test_wide_plan_at_the_render_headline():
    """The numbers of renderer_wide.cu's note: at the 2/2/2 decoder R2
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


@pytest.mark.parametrize("width, layers, color_grid", [
    # 11 layers in all at 128 (10 with a colour grid), 16 (15) at 96, and
    # deeper ones
    (128, (3, 4, 4), False), (128, (0, 5, 5), True), (128, (9, 1, 1), False),
    (96, (6, 5, 5), False), (96, (0, 8, 7), True), (96, (14, 1, 1), False),
    (128, (7, 7, 7), False), (96, (10, 10, 9), False)])
def test_wide_plan_takes_deep_configs(width, layers, color_grid):
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    plan = renderer_bw.wide_bw_plan(width, *layers, _head(*layers, width),
                                    color_grid)
    assert plan.warps >= 1 and plan.smem_bytes <= 232448


def test_wide_plan_refuses_what_does_not_fit():
    """48 layers at W = 128 need more than a block's shared memory for one
    warp: ValueError with the bytes; and widths above 128 stay refused."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    with pytest.raises(ValueError, match=r"needs \d+ bytes of shared memory"):
        renderer_bw.wide_bw_plan(128, 16, 16, 16, _head(16, 16, 16, 128),
                                 False)
    cfg = types.SimpleNamespace(n_hidden_trunk=(8, 136, 8),
                                n_hidden_opacity=(8, 8, 1),
                                n_hidden_color=(8, 8, 3))
    with pytest.raises(ValueError, match="widths up to 128"):
        renderer_fw._kernel_width(cfg, 8)


@pytest.mark.parametrize("num_sms", [132, 114])
def test_wide_partial_buffer_has_a_row_per_block(num_sms):
    """R2's partial sums: one row per block of the resident wave (one block
    a SM), whatever the warps a block, each row every layer's sums."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw

    for width, layers in ((128, (2, 2, 2)), (96, (1, 1, 1))):
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
    pack = renderer_fw.pack_wide_torch(torch.from_numpy(w_np), layers,
                                       products)
    assert pack.shape[0] * 16 == renderer_fw.wide_pack_bytes(products)
    slices = sum(-(-ks // 2) for _, _, ks, _ in products)
    head_rows = -(-slices // 2)
    sched = pack[:head_rows].reshape(-1)[:2 * slices].reshape(-1, 2).numpy()
    at = head_rows
    k = 0
    for layer, transposed, ks, nt in products:
        d_in, d_out, w_off, _ = layers[layer]
        w = w_np[w_off:w_off + d_in * d_out].reshape(d_in, d_out)
        b = w.T if transposed else w
        assert (ks, nt) == (-(-b.shape[0] // 8), -(-b.shape[1] // 8))
        # per k-step s: hi, lo; each N-tile j, k-half h: 8 rows of 4 k
        region = pack[at:at + ks * nt * 32].numpy().view(np.float32)
        region = region.reshape(ks, 2, nt, 2, 8, 4)
        want = np.zeros((8 * ks, 8 * nt), np.float32)
        want[:b.shape[0], :b.shape[1]] = b
        for s in range(ks):
            for j in range(nt):
                for h in range(2):
                    # rows n = 8 j + r, columns k = 8 s + 4 h + c
                    wv = want[8 * s + 4 * h:8 * s + 4 * h + 4,
                              8 * j:8 * j + 8].T
                    hi, lo = region[s, 0, j, h], region[s, 1, j, h]
                    assert np.array_equal(hi, _tf32_by_frexp(wv))
                    assert np.array_equal(lo, wv - hi)
                    assert np.array_equal(hi + lo, wv)
        for k0 in range(0, ks, 2):
            assert tuple(sched[k]) == (at + k0 * nt * 32,
                                       min(2, ks - k0) * nt * 32)
            k += 1
        at += ks * nt * 32
    assert k == slices and at == pack.shape[0]
    # the ties round away from zero
    assert float(renderer_fw.tf32_round(torch.tensor([1.0 + 2.0**-11]))) == (
        1.0 + 2.0**-10)
