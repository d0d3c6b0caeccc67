"""The splatter MLP at padded widths 384, 512 and 768 (S1's pass F and S2's
pass A past 256, ``csrc/splatter_wide.cuh``), against the JAX package on
the CPU: the MLP splatter at n_hidden (8, 320, 384), (32, 512, 512) and
(8, 600, 768), forward and its three gradients; the feature-field slice as
a whole (C-channel features lifted through an MLP C -> C -> C that reads a
prior triplane, then rendered back through a 2/2/2 decoder C wide with C
colours) at C = 384, 512 and 768, the loss and its gradients; ``convert``
carrying a 512-wide ``LightplaneMLPSplatter``.  The wrappers' plans past
256 (pass F's warps, shared memory and stashes, pass A's warps and shared
memory, the slices of the rays) and the refusals past 768 are checked by
hand.

Inputs are made from numpy seeds; the JAX side runs ``impl="scan"`` and its
fused splatter, as its own CPU tests run them.  On the CPU the port takes
its plain versions; the kernels themselves are held against those on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 13.
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
from lightplane_tpu_torch import convert  # noqa: E402
from lightplane_tpu_torch.ops import splatter as smod  # noqa: E402
from lightplane_tpu_torch.ops.kernels import (  # noqa: E402
    renderer_fw,
    splatter_bw,
    splatter_fw,
)

from .port_utils import (  # noqa: E402
    compare_outputs,
    rays_to_torch,
    to_torch,
)
from .test_torch_wide import (  # noqa: E402
    _cfg,
    _decoder,
    _fake_cuda,
    _planes,
    _rays,
    _splat_fixture,
    _splat_matches_jax,
    _tri_sizes,
)

torch.set_num_threads(1)
F32 = jnp.float32


@pytest.mark.parametrize("n_hidden, width", [((8, 320, 384), 384),
                                             ((32, 512, 512), 512),
                                             ((8, 600, 768), 768)])
def test_mlp_splatter_past_256_matches_jax(n_hidden, width):
    """The MLP splatter at the widths of S1's and S2's builds past 256: the
    grid and the gradients of the encoding, the input grid-list and the
    MLP against the JAX package's fused splatter."""
    cfg = smod._SplatCfg(8, 0, False, False, 1e-5, (), (), n_hidden)
    assert splatter_fw._mlp_width(cfg) == width
    rng = np.random.default_rng(400 + width)
    _splat_matches_jax(*_splat_fixture(rng, n_hidden), seed=11)


@pytest.mark.parametrize("chn", [384, 512, 768])
def test_feature_mlp_lift_then_render_matches_jax(chn):
    """The feature-field slice with the MLP lift: ``chn``-channel features of
    a few rays splatted through an MLP chn -> chn -> chn that reads a prior
    3 x 8^2 x chn triplane into a 3 x 8^2 x chn triplane, rendered back
    through a 2/2/2 decoder ``chn`` wide with ``chn`` colours, the L2 loss
    against the features; the loss and its gradients with respect to the
    features, the prior, the splatter's MLP and the decoder against the JAX
    package (``impl="scan"``)."""
    rng = np.random.default_rng(500 + chn)
    n_hidden = (chn, chn, chn)
    rays = _rays(rng, 10, chn)
    feats = rays.encoding
    sizes = _tri_sizes(8, chn)
    prior = _planes(rng, chn, res=8, scale=0.1)
    prior_flat = jnp.concatenate([g.reshape(-1, chn) for g in prior])
    in_sizes = tuple(tuple(g.shape) for g in prior)
    n_params = 2 * (chn * chn + chn)
    smlp = jnp.asarray(rng.standard_normal(n_params) * chn ** -0.5, F32)
    sp = lt.SplatterParams(mlp_params=smlp, n_hidden=n_hidden)
    dp = _decoder(rng, chn, chn, color_chn=chn)
    zeros = jnp.zeros_like(feats)
    kw_s, kw_r = dict(num_samples=10), dict(num_samples=12, gain=1.5)

    def loss_j(enc, grid, mlp_s, mlp_d):
        lifted = lt.lightplane_mlp_splatter(
            dataclasses.replace(rays, encoding=enc), sizes,
            dataclasses.replace(sp, mlp_params=mlp_s), grid,
            input_grid_sizes=in_sizes, **kw_s)
        _, _, feat = lt.lightplane_renderer(
            dataclasses.replace(rays, encoding=zeros), lifted,
            dataclasses.replace(dp, mlp_params=mlp_d), impl="scan", **kw_r)
        return jnp.sum((feat - enc) ** 2)

    loss_jax, g_jax = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3)))(feats, prior_flat, smlp,
                                       dp.mlp_params)
    rt = rays_to_torch(rays)
    leaves = [to_torch(a).requires_grad_(True)
              for a in (feats, prior_flat, smlp, dp.mlp_params)]
    enc, grid, mlp_s, mlp_d = leaves
    dt = lp.DecoderParams(mlp_d, dp.n_hidden_trunk, dp.n_hidden_opacity,
                          dp.n_hidden_color, dp.color_chn)
    assert renderer_fw._kernel_width(_cfg(dp, chn), chn) == chn
    before = (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES)
    lifted = lp.lightplane_mlp_splatter(
        lp.Rays(rt.directions, rt.origins, rt.grid_idx, rt.near, rt.far,
                enc), sizes, lp.SplatterParams(mlp_s, n_hidden), grid,
        input_grid_sizes=in_sizes, **kw_s)
    _, _, feat = lp.lightplane_renderer(
        lp.Rays(rt.directions, rt.origins, rt.grid_idx, rt.near, rt.far,
                torch.zeros_like(enc)), lifted, dt, **kw_r)
    loss = ((feat - enc) ** 2).sum()
    loss.backward()
    # CPU tensors take the plain versions, never the kernels
    assert (splatter_fw.LAUNCHES, splatter_bw.LAUNCHES) == before
    compare_outputs([loss_jax], [loss], names=["loss"],
                    magnitude_scaled=True)
    assert float(loss.detach()) > 0.0
    for x in leaves:
        assert float(x.grad.abs().sum()) > 0.0
    compare_outputs(g_jax, [x.grad for x in leaves],
                    names=["g_feat", "g_prior", "g_splat_mlp", "g_decoder"],
                    magnitude_scaled=True)


def test_convert_carries_a_512_wide_mlp_splatter():
    """The Flax ``LightplaneMLPSplatter`` 512 wide (512-channel prior, MLP
    and grid) and the port's, with the Flax variables carried over by
    ``convert``, give the same grid."""
    rng = np.random.default_rng(512)
    kw = dict(num_samples=6, grid_chn=512, input_grid_chn=512,
              mlp_hidden_chn=512)
    rays = _rays(rng, 16, 512)
    sizes = [tuple(s) for s in _tri_sizes(6, 512)]
    igrid = _planes(rng, 512, res=6, scale=0.1)
    flax_m = lt.LightplaneMLPSplatter(**kw)
    variables = flax_m.init(jax.random.PRNGKey(6), rays, sizes, igrid)
    port_m = lp.LightplaneMLPSplatter(device="cpu", **kw)
    port_m.load_state_dict(convert.mlp_splatter_module_state_from_flax(
        jax.device_get(variables), device="cpu"))
    assert tuple(port_m.mlp_params.shape) == tuple(
        variables["params"]["mlp_params"].shape)
    assert port_m._n_hidden == (512, 512, 512)
    want = flax_m.apply(variables, rays, sizes, igrid)
    with torch.no_grad():
        got = port_m(rays_to_torch(rays), sizes, [to_torch(g) for g in igrid])
    for i, (a, b) in enumerate(zip(want, got)):
        compare_outputs([a], [b], names=[f"grid{i}"], magnitude_scaled=True)


def _ring_by_hand():
    """Three ring slots of two k-steps of 16 N-tiles (at most, and so past
    128) of 32 lanes' 16 bytes."""
    return 3 * 2 * 16 * 32 * 16


def _pass_a_by_hand(n_hidden, warps):
    """Pass A's block: per warp a [16][stride] f32 tile for each layer's
    input and one for g_vec (each d rounded up to 16, plus 4), then the
    ring and a 4-byte flag for each of 8 warps."""
    per_warp = 4 * 16 * sum((d + 15) // 16 * 16 + 4 for d in n_hidden)
    return warps * per_warp + _ring_by_hand() + 4 * 8


def test_splatter_plans_past_256():
    """The numbers of splatter_wide.cuh's note.  Pass F: per warp a [16][W
    + 4] f32 tile, then the ring; eight warps would need 247,808 bytes at
    384, 313,344 at 512 and 444,416 at 768, so it takes 7 (222,976), 5
    (214,272) and 3 (197,376; four would need 246,784), each a stash in
    device memory past 256 (16 KB at 384 and 512, two N-parts' 32 KB at
    768).  Pass A at the feature MLP C -> C -> C: 2 warps at 384 (198,176
    bytes), 1 at 512 (148,256) and 1 at 768 (197,408); at 32 -> W -> W 3,
    2 and 1 (150,304 at 768); an MLP whose one warp does not fit raises
    with its bytes, 768 -> 768 -> 768 -> 768 with 246,816."""
    def pass_f(width, warps):
        return 4 * warps * 16 * (width + 4) + _ring_by_hand()

    assert (pass_f(384, 8), pass_f(512, 8), pass_f(768, 8)) == (
        247808, 313344, 444416)
    assert pass_f(384, 7) == 222976 and pass_f(512, 5) == 214272
    assert pass_f(768, 3) == 197376 and pass_f(768, 4) == 246784
    assert pass_f(384, 8) > 232448 >= pass_f(384, 7)
    assert pass_f(512, 6) > 232448 >= pass_f(512, 5)
    assert pass_f(768, 4) > 232448 >= pass_f(768, 3)
    for width, warps, smem, stash in ((768, 3, 197376, 3 * 32768),
                                      (384, 7, 222976, 7 * 16384),
                                      (512, 5, 214272, 5 * 16384),
                                      (256, 8, 182272, 0),
                                      (128, 8, 116736, 0)):
        assert splatter_fw.pass_f_warps(width) == warps
        assert splatter_fw.pass_f_smem_bytes(width) == smem
        assert splatter_fw.pass_f_scratch_bytes(width) == stash
    assert renderer_fw.WIDE_STASH_FLOATS * 4 == 16384
    # at 768 the stash holds two of a product's three N-parts
    assert renderer_fw.wide_stash_floats(768) * 4 == 32768
    for width, n_hidden, warps, smem in (
            (384, (384, 384, 384), 2, 198176),
            (512, (512, 512, 512), 1, 148256),
            (768, (768, 768, 768), 1, 197408),
            (384, (32, 384, 384), 3, None), (512, (32, 512, 512), 2, None),
            (768, (32, 768, 768), 1, 150304)):
        want = (warps, smem or _pass_a_by_hand(n_hidden, warps))
        assert want[1] == _pass_a_by_hand(n_hidden, warps)
        assert splatter_bw.wide_a_plan(width, n_hidden) == want
        assert _pass_a_by_hand(n_hidden, warps + 1) > 232448
    with pytest.raises(ValueError, match="needs 247328 bytes"):
        splatter_bw.wide_a_plan(512, (512,) * 6)
    with pytest.raises(ValueError, match="needs 246816 bytes"):
        splatter_bw.wide_a_plan(768, (768,) * 4)


@pytest.mark.parametrize("chn, R, rays_a_slice, n_slices", [
    (384, 32768, 1792, 19), (512, 32768, 1344, 25), (768, 16384, 896, 19)])
def test_mlp_slices_at_feature_widths(chn, R, rays_a_slice, n_slices):
    """The feature lift's slices (96 samples into 3 x 128^2 x chn, phase
    13's R rays: two views of 128^2, one at 768): each slice's staged MLP
    outputs within PLAN_MAX_RUNS' 256 MiB, 4 x 96 x chn bytes a ray; S2's
    gathers and pass A take the same slices (g_vec's staging is as wide)
    and so does pass B (its g_in staging, the prior's chn channels)."""
    cfg = smod._SplatCfg(96, 0, False, False, 1e-5,
                         tuple(_tri_sizes(128, chn)),
                         tuple(_tri_sizes(128, chn)), (chn, chn, chn))
    assert 8 * splatter_fw.PLAN_MAX_RUNS == 256 << 20
    assert rays_a_slice == (256 << 20) // (4 * 96 * chn) // 32 * 32
    slices = splatter_fw.mlp_slices(cfg, splatter_fw.pick_bricks(cfg), R)
    assert slices[0] == (0, rays_a_slice) and len(slices) == n_slices
    assert slices[-1][1] == R
    in_bricks = splatter_fw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    assert splatter_bw.adjoint_slices(cfg, in_bricks, R) == slices
    assert splatter_bw.gvec_slices(cfg, 0, rays_a_slice) == [
        (0, rays_a_slice)]


def _fake_splat_inputs(n_hidden, out_sizes, in_sizes, n=4):
    """An MLP splat's ``(cfg, geom, diff)`` on tensors that report a CUDA
    device (``_fake_cuda``): the wrappers' checks run up to the build."""
    cfg = smod._SplatCfg(4, 0, False, False, 1e-5, tuple(out_sizes),
                         tuple(in_sizes), n_hidden)
    geom = tuple(_fake_cuda(t) for t in (
        torch.zeros((n, 3)), torch.zeros((n, 3)), torch.zeros((n,)),
        torch.ones((n,)), torch.zeros((n,), dtype=torch.int32)))
    v_in = sum(int(np.prod(s[:-1])) for s in in_sizes)
    n_params = sum(a * b + b for a, b in zip(n_hidden, n_hidden[1:]))
    diff = (_fake_cuda(torch.zeros((n, n_hidden[0]))),
            _fake_cuda(torch.zeros((v_in, n_hidden[0]))),
            _fake_cuda(torch.zeros((n_params,))))
    return cfg, geom, diff


@pytest.mark.parametrize("case", [
    # an MLP 264 wide pads up to the build at 384, 520 up to 768
    "mlp_264_takes_384", "mlp_512_takes_512", "mlp_520_takes_768",
    "mlp_768_takes_768", "mlp_776_refused", "voxel_386_refused"])
def test_splatter_mlp_refusals(case):
    """On CUDA tensors the splatter's MLP takes the builds up to 768, the
    renderer's, and raises past them ("MLP widths up to 768"); a per-step
    splat into a voxel grid past 385 channels raises, naming that cap (its
    smallest brick's tile in a block's shared memory), while a plane takes
    up to 1,157."""
    tri = tuple(_tri_sizes(4, 8))
    if case == "voxel_386_refused":
        cfg, geom, diff = _fake_splat_inputs(
            (8, 512, 386), [(1, 4, 4, 4, 386)], tri)
        with pytest.raises(ValueError, match="up to 385 channels"):
            splatter_fw.splat_fwd_cuda(cfg, geom, diff)
        cfg, _, _ = _fake_splat_inputs((8, 512, 385), [(1, 4, 4, 4, 385)],
                                       tri)
        assert splatter_fw.pick_bricks(cfg) == ((2, 2, 2),)
        # the adjoint's pass B into a 1,158-channel triplane
        with pytest.raises(ValueError, match="up to 1157 channels"):
            splatter_fw.pick_bricks(cfg, grid_sizes=_tri_sizes(4, 1158))
        return
    hidden = int(case.split("_")[1])
    n_hidden = (8, hidden, 8)
    cfg, geom, diff = _fake_splat_inputs(n_hidden, _tri_sizes(4, 8), tri)
    assert splatter_fw.MLP_WIDTHS[-1] == 768
    if case.endswith("refused"):
        with pytest.raises(ValueError, match="MLP widths up to 768"):
            splatter_fw.splat_launch_args(cfg, geom, diff, "splat_fwd_cuda")
    else:
        a = splatter_fw.splat_launch_args(cfg, geom, diff, "splat_fwd_cuda")
        assert a.width == int(case.split("_")[-1])
