"""The cases of ``tests/test_torch_parallel.py`` without JAX: numpy inputs
made from a seed, each case run through ``lightplane_tpu_torch.parallel`` on
a rank of a process group or through the single-process port, and the
worker that a spawned rank of the test's gloo world runs.

A case is ``fn(mesh)``: with a mesh it runs on this rank's shard of the
rays and returns this rank's rows of the per-ray results; with ``None`` it
runs the single-process port on every ray.  The numpy inputs come from
``inputs(name)``, which the test also hands to the JAX package.  This
module imports no JAX, so the spawned ranks stay free of it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import lightplane_tpu_torch as lp
from lightplane_tpu_torch import parallel

WORLD = 2
N_RAYS = 64      # 2 and the JAX tests' 8 devices both divide it
N_PADDED = 63    # pads to 64 over 2 ranks and over 8 devices alike


def np_rays(rng, n, batch=1, enc_dim=None):
    """Rays aimed from a shell at z = -2 toward the origin, near ~0.1 and
    far ~3 (``tests/utils.py::random_rays`` in numpy)."""
    origins = rng.standard_normal((n, 3)) / 3.0 + np.array([0.0, 0.0, -2.0])
    targets = rng.standard_normal((n, 3)) * 0.2
    rays = dict(
        directions=targets - origins, origins=origins,
        grid_idx=rng.integers(0, batch, n),
        near=0.1 + 0.05 * rng.random(n), far=3.0 + 0.2 * rng.random(n),
        encoding=(None if enc_dim is None
                  else rng.standard_normal((n, enc_dim)) * 0.1),
    )
    return {k: (v if v is None or k == "grid_idx" else v.astype(np.float32))
            for k, v in rays.items()}


def np_decoder(rng, input_chn, hidden_chn, **kw):
    """The layout of ``init_decoder_params`` with N(0, 0.05) values, as
    ``tests/utils.py::random_decoder_params`` draws them."""
    dp = lp.init_decoder_params(None, n_layers_opacity=2, n_layers_trunk=2,
                                n_layers_color=2, input_chn=input_chn,
                                hidden_chn=hidden_chn, color_chn=3,
                                device="cpu", **kw)
    return dict(
        mlp_params=(rng.standard_normal(dp.mlp_params.shape) * 0.05
                    ).astype(np.float32),
        n_hidden_trunk=dp.n_hidden_trunk,
        n_hidden_opacity=dp.n_hidden_opacity,
        n_hidden_color=dp.n_hidden_color, color_chn=dp.color_chn)


def np_splatter_params(seed, chn, n_layers=2):
    """The port's initial splatter MLP ``chn -> chn -> chn``, as numpy."""
    sp = lp.init_splatter_params(torch.Generator().manual_seed(seed),
                                 n_layers, chn, chn, chn, device="cpu")
    return dict(mlp_params=sp.mlp_params.numpy(), n_hidden=sp.n_hidden)


def np_grid(rng, shapes, scale):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def inputs(name):
    """The numpy inputs of case ``name`` (the shapes of
    ``tests/test_parallel.py``, at 64 rays)."""
    rng = np.random.default_rng(list(CASES).index(name))
    if name == "render_fwd":
        dec = np_decoder(rng, 8, 8)
        return dict(rays=np_rays(rng, N_RAYS, 2, dec["n_hidden_color"][0]),
                    grid=np_grid(rng, [(2, 5, 5, 5, 8)], 0.5), dec=dec,
                    kw=dict(num_samples=6, gain=1.0))
    if name == "render_grad":
        dec = np_decoder(rng, 8, 8)
        return dict(rays=np_rays(rng, N_RAYS, 1, dec["n_hidden_color"][0]),
                    grid=np_grid(rng, [(1, 4, 4, 4, 8)], 0.5), dec=dec,
                    kw=dict(num_samples=5, gain=1.0))
    if name in ("splat_fwd", "splat_grad"):
        return dict(rays=np_rays(rng, N_RAYS, 2, 16),
                    sizes=[(2, 4, 4, 4, 16)], kw=dict(num_samples=6))
    if name == "mlp_splat":
        return dict(rays=np_rays(rng, N_RAYS, 1, 16),
                    sp=np_splatter_params(4, 16),
                    igrid=np_grid(rng, [(1, 5, 5, 5, 16)], 0.5),
                    sizes=[(1, 4, 4, 4, 16)], kw=dict(num_samples=6))
    if name == "sorted_big":
        # 13,824 cells: past the TPU kernels' VMEM cap, its sorted path
        return dict(rays=np_rays(rng, N_RAYS, 1, 4),
                    sizes=[(1, 24, 24, 24, 4)], kw=dict(num_samples=6))
    if name == "pad":
        dec = np_decoder(rng, 8, 8)
        rays = np_rays(rng, N_PADDED, 1, dec["n_hidden_color"][0])
        return dict(rays=rays, grid=np_grid(rng, [(1, 4, 4, 4, 8)], 0.5),
                    dec=dec, kw=dict(num_samples=5, gain=1.0),
                    splat_enc=(rng.standard_normal((N_PADDED, 16)) * 0.1
                               ).astype(np.float32),
                    sizes=[(1, 4, 4, 4, 16)], splat_kw=dict(num_samples=6))
    if name == "dryrun":
        return dryrun_inputs(rng)
    raise KeyError(name)


def dryrun_inputs(rng, n_rays=N_RAYS, res=8, chn=16):
    """``__graft_entry__.py::_make_example`` (a triplane 3 x 8^2 x 16ch, a
    decoder of hidden width 32, rays fanned in x from z = -2) and
    ``dryrun_multichip``'s splatter MLP and per-ray features, in numpy."""
    dec = lp.init_decoder_params(
        torch.Generator().manual_seed(0), n_layers_opacity=2,
        n_layers_trunk=2, n_layers_color=2, input_chn=chn, hidden_chn=32,
        color_chn=3, opacity_init_bias=-2.0, device="cpu")
    t = np.linspace(-0.4, 0.4, n_rays)
    rays = dict(
        directions=np.stack([t, np.zeros_like(t), np.ones_like(t)], -1),
        origins=np.tile([[0.0, 0.0, -2.0]], (n_rays, 1)),
        grid_idx=np.zeros(n_rays, np.int64),
        near=np.full(n_rays, 1.0), far=np.full(n_rays, 3.0),
        encoding=rng.standard_normal((n_rays, dec.n_hidden_color[0])) * 0.1)
    rays = {k: v if k == "grid_idx" else v.astype(np.float32)
            for k, v in rays.items()}
    return dict(
        rays=rays,
        grid=np_grid(rng, [(1, 1, res, res, chn), (1, res, 1, res, chn),
                           (1, res, res, 1, chn)], 0.1),
        dec=dict(mlp_params=dec.mlp_params.numpy(),
                 n_hidden_trunk=dec.n_hidden_trunk,
                 n_hidden_opacity=dec.n_hidden_opacity,
                 n_hidden_color=dec.n_hidden_color, color_chn=3),
        sp=np_splatter_params(5, chn),
        enc=(rng.standard_normal((n_rays, chn)) * 0.1).astype(np.float32))


def port_rays(r, encoding=None):
    enc = r["encoding"] if encoding is None else encoding
    t = torch.from_numpy
    return lp.Rays(directions=t(r["directions"]), origins=t(r["origins"]),
                   grid_idx=t(r["grid_idx"]), near=t(r["near"]),
                   far=t(r["far"]),
                   encoding=None if enc is None else torch.as_tensor(enc))


def port_decoder(d, mlp_params=None):
    mlp = torch.from_numpy(d["mlp_params"]) if mlp_params is None else \
        mlp_params
    return lp.DecoderParams(mlp, d["n_hidden_trunk"], d["n_hidden_opacity"],
                            d["n_hidden_color"], d["color_chn"])


def leaf(a):
    return torch.tensor(a, requires_grad=True)


def shard_slice(rank, size, n):
    """Rank ``rank``'s rows of ``n`` rays over ``size`` ranks."""
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def rows(mesh, n):
    """This rank's rows of ``n`` rays (all of them without a mesh)."""
    return slice(0, n) if mesh is None else shard_slice(mesh.rank,
                                                        mesh.size, n)


def renderer(mesh, **defaults):
    if mesh is None:
        return lambda rays, grid, dp, **kw: lp.lightplane_renderer(
            rays, grid, dp, **defaults, **kw)
    render = parallel.data_parallel_renderer(mesh, **defaults)
    return lambda rays, grid, dp, **kw: render(
        parallel.shard_rays(rays, mesh), grid, dp, **kw)


def splatter(mesh, use_mlp=False, **defaults):
    """``splat(rays, sizes, mlp_params, input_grid, **kw)``, flat output."""
    if mesh is not None:
        splat = parallel.data_parallel_splatter(mesh, use_mlp=use_mlp,
                                                **defaults)
        return lambda rays, sizes, sp=None, ig=None, **kw: splat(
            parallel.shard_rays(rays, mesh), sizes, mlp_params=sp,
            input_grid=ig, return_list=False, **kw)
    if use_mlp:
        return lambda rays, sizes, sp, ig, **kw: lp.lightplane_mlp_splatter(
            rays, sizes, sp, ig, return_list=False, **defaults, **kw)
    return lambda rays, sizes, sp=None, ig=None, **kw: lp.lightplane_splatter(
        rays, sizes, return_list=False, **defaults, **kw)


def np_out(*xs):
    return [x.detach().numpy().copy() for x in xs]


def case_render_fwd(mesh):
    i = inputs("render_fwd")
    with torch.no_grad():
        out = renderer(mesh)(port_rays(i["rays"]),
                             [torch.from_numpy(g) for g in i["grid"]],
                             port_decoder(i["dec"]), **i["kw"])
    return dict(zip(("depth", "nlt", "feat"), np_out(*out)))


def case_render_grad(mesh):
    i = inputs("render_grad")
    grid, mlp = leaf(i["grid"][0]), leaf(i["dec"]["mlp_params"])
    out = renderer(mesh)(port_rays(i["rays"]), [grid],
                         port_decoder(i["dec"], mlp), **i["kw"])
    sum(o.sum() for o in out).backward()
    return dict(grid=grid.grad.numpy(), mlp=mlp.grad.numpy())


def case_splat_fwd(mesh):
    i = inputs("splat_fwd")
    with torch.no_grad():
        out = splatter(mesh)(port_rays(i["rays"]), i["sizes"], **i["kw"])
    return dict(out=out.numpy())


def case_splat_grad(mesh):
    i = inputs("splat_grad")
    enc = leaf(i["rays"]["encoding"])
    out = splatter(mesh)(port_rays(i["rays"], enc), i["sizes"], **i["kw"])
    out.square().sum().backward()
    return dict(enc=enc.grad[rows(mesh, N_RAYS)].numpy())


def case_mlp_splat(mesh):
    i = inputs("mlp_splat")
    enc, mlp = leaf(i["rays"]["encoding"]), leaf(i["sp"]["mlp_params"])
    igrid = leaf(i["igrid"][0])
    out = splatter(mesh, use_mlp=True)(
        port_rays(i["rays"], enc), i["sizes"],
        lp.SplatterParams(mlp, i["sp"]["n_hidden"]), [igrid], **i["kw"])
    out.square().sum().backward()
    return dict(out=out.detach().numpy(),
                enc=enc.grad[rows(mesh, N_RAYS)].numpy(),
                mlp=mlp.grad.numpy(), igrid=igrid.grad.numpy())


def case_sorted_big(mesh):
    i = inputs("sorted_big")
    enc = leaf(i["rays"]["encoding"])
    out = splatter(mesh)(port_rays(i["rays"], enc), i["sizes"], **i["kw"])
    out.square().sum().backward()
    return dict(out=out.detach().numpy(),
                enc=enc.grad[rows(mesh, N_RAYS)].numpy())


def case_pad(mesh):
    """Pad 63 rays with a zero ray: the renderer's real rows, and the
    splat with the zero ray in it.  Without a mesh: the port on the 63
    rays, and on the padded 64 (the splat's reference)."""
    i = inputs("pad")
    rays = port_rays(i["rays"])
    padded, n_pad = parallel.pad_rays_to_devices(rays, WORLD)
    assert n_pad == 1 and len(padded) == N_RAYS
    splat_rays, _ = parallel.pad_rays_to_devices(
        port_rays(i["rays"], i["splat_enc"]), WORLD)
    grid = [torch.from_numpy(g) for g in i["grid"]]
    with torch.no_grad():
        out = renderer(mesh)(rays if mesh is None else padded, grid,
                             port_decoder(i["dec"]), **i["kw"])
        splat = splatter(mesh)(splat_rays, i["sizes"], **i["splat_kw"])
        res = dict(zip(("depth", "nlt", "feat"), np_out(*out)),
                   splat=splat.numpy())
        if mesh is None:
            unpadded = lp.lightplane_splatter(
                port_rays(i["rays"], i["splat_enc"]), i["sizes"],
                return_list=False, **i["splat_kw"])
            res["splat_unpadded"] = unpadded.numpy()
    return res


def dryrun_params(i):
    return dict(grid=[leaf(g) for g in i["grid"]],
                mlp=leaf(i["dec"]["mlp_params"]),
                splat_mlp=leaf(i["sp"]["mlp_params"]), enc=leaf(i["enc"]))


def case_dryrun(mesh):
    """``__graft_entry__.py::dryrun_multichip``: the MLP splatter lifts
    per-ray features into a triplane, the renderer renders it back, and
    one Adam step takes the loss's gradient; the loss is the mean over
    all the rays, so each rank's share is its rows' sum over the global
    count, and the ranks' shares add up to it."""
    i = inputs("dryrun")
    params = dryrun_params(i)
    sizes = [g.shape for g in i["grid"]]
    rays = port_rays(i["rays"])
    splat_rays = port_rays(i["rays"], params["enc"])
    sp = lp.SplatterParams(params["splat_mlp"], i["sp"]["n_hidden"])
    if mesh is None:
        lifted = lp.lightplane_mlp_splatter(splat_rays, sizes, sp,
                                            params["grid"], num_samples=6)
    else:
        splat = parallel.data_parallel_splatter(mesh, use_mlp=True,
                                                num_samples=6)
        lifted = splat(parallel.shard_rays(splat_rays, mesh), sizes,
                       mlp_params=sp, input_grid=params["grid"])
    render = renderer(mesh, num_samples=8, gain=1.0)
    _, nlt, feat = render(rays, lifted,
                          port_decoder(i["dec"], params["mlp"]))
    n = len(rays)
    loss = feat.square().sum() / feat.shape[-1] / n \
        + 1e-4 * nlt.square().sum() / n
    opt = torch.optim.Adam(
        [*params["grid"], params["mlp"], params["splat_mlp"],
         params["enc"]], lr=1e-3)
    opt.zero_grad()
    loss.backward()
    grads = dict(grid=[g.grad.clone() for g in params["grid"]],
                 mlp=params["mlp"].grad.clone(),
                 splat_mlp=params["splat_mlp"].grad.clone(),
                 enc=params["enc"].grad[rows(mesh, n)].clone())
    opt.step()
    total = loss.detach().clone()
    if mesh is not None:
        torch.distributed.all_reduce(total)
    for name, g in grads.items():
        for x in (g if isinstance(g, list) else [g]):
            assert torch.isfinite(x).all(), name
        assert sum(float(x.abs().sum())
                   for x in (g if isinstance(g, list) else [g])) > 0, name
    moved = float(params["mlp"].detach().sub(
        torch.from_numpy(i["dec"]["mlp_params"])).abs().max())
    return dict(loss=total.numpy(), moved=np.float64(moved),
                **{k: ([x.numpy() for x in v] if isinstance(v, list)
                       else v.numpy()) for k, v in grads.items()})


CASES = {
    "render_fwd": case_render_fwd,
    "render_grad": case_render_grad,
    "splat_fwd": case_splat_fwd,
    "splat_grad": case_splat_grad,
    "mlp_splat": case_mlp_splat,
    "sorted_big": case_sorted_big,
    "pad": case_pad,
    "dryrun": case_dryrun,
}


def worker(rank, store, out_path):
    """One rank of the test's gloo world: run every case on this rank's
    shard and save the results with ``torch.save``."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD)
    try:
        assert parallel.make_mesh().device.type == "cuda"
        mesh = parallel.make_mesh(["cpu"] * WORLD)
        try:
            parallel.shard_rays(port_rays(inputs("pad")["rays"]), mesh)
        except ValueError as e:
            assert "pad_rays_to_devices" in str(e), e
        else:
            raise AssertionError("shard_rays split 63 rays over 2 ranks")
        results = {name: fn(mesh) for name, fn in CASES.items()}
    finally:
        torch.distributed.destroy_process_group()
    assert "jax" not in sys.modules, "the port imported jax"
    torch.save(results, out_path)
