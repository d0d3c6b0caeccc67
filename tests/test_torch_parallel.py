"""The port's data-parallel layer (``lightplane_tpu_torch.parallel``) in a
world of two gloo ranks on the CPU, against the single-process port and
against the JAX package's ``lightplane_tpu.parallel`` on the 8-device CPU
mesh that ``tests/conftest.py`` sets up.

One world serves the module: a fixture spawns two ranks
(``torch.multiprocessing``, ``spawn``) that meet through a file store in a
temporary directory (no port, so parallel test workers cannot collide),
run every case of ``tests/torch_parallel_cases.py`` on their shards, check
that they imported no JAX and save their results.  While they run, the
tests compute the JAX side; the first test that needs the ranks' results
joins them with a timeout and kills them if they hang.

The cases mirror ``tests/test_parallel.py`` on its shapes at 64 rays (2
ranks and 8 devices both divide it), plus ``pad_rays_to_devices`` on 63
rays and ``__graft_entry__.py::dryrun_multichip``'s training step.
Bounds: ``atol`` 1e-5 on forward outputs and ``compare_one(max_diff=1e-4,
mean_diff=1e-5)`` on gradients, those of ``tests/test_parallel.py``.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lightplane_tpu as lt  # noqa: E402
from lightplane_tpu.parallel import (  # noqa: E402
    data_parallel_renderer,
    data_parallel_splatter,
    make_mesh,
    pad_rays_to_devices,
    shard_rays,
)
from lightplane_tpu_torch import parallel  # noqa: E402

from . import torch_parallel_cases as cases  # noqa: E402
from .utils import compare_one  # noqa: E402

FWD_ATOL = 1e-5
GRAD_BOUNDS = dict(max_diff=1e-4, mean_diff=1e-5)
# a bare two-rank gloo round trip takes a few seconds here; every case
# together well under a minute
JOIN_TIMEOUT_S = 120


class _World:
    """The spawned ranks and, once joined, their results."""

    def __init__(self, tmp):
        ctx = torch.multiprocessing.get_context("spawn")
        self.paths = [tmp / f"rank{r}.pt" for r in range(cases.WORLD)]
        self.procs = [
            ctx.Process(target=cases.worker,
                        args=(r, str(tmp / "store"), str(self.paths[r])))
            for r in range(cases.WORLD)]
        for p in self.procs:
            p.start()
        self._results = None
        self._error = None

    def results(self):
        """Each rank's results, joined once with a timeout."""
        if self._results is None and self._error is None:
            deadline = time.monotonic() + JOIN_TIMEOUT_S
            for p in self.procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            self.stop()
            codes = [p.exitcode for p in self.procs]
            if hung:
                self._error = f"ranks {hung} hung past {JOIN_TIMEOUT_S} s"
            elif any(codes):
                self._error = f"ranks exited with {codes}"
            else:
                self._results = [torch.load(p, weights_only=False)
                                 for p in self.paths]
        if self._error is not None:
            pytest.fail(self._error)
        return self._results

    def stop(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = _World(tmp_path_factory.mktemp("gloo"))
    yield w
    w.stop()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should force 8 CPU devices"
    return make_mesh()


def rank_results(world, name):
    return [res[name] for res in world.results()]


def stacked(per_rank, key):
    """The ranks' rows of a per-ray result, in rank order."""
    return np.concatenate([r[key] for r in per_rank])


def check_fwd(got, want, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=FWD_ATOL, err_msg=name)


def check_grad(got, want, name):
    compare_one(np.asarray(want), np.asarray(got), name, **GRAD_BOUNDS)


# ---- the JAX side, on the same numpy inputs ------------------------------

def jax_rays(r, encoding=None):
    enc = r["encoding"] if encoding is None else encoding
    return lt.Rays(
        directions=jnp.asarray(r["directions"]),
        origins=jnp.asarray(r["origins"]),
        grid_idx=jnp.asarray(r["grid_idx"], jnp.int32),
        near=jnp.asarray(r["near"]), far=jnp.asarray(r["far"]),
        encoding=None if enc is None else jnp.asarray(enc))


def jax_decoder(d, mlp=None):
    return lt.DecoderParams(
        mlp_params=jnp.asarray(d["mlp_params"]) if mlp is None else mlp,
        n_hidden_trunk=d["n_hidden_trunk"],
        n_hidden_opacity=d["n_hidden_opacity"],
        n_hidden_color=d["n_hidden_color"], color_chn=d["color_chn"])


def jax_splat_grad(mesh, i, **kw):
    """The data-parallel splat and the encoding's gradient of
    ``sum(out^2)``."""
    splat = data_parallel_splatter(mesh)
    rays = jax_rays(i["rays"])

    def loss(enc):
        out = splat(dataclasses.replace(rays, encoding=enc), i["sizes"],
                    return_list=False, **i["kw"], **kw)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        rays.encoding)
    return out, g


# ---- the cases ----------------------------------------------------------

def test_dp_renderer_matches_single(world, mesh):
    i = cases.inputs("render_fwd")
    render = jax.jit(functools.partial(data_parallel_renderer(mesh),
                                       **i["kw"]))
    want = render(shard_rays(jax_rays(i["rays"]), mesh),
                  [jnp.asarray(g) for g in i["grid"]], jax_decoder(i["dec"]))
    single = cases.case_render_fwd(None)
    ranks = rank_results(world, "render_fwd")
    for k, name in enumerate(("depth", "nlt", "feat")):
        for r, res in enumerate(ranks):
            rows = cases.shard_slice(r, cases.WORLD, cases.N_RAYS)
            check_fwd(res[name], single[name][rows], f"{name} rank {r}")
        check_fwd(stacked(ranks, name), want[k], f"{name} vs JAX")


def test_dp_renderer_grad_psum(world, mesh):
    i = cases.inputs("render_grad")
    render = data_parallel_renderer(mesh)
    rays = jax_rays(i["rays"])

    def loss(g, p):
        out = render(rays, [g], jax_decoder(i["dec"], p), **i["kw"])
        return sum(jnp.sum(o) for o in out)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(i["grid"][0]), jnp.asarray(i["dec"]["mlp_params"]))
    single = cases.case_render_grad(None)
    for r, res in enumerate(rank_results(world, "render_grad")):
        for k, name in enumerate(("grid", "mlp")):
            check_grad(res[name], single[name], f"grad_{name} rank {r}")
            check_grad(res[name], want[k], f"grad_{name} rank {r} vs JAX")


def test_dp_splatter_matches_single(world, mesh):
    i = cases.inputs("splat_fwd")
    splat = functools.partial(data_parallel_splatter(mesh),
                              output_grid_size=i["sizes"], return_list=False,
                              **i["kw"])
    want = jax.jit(splat)(jax_rays(i["rays"]))
    single = cases.case_splat_fwd(None)
    for r, res in enumerate(rank_results(world, "splat_fwd")):
        check_fwd(res["out"], single["out"], f"splat rank {r}")
        check_fwd(res["out"], want, f"splat rank {r} vs JAX")


def test_dp_splatter_grad_psum(world, mesh):
    """The raw accumulators are summed before the quotient, and the
    gradient reaching the sum goes back to each rank's partial unchanged:
    each rank's encoding rows get the single-process gradient."""
    i = cases.inputs("splat_grad")
    _, want = jax_splat_grad(mesh, i)
    single = cases.case_splat_grad(None)
    ranks = rank_results(world, "splat_grad")
    check_grad(stacked(ranks, "enc"), single["enc"], "grad_enc")
    check_grad(stacked(ranks, "enc"), want, "grad_enc vs JAX")


def test_dp_mlp_splatter_grad(world, mesh):
    """With the MLP: the output, the encoding's rows, and the MLP's and the
    input grid's gradients, summed over the ranks once."""
    i = cases.inputs("mlp_splat")
    splat = data_parallel_splatter(mesh, use_mlp=True)
    rays = jax_rays(i["rays"])

    def loss(enc, mp, ig):
        out = splat(dataclasses.replace(rays, encoding=enc), i["sizes"],
                    mlp_params=lt.SplatterParams(mp, i["sp"]["n_hidden"]),
                    input_grid=[ig], return_list=False, **i["kw"])
        return jnp.sum(out ** 2), out

    (_, out), want = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                has_aux=True))(
        rays.encoding, jnp.asarray(i["sp"]["mlp_params"]),
        jnp.asarray(i["igrid"][0]))
    single = cases.case_mlp_splat(None)
    ranks = rank_results(world, "mlp_splat")
    check_grad(stacked(ranks, "enc"), single["enc"], "grad_enc")
    check_grad(stacked(ranks, "enc"), want[0], "grad_enc vs JAX")
    for r, res in enumerate(ranks):
        check_fwd(res["out"], single["out"], f"out rank {r}")
        check_fwd(res["out"], out, f"out rank {r} vs JAX")
        for k, name in ((1, "mlp"), (2, "igrid")):
            check_grad(res[name], single[name], f"grad_{name} rank {r}")
            check_grad(res[name], want[k], f"grad_{name} rank {r} vs JAX")


def test_dp_sorted_splatter_big_grid(world, mesh):
    """A 24^3 x 4 grid, past the TPU kernels' VMEM cap: the JAX package
    splats it on its sorted path (its kernels in interpret mode here), the
    port as any other grid."""
    from lightplane_tpu.ops.kernels import renderer_pallas as rp

    i = cases.inputs("sorted_big")
    assert 24 ** 3 > rp.MAX_CELLS_PER_GRID
    rp.INTERPRET = True
    try:
        out, want = jax_splat_grad(mesh, i, impl="sorted")
    finally:
        rp.INTERPRET = False
    single = cases.case_sorted_big(None)
    ranks = rank_results(world, "sorted_big")
    for r, res in enumerate(ranks):
        check_fwd(res["out"], single["out"], f"out rank {r}")
        check_fwd(res["out"], out, f"out rank {r} vs JAX")
    check_grad(stacked(ranks, "enc"), single["enc"], "grad_enc")
    check_grad(stacked(ranks, "enc"), want, "grad_enc vs JAX")


def test_dp_pad_rays_to_devices(world, mesh):
    """63 rays padded with a zero ray.  The renderer's real rows are the
    unpadded single-process render.  The zero ray marches a zero-length
    segment at the origin and adds its unit splat weights there, in the
    JAX package as in the port, so the padded splat equals the padded
    single-process splat and JAX's, not the unpadded one."""
    i = cases.inputs("pad")
    rays, n_pad = pad_rays_to_devices(jax_rays(i["rays"]), 8)
    assert n_pad == 1
    render = jax.jit(functools.partial(data_parallel_renderer(mesh),
                                       **i["kw"]))
    want = render(shard_rays(rays, mesh), [jnp.asarray(g) for g in i["grid"]],
                  jax_decoder(i["dec"]))
    splat_rays, _ = pad_rays_to_devices(
        jax_rays(i["rays"], i["splat_enc"]), 8)
    splat = functools.partial(data_parallel_splatter(mesh),
                              output_grid_size=i["sizes"], return_list=False,
                              **i["splat_kw"])
    want_splat = jax.jit(splat)(splat_rays)
    single = cases.case_pad(None)
    ranks = rank_results(world, "pad")
    for k, name in enumerate(("depth", "nlt", "feat")):
        got = stacked(ranks, name)
        assert got.shape[0] == cases.N_RAYS
        check_fwd(got[:cases.N_PADDED], single[name], name)
        check_fwd(got[:cases.N_PADDED], want[k][:cases.N_PADDED],
                  f"{name} vs JAX")
    for r, res in enumerate(ranks):
        check_fwd(res["splat"], single["splat"], f"splat rank {r}")
        check_fwd(res["splat"], want_splat, f"splat rank {r} vs JAX")
    assert np.abs(single["splat"] - single["splat_unpadded"]).max() > 1e-3


def test_dp_dryrun_multichip_step(world, mesh):
    """``__graft_entry__.py::dryrun_multichip``: one Adam step through the
    data-parallel MLP splatter and renderer.  Every parameter group gets a
    finite, non-zero gradient (checked in the ranks), and the loss and the
    gradients equal the single-process port's and those of the JAX
    function body on the 8-device mesh: a second all-reduce on any path
    would scale its gradient by the world size."""
    i = cases.inputs("dryrun")
    sizes = tuple(tuple(g.shape) for g in i["grid"])
    rays = shard_rays(jax_rays(i["rays"]), mesh)
    render = data_parallel_renderer(mesh, num_samples=8, gain=1.0)
    splat = data_parallel_splatter(mesh, use_mlp=True, num_samples=6)

    def loss_fn(params):
        lifted = splat(
            dataclasses.replace(rays, encoding=params["enc"]), sizes,
            mlp_params=lt.SplatterParams(params["splat_mlp"],
                                         i["sp"]["n_hidden"]),
            input_grid=params["grid"], return_list=True)
        _, nlt, feat = render(rays, lifted,
                              jax_decoder(i["dec"], params["mlp"]))
        return jnp.mean(feat ** 2) + 1e-4 * jnp.mean(nlt ** 2)

    params = dict(grid=[jnp.asarray(g) for g in i["grid"]],
                  mlp=jnp.asarray(i["dec"]["mlp_params"]),
                  splat_mlp=jnp.asarray(i["sp"]["mlp_params"]),
                  enc=jnp.asarray(i["enc"]))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    single = cases.case_dryrun(None)
    ranks = rank_results(world, "dryrun")
    np.testing.assert_allclose(float(single["loss"]), float(loss),
                               rtol=1e-5)
    check_grad(stacked(ranks, "enc"), single["enc"], "grad_enc")
    check_grad(stacked(ranks, "enc"), grads["enc"], "grad_enc vs JAX")
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["loss"]), float(loss),
                                   rtol=1e-5, err_msg=f"loss rank {r}")
        assert res["moved"] > 0, "the Adam step moved no decoder weight"
        for p, (got, one, want) in enumerate(
                zip(res["grid"], single["grid"], grads["grid"])):
            check_grad(got, one, f"grad_grid[{p}] rank {r}")
            check_grad(got, want, f"grad_grid[{p}] rank {r} vs JAX")
        for name in ("mlp", "splat_mlp"):
            check_grad(res[name], single[name], f"grad_{name} rank {r}")
            check_grad(res[name], grads[name],
                       f"grad_{name} rank {r} vs JAX")


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        parallel.make_mesh()
