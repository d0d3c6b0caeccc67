"""Data parallelism over rays on ``torch.distributed`` (counterpart of
``lightplane_tpu/parallel/sharding.py``).

One process per card, as ``torchrun`` launches them: each rank holds a
contiguous slice of the ray batch and a replica of the grid-lists and MLP
parameters.  The JAX package maps the same semantics over a device mesh
with ``shard_map``; here a *mesh* is this process's view of the ray axis
(:func:`make_mesh`).  The loss is the sum of the ranks' losses:

- the renderer's outputs stay per rank, and the gradients of the replicated
  grid-lists and ``mlp_params`` are all-reduced (SUM) in the backward, the
  transpose of the JAX package's ``pcast(..., to='varying')``;
- the splatter all-reduces its raw ``(feature, weight)`` accumulators and
  normalises after the sum, so every rank holds the single-process grid; the
  gradient reaching that sum goes back to each rank's partial unchanged (the
  transpose of a ``psum`` with a replicated output), and the gradients of the
  splatter MLP and its input grid are all-reduced once, on the way in.

So every gradient path crosses exactly one all-reduce: in a lift-then-render
step the grid's gradient is summed by the renderer and passed through the
splat's sum untouched.  Only ``all_reduce`` is used, which gloo supports for
CPU and CUDA tensors and NCCL for CUDA tensors; NCCL runs it on its own
stream after the current one, with no host synchronisation.

Typical use, one process per card under ``torchrun``::

    torch.distributed.init_process_group("nccl")
    mesh = make_mesh()
    render = data_parallel_renderer(mesh, num_samples=..., gain=1.0)
    depth, nlt, feat = render(shard_rays(rays, mesh), grid, decoder_params)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.misc_utils import unflatten_grid
from ..ops.naive_splatter import WEIGHT_GRID_EPS, _normalize_output_grid_size
from ..ops.rays import Rays
from ..ops.renderer import lightplane_renderer
from ..ops.splatter import lightplane_splatter_raw

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the ray axis: its process group, its rank
    and the group's size, the device its shard lives on, and the axis's
    name."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_name: str = RAY_AXIS


def make_mesh(devices: Optional[Sequence] = None,
              axis_name: str = RAY_AXIS) -> Mesh:
    """The ray axis over the ranks of the default process group, which
    ``torch.distributed.init_process_group`` must have set up.

    ``devices``, if given, lists a device for every rank (``["cpu", "cpu"]``
    for a world of two on the CPU); otherwise rank r uses
    ``cuda:{LOCAL_RANK}``, or ``cuda:{r % device_count}`` outside
    ``torchrun``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "make_mesh needs a process group: call "
            "torch.distributed.init_process_group first (one process per "
            "device, e.g. under torchrun)"
        )
    rank, size = dist.get_rank(), dist.get_world_size()
    if devices is None:
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else rank % max(torch.cuda.device_count(), 1))
        device = torch.device("cuda", index)
    else:
        if len(devices) != size:
            raise ValueError(
                f"devices lists {len(devices)} devices for a world of {size}"
            )
        device = torch.device(devices[rank])
    return Mesh(dist.group.WORLD, rank, size, device, axis_name)


def _check_axis(mesh: Mesh, axis_name: str):
    if axis_name != mesh.axis_name:
        raise ValueError(
            f"axis {axis_name!r} is not the mesh's axis {mesh.axis_name!r}"
        )


def shard_rays(rays: Rays, mesh: Mesh, axis_name: str = RAY_AXIS) -> Rays:
    """This rank's contiguous slice of a global ray batch, on
    ``mesh.device``: rows ``[r * n / size, (r + 1) * n / size)`` of rank
    r, the rows it holds under the JAX package's ``NamedSharding``."""
    _check_axis(mesh, axis_name)
    n = len(rays)
    if n % mesh.size:
        raise ValueError(
            f"{n} rays do not split evenly over {mesh.size} ranks; pad them "
            "first with pad_rays_to_devices"
        )
    per = n // mesh.size
    return rays[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def pad_rays_to_devices(rays: Rays, n_devices: int):
    """Pad the ray batch with zero rays so it divides evenly across
    devices; returns ``(rays, n_pad)``."""
    return rays.pad_to_block_size(n_devices)


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward all-reduces each gradient (SUM) over
    the group: how a replicated parameter enters a rank's computation."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, needed in zip(grads, ctx.needs_input_grad[1:]):
            if not needed:
                out.append(None)
                continue
            # a private contiguous copy: the incoming tensor may be shared
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
            out.append(g)
        return (None, *out)


class _SumForward(torch.autograd.Function):
    """The splat's raw accumulators summed over the group in place (SUM);
    the gradient passes through unchanged and the weights take none."""

    @staticmethod
    def forward(ctx, group, feat, w):
        for x in (feat, w):
            buf = x if x.is_contiguous() else x.contiguous()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            if buf is not x:
                x.copy_(buf)
        ctx.mark_dirty(feat, w)
        ctx.mark_non_differentiable(w)
        return feat, w

    @staticmethod
    def backward(ctx, g_feat, g_w):
        return None, g_feat, None


def _replicated(mesh: Mesh, x):
    """``x`` (a tensor, a sequence of them, or None) entering this rank's
    computation as a replica whose gradient is summed over the ranks."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return _SumGradients.apply(mesh.group, x)[0]
    return list(_SumGradients.apply(mesh.group, *x))


def data_parallel_renderer(mesh: Mesh, axis_name: str = RAY_AXIS,
                           **defaults):
    """A data-parallel :func:`lightplane_renderer`.

    The returned ``render(rays, grid, decoder_params, **kwargs)`` takes this
    rank's shard of the rays (:func:`shard_rays`) and the replicated
    grid-list, ``color_grid`` and decoder; ``kwargs`` override
    ``defaults``.  Its outputs are this rank's rows.  Under autograd the
    gradients of the grid-list, the colour grid and ``mlp_params`` are
    summed over the ranks; those of ``rays.encoding`` stay per rank.
    ``image_size`` and ``tile_rays`` reach each rank's call as given."""
    _check_axis(mesh, axis_name)

    def render(rays: Rays, grid, decoder_params, **kwargs):
        kw = dict(defaults)
        kw.update(kwargs)
        color_grid = kw.pop("color_grid", None)
        local = dataclasses.replace(rays,
                                    grid_idx=rays.grid_idx.to(torch.int32))
        dp = dataclasses.replace(
            decoder_params,
            mlp_params=_replicated(mesh, decoder_params.mlp_params))
        return lightplane_renderer(
            local, _replicated(mesh, grid), dp,
            color_grid=_replicated(mesh, color_grid), **kw)

    return render


def data_parallel_splatter(mesh: Mesh, axis_name: str = RAY_AXIS,
                           use_mlp: bool = False,
                           check_vma: Optional[bool] = None,
                           **defaults):
    """A data-parallel splatter: each rank splats its shard of the rays, the
    raw ``(feature, weight)`` accumulators are summed over the ranks before
    the normalising quotient, and every rank returns the single-process
    grid.

    The returned ``splat(rays, output_grid_size, mlp_params=None,
    input_grid=None, return_list=True, **kwargs)`` takes this rank's shard
    of the rays; with ``use_mlp`` the splatter MLP ``mlp_params`` and its
    ``input_grid`` are replicas whose gradients are summed over the ranks.
    ``kwargs`` override ``defaults``.  ``check_vma`` switches the JAX
    package's ``shard_map`` checker; it is accepted and ignored."""
    del check_vma
    _check_axis(mesh, axis_name)

    def splat(rays: Rays, output_grid_size, mlp_params=None,
              input_grid=None, return_list: bool = True, **kwargs):
        kw = dict(defaults)
        kw.update(kwargs)
        local = dataclasses.replace(rays,
                                    grid_idx=rays.grid_idx.to(torch.int32))
        mp = (dataclasses.replace(
                  mlp_params,
                  mlp_params=_replicated(mesh, mlp_params.mlp_params))
              if use_mlp else None)
        feat, w = lightplane_splatter_raw(
            local, output_grid_size, mp, _replicated(mesh, input_grid), **kw)
        feat, w = _SumForward.apply(mesh.group, feat, w)
        grid_flat = feat / torch.clamp(w, min=WEIGHT_GRID_EPS)
        if return_list:
            return list(unflatten_grid(
                grid_flat, _normalize_output_grid_size(output_grid_size)))
        return grid_flat

    return splat
