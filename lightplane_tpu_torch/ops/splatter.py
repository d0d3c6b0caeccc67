"""Fused Lightplane splatter, the 2D -> 3D operator (counterpart of
``lightplane_tpu/ops/splatter.py``).

The splat is a ``torch.autograd.Function`` (:class:`_SplatCore`, the port of
the JAX ``_splat_core`` custom VJP).  Its forward marches every ray and adds
each step's splat vector, with a unit "collision" weight beside it, into the
flat output grid-list: the hand-written CUDA kernel ``csrc/splatter_fw.cu``
for CUDA tensors, its plain PyTorch version for CPU tensors.  It returns the
raw accumulators ``(feat [V, C], w [V, 1])``.  Its backward is the adjoint
of the splat, a gather of the incoming gradient along the same march (with
the MLP: recompute, MLP backward and a splat into the input grid), in
``csrc/splatter_bw.cu`` or its plain version.  Only the inputs are saved
between the passes: memory is O(1) in the number of samples.

The output is ``feat / clamp(w, 1e-5)`` under ordinary autograd.  ``w`` is
marked non-differentiable: as in the JAX package, no gradient flows through
the weight grid, whose unit collision features depend on no input.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from torch.autograd.function import once_differentiable

from . import guards
from .grid_sample import sample_grid_rep
from .misc_utils import (
    check_grid_and_color_grid,
    process_and_flatten_grid,
    unflatten_grid,
)
from .mlp_utils import SplatterParams, _flattened_one_mlp_params_to_list
from .naive_splatter import WEIGHT_GRID_EPS, _normalize_output_grid_size
from .rays import Rays
from .renderer import (
    _chunk_depth_delta,
    _chunk_steps,
    _per_ray,
    _step_depth_delta,
    _step_points,
)


@dataclasses.dataclass(frozen=True)
class _SplatCfg:
    """Static splat configuration."""

    num_samples: int
    num_samples_inf: int
    mask_out_of_bounds_samples: bool
    contract_coords: bool
    disparity_at_inf: float
    output_grid_sizes: tuple       # ((B, D, H, W, C), ...)
    input_grid_sizes: Optional[tuple]
    n_hidden: tuple                # () without an MLP

    @property
    def tot_num_samples(self):
        return self.num_samples + self.num_samples_inf

    @property
    def v_total(self):
        return sum(int(np.prod(gs[:-1])) for gs in self.output_grid_sizes)

    @property
    def out_chn(self):
        return int(self.output_grid_sizes[0][-1])


def _relu(k: int, x):
    return torch.relu(x)


def _step_fused_feature(cfg: _SplatCfg, pts, encoding, input_grid_flat,
                        mlp_params, grid_idx, relu=_relu):
    """The splat vector of one step: the ray's encoding, or with an MLP
    ``MLP(input_grid[pts] + encoding)`` (relu after every layer but the
    last).  ``relu(k, x)`` computes the output of hidden layer k
    (``torch.relu`` by default; the adjoint's relu-mask replay,
    ``kernels/splatter_bw.py``, passes its own).  For a chunk of K steps
    (``pts`` [R, K, 3]) the vectors of each: [R, K, C]."""
    if len(cfg.n_hidden) == 0:
        return _per_ray(encoding, pts).expand(
            pts.shape[:-1] + encoding.shape[-1:])
    weights, biases = _flattened_one_mlp_params_to_list(mlp_params,
                                                        cfg.n_hidden)
    x = sample_grid_rep(
        input_grid_flat, cfg.input_grid_sizes, pts, grid_idx,
        cfg.mask_out_of_bounds_samples,
    ) + _per_ray(encoding, pts)
    for l in range(len(weights)):
        x = x @ weights[l] + biases[l]
        if l < len(weights) - 1:
            x = relu(l, x)
    return x


def _march_points(cfg: _SplatCfg, geom, s: int):
    """The (contracted) sample point of every ray at step ``s``."""
    directions, origins, near, far = geom[:4]
    t, _ = _step_depth_delta(cfg, near, far, s)
    return _step_points(cfg, origins, directions, t)


def _chunk_points(cfg: _SplatCfg, geom, steps):
    """The (contracted) sample points of every ray at each of ``steps``:
    [R, K, 3]."""
    directions, origins, near, far = geom[:4]
    t, _ = _chunk_depth_delta(cfg, near, far, steps)
    return _step_points(cfg, origins, directions, t)


def _splat_chunks(cfg: _SplatCfg, geom, diff):
    """The plain splat's and adjoint's chunks of steps
    (``renderer._chunk_steps``), by the widest of the output's channels
    (and its weight), the input grid's and the MLP's layers."""
    encoding, input_grid_flat = diff[:2]
    widths = [cfg.out_chn + 1, encoding.shape[-1], *cfg.n_hidden]
    if input_grid_flat is not None:
        widths.append(input_grid_flat.shape[-1])
    return _chunk_steps(range(cfg.tot_num_samples), geom[0].shape[0],
                        max(widths), geom[0].is_cuda)


class _SplatCore(torch.autograd.Function):
    """The splat with its gather backward.

    ``apply(cfg, impl, directions, origins, near, far, grid_idx, encoding,
    input_grid_flat, mlp_params)`` returns the raw accumulators ``(feat [V,
    C], w [V, 1])``.  ``w`` gets no gradient and the ray geometry none, as
    in the JAX package.
    """

    @staticmethod
    def forward(ctx, cfg, impl, directions, origins, near, far, grid_idx,
                encoding, input_grid_flat, mlp_params):
        from .kernels.splatter_fw import splat_fwd

        geom = (directions, origins, near, far, grid_idx)
        diff = (encoding, input_grid_flat, mlp_params)
        feat, w = splat_fwd(cfg, geom, diff, impl)
        ctx.mark_non_differentiable(w)
        ctx.cfg, ctx.impl = cfg, impl
        ctx.save_for_backward(*geom, *diff)
        return feat, w

    @staticmethod
    @once_differentiable
    def backward(ctx, g_feat, g_w):
        from .kernels.splatter_bw import splat_bwd

        del g_w  # the weight grid carries no gradient
        saved = ctx.saved_tensors
        geom, diff = saved[:5], saved[5:]
        grads = splat_bwd(ctx.cfg, geom, diff, g_feat.contiguous(), ctx.impl)
        label = "splatter(cuda)" if geom[0].is_cuda else "splatter(torch)"
        guards.assert_grads_finite(grads, label)
        return (None,) * 7 + tuple(grads)


def _run_splatter(
    rays: Rays,
    output_grid_size,
    mlp_params: Optional[SplatterParams],
    input_grid,
    num_samples: int,
    num_samples_inf: int,
    mask_out_of_bounds_samples: bool,
    contract_coords: bool,
    disparity_at_inf: float,
    input_grid_sizes,
    return_list: bool,
    raw: bool = False,
    impl: str = "auto",
):
    if rays.encoding is None:
        raise ValueError("The splatter requires rays.encoding to be set.")
    output_grid_size = _normalize_output_grid_size(output_grid_size)

    out_chns = {int(gs[-1]) for gs in output_grid_size}
    if len(out_chns) != 1:
        raise ValueError(
            "every output grid must have the same channel count; got "
            f"{sorted(out_chns)}"
        )
    batches = {int(gs[0]) for gs in output_grid_size}
    if len(batches) != 1:
        raise ValueError(
            "every output grid must share one batch size (rays.grid_idx "
            f"indexes the batch of EVERY sub-grid); got {sorted(batches)}"
        )
    out_chn = next(iter(out_chns))
    enc_chn = int(rays.encoding.shape[-1])
    if mlp_params is None:
        if enc_chn != out_chn:
            raise ValueError(
                f"rays.encoding has {enc_chn} channels but the output "
                f"grid-list has {out_chn}; without an MLP the encoding is "
                "splatted directly and the channel counts must match."
            )
    else:
        n_hidden = tuple(int(n) for n in mlp_params.n_hidden)
        if int(n_hidden[-1]) != out_chn:
            raise ValueError(
                f"the splatter MLP outputs {n_hidden[-1]} channels but the "
                f"output grid-list has {out_chn}."
            )
        if enc_chn != int(n_hidden[0]):
            raise ValueError(
                f"rays.encoding has {enc_chn} channels but the splatter "
                f"MLP expects {n_hidden[0]} inputs (the encoding is added "
                "to the sampled input-grid feature before the MLP)."
            )

    if mlp_params is not None and input_grid is None:
        raise ValueError("the splatter MLP needs an input_grid")
    if input_grid is not None:
        check_grid_and_color_grid(input_grid, None, input_grid_sizes, None)
        input_grid_flat, _, input_grid_sizes, _ = process_and_flatten_grid(
            input_grid, None, input_grid_sizes, None
        )
    else:
        input_grid_flat, input_grid_sizes = None, None

    if mlp_params is not None and input_grid_sizes is not None:
        in_chns = {int(gs[-1]) for gs in input_grid_sizes}
        want = int(tuple(mlp_params.n_hidden)[0])
        if in_chns != {want}:
            raise ValueError(
                f"input_grid channel counts {sorted(in_chns)} do not match "
                f"the splatter MLP input width {want}."
            )

    with_mlp = mlp_params is not None
    cfg = _SplatCfg(
        num_samples=int(num_samples),
        num_samples_inf=int(num_samples_inf),
        mask_out_of_bounds_samples=bool(mask_out_of_bounds_samples),
        contract_coords=bool(contract_coords),
        disparity_at_inf=float(disparity_at_inf),
        output_grid_sizes=output_grid_size,
        input_grid_sizes=input_grid_sizes if with_mlp else None,
        n_hidden=mlp_params.n_hidden if with_mlp else (),
    )
    feat_grid, w_grid = _SplatCore.apply(
        cfg, impl, *(t.contiguous() for t in (rays.directions, rays.origins,
                                              rays.near, rays.far)),
        rays.grid_idx.to(torch.int32).contiguous(), rays.encoding.contiguous(),
        input_grid_flat.contiguous() if with_mlp else None,
        mlp_params.mlp_params if with_mlp else None,
    )
    if raw:
        return feat_grid, w_grid
    grid_flat = feat_grid / torch.clamp(w_grid, min=WEIGHT_GRID_EPS)
    if return_list:
        return list(unflatten_grid(grid_flat, output_grid_size))
    return grid_flat


def lightplane_splatter_raw(
    rays: Rays,
    output_grid_size,
    mlp_params: Optional[SplatterParams] = None,
    input_grid=None,
    *,
    num_samples: int,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    input_grid_sizes=None,
    impl: str = "auto",
):
    """Un-normalized splat: the flat accumulators ``(feature_grid [V, C],
    weight_grid [V, 1])``, linear in the ray set (so shards of the rays can
    be summed before normalizing)."""
    return _run_splatter(
        rays, output_grid_size, mlp_params, input_grid, num_samples,
        num_samples_inf, mask_out_of_bounds_samples, contract_coords,
        disparity_at_inf, input_grid_sizes, return_list=False, raw=True,
        impl=impl,
    )


def lightplane_splatter(
    rays: Rays,
    output_grid_size,
    num_samples: int,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    return_list: bool = True,
    impl: str = "auto",
):
    """Fused splatter: pushes ``rays.encoding`` along each ray into a
    zero-initialized grid-list of ``output_grid_size``, normalized by the
    splat-weight grid; differentiable with respect to ``rays.encoding``.

    Same arguments and numerics as ``lightplane_tpu.lightplane_splatter``.
    ``impl``: ``"auto"`` runs the CUDA kernels (forward and backward) for
    CUDA tensors and the plain PyTorch marches for CPU tensors; ``"cuda"``
    demands the kernels and raises for CPU tensors; ``"torch"`` runs the
    plain marches on any device.

    Returns the splatted grid-list, or the flat ``[V_total, C]`` tensor with
    ``return_list=False``.
    """
    return _run_splatter(
        rays, output_grid_size, None, None, num_samples, num_samples_inf,
        mask_out_of_bounds_samples, contract_coords, disparity_at_inf, None,
        return_list, impl=impl,
    )


def lightplane_mlp_splatter(
    rays: Rays,
    output_grid_size,
    mlp_params: SplatterParams,
    input_grid: Union[Sequence[torch.Tensor], torch.Tensor],
    num_samples: int,
    num_samples_inf: int = 0,
    mask_out_of_bounds_samples: bool = False,
    contract_coords: bool = False,
    disparity_at_inf: float = 1e-5,
    input_grid_sizes=None,
    return_list: bool = True,
    impl: str = "auto",
):
    """Fused splatter with a prior ``input_grid``: each sample gathers the
    prior feature, adds the ray's ``encoding``, maps the sum through the
    splatter MLP and splats the result.  Differentiable with respect to
    ``rays.encoding``, ``input_grid`` and ``mlp_params.mlp_params``;
    ``impl`` as in :func:`lightplane_splatter`.
    """
    return _run_splatter(
        rays, output_grid_size, mlp_params, input_grid, num_samples,
        num_samples_inf, mask_out_of_bounds_samples, contract_coords,
        disparity_at_inf, input_grid_sizes, return_list, impl=impl,
    )
