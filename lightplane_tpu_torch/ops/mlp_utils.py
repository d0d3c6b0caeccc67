"""Decoder and splatter MLP parameter packing (counterpart of
``lightplane_tpu/ops/mlp_utils.py``).

The renderer's trunk / opacity / color MLPs live in one flat 1-D
``mlp_params`` vector plus per-MLP layer-width tuples ``n_hidden_*``; the
splatter's single MLP in a flat vector plus ``n_hidden``.  The layout is
identical to the JAX package's, so one array feeds both::

    [W_0.flatten(), ..., W_{L-1}.flatten(), b_0, ..., b_{L-1}]   per MLP
    trunk, then opacity, then color (the decoder)

with right-multiplying weights (``out = in @ W + b``, ``W`` is
``[d_in, d_out]`` row-major).  The color MLP's last layer is zero-padded up
to ``MIN_BLOCK_SIZE`` outputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .const import MIN_BLOCK_SIZE

NHidden = Tuple[int, ...]


def _as_static_n_hidden(n_hidden) -> NHidden:
    """Accept tuples/lists/arrays and normalize to a tuple of ints."""
    if n_hidden is None:
        return ()
    if hasattr(n_hidden, "tolist"):
        n_hidden = np.asarray(n_hidden).tolist()
    return tuple(int(x) for x in n_hidden)


@dataclasses.dataclass
class DecoderParams:
    """Learnable parameters of the renderer decoder.

    ``mlp_params`` is the flat parameter vector; ``n_hidden_trunk`` /
    ``n_hidden_opacity`` / ``n_hidden_color`` are ``(c_in, h_1, ..., c_out)``
    per MLP (empty = no trunk MLP), and ``color_chn`` is the number of
    rendered channels (the color MLP output may be zero-padded up to
    ``MIN_BLOCK_SIZE``).
    """

    mlp_params: torch.Tensor
    n_hidden_trunk: NHidden
    n_hidden_opacity: NHidden
    n_hidden_color: NHidden
    color_chn: int

    def __post_init__(self):
        self.n_hidden_trunk = _as_static_n_hidden(self.n_hidden_trunk)
        self.n_hidden_opacity = _as_static_n_hidden(self.n_hidden_opacity)
        self.n_hidden_color = _as_static_n_hidden(self.n_hidden_color)


@dataclasses.dataclass
class SplatterParams:
    """Learnable parameters of the splatter MLP, which maps
    ``input_grid[x] + rays.encoding`` to the vector splatted at ``x``:
    the flat ``mlp_params`` vector and ``n_hidden = (c_in, h_1, ...,
    c_out)``."""

    mlp_params: torch.Tensor
    n_hidden: NHidden

    def __post_init__(self):
        self.n_hidden = _as_static_n_hidden(self.n_hidden)


def _xavier_init_mlp_params(
    generator: Optional[torch.Generator],
    n_layers: int,
    input_chn: int,
    hidden_chn: int,
    output_chn: int,
    last_bias: float = 0.0,
    device="cuda",
):
    """Xavier-uniform weights (relu gain), zero biases except the last;
    drawn on the CPU from ``generator``, then moved to ``device``."""
    weights, biases = [], []
    gain = math.sqrt(2.0)
    for l in range(n_layers):
        d_in = input_chn if l == 0 else hidden_chn
        d_out = output_chn if l == n_layers - 1 else hidden_chn
        bound = gain * math.sqrt(6.0 / (d_in + d_out))
        u = torch.rand((d_in, d_out), generator=generator)
        weights.append(((2.0 * u - 1.0) * bound).to(device))
        fill = last_bias if l == n_layers - 1 else 0.0
        biases.append(torch.full((d_out,), fill, device=device))
    return weights, biases


def init_decoder_params(
    generator: Optional[torch.Generator],
    n_layers_opacity: int,
    n_layers_trunk: int,
    n_layers_color: int,
    input_chn: int = 32,
    hidden_chn: int = 32,
    color_chn: int = 3,
    opacity_init_bias: float = 0.0,
    pad_color_channels_to_min_block_size: bool = True,
    use_separate_color_grid: bool = False,
    device="cuda",
) -> DecoderParams:
    """Initialize the renderer decoder MLPs from an explicit generator, on
    ``device`` (the GPU unless the caller asks for ``"cpu"``).

    The layer shapes and the flat layout match
    ``lightplane_tpu.init_decoder_params``; the random values do not (the
    two frameworks' generators differ).
    """
    if n_layers_trunk > 0:
        if use_separate_color_grid:
            raise ValueError(
                "Cannot use trunk MLP with a separate color grid."
                " Please set n_layers_trunk==0."
            )
        weights_trunk, biases_trunk = _xavier_init_mlp_params(
            generator, n_layers_trunk, input_chn, hidden_chn, hidden_chn,
            device=device,
        )
    else:
        weights_trunk, biases_trunk = [], []
    head_in = input_chn if use_separate_color_grid else hidden_chn
    weights_opacity, biases_opacity = _xavier_init_mlp_params(
        generator, n_layers_opacity, head_in, hidden_chn, 1,
        last_bias=opacity_init_bias, device=device,
    )
    weights_color, biases_color = _xavier_init_mlp_params(
        generator, n_layers_color, head_in, hidden_chn, color_chn,
        device=device,
    )
    mlp_params, n_hidden_trunk, n_hidden_opacity, n_hidden_color = (
        flatten_decoder_params(
            weights_trunk, biases_trunk,
            weights_opacity, biases_opacity,
            weights_color, biases_color,
            pad_color_channels_to_min_block_size,
        )
    )
    return DecoderParams(
        mlp_params, n_hidden_trunk, n_hidden_opacity, n_hidden_color, color_chn
    )


def init_splatter_params(
    generator: Optional[torch.Generator],
    n_layers: int,
    input_chn: int = 32,
    hidden_chn: int = 32,
    out_chn: int = 16,
    device="cuda",
) -> SplatterParams:
    """Initialize the splatter MLP from an explicit generator, on
    ``device`` (the GPU unless the caller asks for ``"cpu"``).  The shapes
    and the flat layout match ``lightplane_tpu.init_splatter_params``; the
    random values do not."""
    weights, biases = _xavier_init_mlp_params(
        generator, n_layers, input_chn, hidden_chn, out_chn, device=device
    )
    mlp_params, n_hidden = flatten_splatter_params(weights, biases)
    return SplatterParams(mlp_params, n_hidden)


def _pad_color_mlp_params(weights, biases, n_pad):
    weights = list(weights)
    biases = list(biases)
    weights[-1] = torch.nn.functional.pad(weights[-1], (0, n_pad))
    biases[-1] = torch.nn.functional.pad(biases[-1], (0, n_pad))
    return weights, biases


def _get_n_hidden(weights) -> NHidden:
    if len(weights) == 0:
        return ()
    return tuple(
        [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
    )


def flatten_decoder_params(
    weights_trunk,
    biases_trunk,
    weights_opacity,
    biases_opacity,
    weights_color,
    biases_color,
    pad_color_channels_to_min_block_size: bool = True,
):
    """Flatten the three decoder MLPs into one 1-D vector + shape tuples."""
    if pad_color_channels_to_min_block_size:
        color_chn = int(biases_color[-1].numel())
        n_pad = max(MIN_BLOCK_SIZE - color_chn, 0)
        if n_pad > 0:
            weights_color, biases_color = _pad_color_mlp_params(
                weights_color, biases_color, n_pad
            )
    mlp_params = torch.cat(
        [
            t.reshape(-1)
            for group in [
                weights_trunk, biases_trunk,
                weights_opacity, biases_opacity,
                weights_color, biases_color,
            ]
            for t in group
        ],
        dim=0,
    )
    return (
        mlp_params,
        _get_n_hidden(weights_trunk),
        _get_n_hidden(weights_opacity),
        _get_n_hidden(weights_color),
    )


def flatten_splatter_params(weights, biases):
    """Flatten the splatter MLP: all weights, then all biases; returns
    ``(mlp_params, n_hidden)``."""
    mlp_params = torch.cat(
        [t.reshape(-1) for group in (weights, biases) for t in group], dim=0
    )
    return mlp_params, _get_n_hidden(weights)


def _mlp_numel(n_hidden: NHidden) -> int:
    n_hidden = _as_static_n_hidden(n_hidden)
    if len(n_hidden) == 0:
        return 0
    w = sum(a * b for a, b in zip(n_hidden[:-1], n_hidden[1:]))
    return w + sum(n_hidden[1:])


def _flattened_one_mlp_params_to_list(mlp_params, n_hidden, transpose=False):
    """Slice one MLP's weights/biases out of its flat segment."""
    n_hidden = _as_static_n_hidden(n_hidden)
    nl = len(n_hidden) - 1
    if nl < 1:
        return [], []
    weights, biases = [], []
    off = 0
    for l in range(nl):
        d_in, d_out = n_hidden[l], n_hidden[l + 1]
        weights.append(
            mlp_params[off: off + d_in * d_out].reshape(d_in, d_out)
        )
        off += d_in * d_out
    for l in range(nl):
        d_out = n_hidden[l + 1]
        biases.append(mlp_params[off: off + d_out])
        off += d_out
    if transpose:
        weights = [w.T for w in weights]
    return weights, biases


def flattened_decoder_params_to_list(
    mlp_params: torch.Tensor,
    n_hidden_trunk,
    n_hidden_opacity,
    n_hidden_color,
    transpose: bool = False,
):
    """Inverse of :func:`flatten_decoder_params`: returns
    ``(w_trunk, b_trunk, w_opacity, b_opacity, w_color, b_color)``."""
    numel_trunk = _mlp_numel(n_hidden_trunk)
    numel_opacity = _mlp_numel(n_hidden_opacity)
    weights_trunk, biases_trunk = _flattened_one_mlp_params_to_list(
        mlp_params[:numel_trunk], n_hidden_trunk, transpose
    )
    weights_opacity, biases_opacity = _flattened_one_mlp_params_to_list(
        mlp_params[numel_trunk: numel_trunk + numel_opacity],
        n_hidden_opacity,
        transpose,
    )
    weights_color, biases_color = _flattened_one_mlp_params_to_list(
        mlp_params[numel_trunk + numel_opacity:], n_hidden_color, transpose
    )
    return (
        weights_trunk, biases_trunk,
        weights_opacity, biases_opacity,
        weights_color, biases_color,
    )


def flattened_triton_decoder_to_list(
    mlp_params: torch.Tensor,
    n_layers_trunk: int,
    n_layers_opacity: int,
    n_layers_color: int,
    input_chn: int,
    hidden_chn: int,
    color_chn: int,
):
    """:func:`flattened_decoder_params_to_list` of MLPs given by their layer
    counts and widths (trunk ``input_chn -> hidden_chn``, opacity head
    ``hidden_chn -> 1``, colour head ``hidden_chn -> color_chn``)."""

    def _make(d_in, d_hidden, d_out, n_layers):
        if n_layers == 0:
            return ()
        return tuple([d_in] + [d_hidden] * (n_layers - 1) + [d_out])

    return flattened_decoder_params_to_list(
        mlp_params,
        _make(input_chn, hidden_chn, hidden_chn, n_layers_trunk),
        _make(hidden_chn, hidden_chn, 1, n_layers_opacity),
        _make(hidden_chn, hidden_chn, color_chn, n_layers_color),
    )


def get_triton_function_input_dims(
    n_hidden_trunk,
    n_hidden_opacity,
    n_hidden_color,
):
    """The hidden widths, layer counts and render channels of the three
    MLPs: ``(dim_hidden_trunk, dim_hidden_opacity, dim_hidden_color,
    n_layers_trunk, n_layers_opacity, n_layers_color,
    num_render_channels)``."""
    n_hidden_trunk = _as_static_n_hidden(n_hidden_trunk)
    n_hidden_opacity = _as_static_n_hidden(n_hidden_opacity)
    n_hidden_color = _as_static_n_hidden(n_hidden_color)
    if len(n_hidden_trunk) == 0:
        mlp_n_layers_trunk = 0
        mlp_dim_hidden_trunk = 0
    else:
        mlp_dim_hidden_trunk = n_hidden_trunk[1]
        assert all(h == mlp_dim_hidden_trunk for h in n_hidden_trunk[1:])
        mlp_n_layers_trunk = len(n_hidden_trunk) - 1
    mlp_dim_hidden_opacity = n_hidden_opacity[1]
    mlp_dim_hidden_color = n_hidden_color[1]
    if len(n_hidden_opacity) > 3:
        assert all(h == mlp_dim_hidden_opacity
                   for h in n_hidden_opacity[1:-1])
    if len(n_hidden_color) > 3:
        assert all(h == mlp_dim_hidden_color for h in n_hidden_color[1:-1])
    return (
        mlp_dim_hidden_trunk,
        mlp_dim_hidden_opacity,
        mlp_dim_hidden_color,
        mlp_n_layers_trunk,
        len(n_hidden_opacity) - 1,
        len(n_hidden_color) - 1,
        n_hidden_color[-1],
    )
