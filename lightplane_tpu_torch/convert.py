"""Carry weights and grids from numpy arrays (for example the JAX package's
``jax.device_get`` output) into the port's objects, on ``device`` (the GPU
unless the caller asks for ``"cpu"``)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .ops.mlp_utils import DecoderParams, SplatterParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def decoder_params_from_numpy(
    mlp_params,
    n_hidden_trunk,
    n_hidden_opacity,
    n_hidden_color,
    color_chn: int,
    device="cuda",
) -> DecoderParams:
    """A :class:`DecoderParams` holding the flat vector ``mlp_params``
    (same layout in both packages)."""
    return DecoderParams(
        _tensor(mlp_params, device), n_hidden_trunk, n_hidden_opacity,
        n_hidden_color, int(color_chn),
    )


def renderer_module_state_from_flax(
    variables, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Map the Flax ``LightplaneRenderer`` variables
    ``{"params": {"mlp_params", "harmonic_ray_embedding_linear": {"kernel"
    [in, E], "bias" [E]}}}`` to a ``state_dict`` of the port's
    ``LightplaneRenderer`` (``nn.Linear.weight`` is the transposed kernel)."""
    params = variables["params"]
    state = {"mlp_params": _tensor(params["mlp_params"], device)}
    dense = params.get("harmonic_ray_embedding_linear")
    if dense is not None:
        state["harmonic_ray_embedding_linear.weight"] = _tensor(
            np.asarray(dense["kernel"]).T, device
        )
        state["harmonic_ray_embedding_linear.bias"] = _tensor(
            dense["bias"], device
        )
    return state


def splatter_params_from_numpy(
    mlp_params, n_hidden, device="cuda"
) -> SplatterParams:
    """A :class:`SplatterParams` holding the flat vector ``mlp_params``
    (same layout in both packages)."""
    return SplatterParams(_tensor(mlp_params, device), n_hidden)


def mlp_splatter_module_state_from_flax(
    variables, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Map the Flax ``LightplaneMLPSplatter`` variables ``{"params":
    {"mlp_params"}}`` to a ``state_dict`` of the port's
    ``LightplaneMLPSplatter``."""
    return {"mlp_params": _tensor(variables["params"]["mlp_params"], device)}


def grid_list_from_numpy(
    arrays: Sequence[np.ndarray], device="cuda"
) -> List[torch.Tensor]:
    """A grid-list of ``[B, D, H, W, C]`` float32 tensors."""
    return [_tensor(a, device) for a in arrays]
