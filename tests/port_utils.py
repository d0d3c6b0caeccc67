"""Bridge between the JAX package's test fixtures and the PyTorch port:
numpy-seeded inputs go to both packages as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

import lightplane_tpu_torch as lp
from lightplane_tpu_torch import convert

from .utils import compare_one

# Both sides are f32 on the CPU: forward outputs agree to f32 rounding.
MAX_ABS_FWD = 1e-4


def to_torch(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def rays_to_torch(rays) -> lp.Rays:
    return lp.Rays(
        directions=to_torch(rays.directions),
        origins=to_torch(rays.origins),
        grid_idx=to_torch(rays.grid_idx, torch.int64),
        near=to_torch(rays.near),
        far=to_torch(rays.far),
        encoding=None if rays.encoding is None else to_torch(rays.encoding),
    )


def decoder_to_torch(dp) -> lp.DecoderParams:
    return convert.decoder_params_from_numpy(
        np.asarray(dp.mlp_params), dp.n_hidden_trunk, dp.n_hidden_opacity,
        dp.n_hidden_color, dp.color_chn,
    )


def grid_to_torch(grid):
    return convert.grid_list_from_numpy([np.asarray(g) for g in grid])


def compare_outputs(out_jax, out_torch, names=("depth", "nlt", "feat"),
                    magnitude_scaled=False, max_abs=MAX_ABS_FWD):
    """``compare_one`` at its defaults plus ``max |diff| <= max_abs`` on each
    output (both scaled by magnitude when ``magnitude_scaled``)."""
    for name, a, b in zip(names, out_jax, out_torch):
        a = np.asarray(a, dtype=np.float64)
        b = b.detach().double().numpy()
        compare_one(a, b, name, magnitude_scaled=magnitude_scaled)
        scale = max(1.0, float(np.abs(a).max())) if magnitude_scaled else 1.0
        err = float(np.abs(a - b).max()) if a.size else 0.0
        assert err <= max_abs * scale, (
            f"{name}: max abs diff {err:.2e} > {max_abs}*{scale:.1e}"
        )
