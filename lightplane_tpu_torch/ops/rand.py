"""Counter-based Gaussian RNG (counterpart of ``lightplane_tpu/ops/rand.py``).

A stateless int-hash + Box-Muller generator: two integer counters are
avalanched, mixed with the seed, mapped to (0, 1] and turned into one
N(0, 1) sample.  The integer part is bit-exact with the JAX package, whose
int32 ``*`` and ``<<`` wrap and whose ``>>`` is arithmetic.  Here the hash
runs on int64 tensors holding int32 values and wraps back to the int32
range after every operation that can leave it, so no step relies on signed
overflow.  The CUDA kernel (``csrc/renderer_fw.cu``) computes the same hash
in ``uint32_t``.
"""

from __future__ import annotations

import torch

from .const import MIN_BLOCK_SIZE

INT32_PRIME = 105097564
MAX_INT_32_F = 2147483647.0
MAX_UINT_32_F = 4294967295.0
MAX_UINT_32_F_EPS = 3.0
_TWO_PI = 6.28318530718


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Reduce int64 values to the int32 they wrap to (two's complement)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def _hash(x: torch.Tensor) -> torch.Tensor:
    """Int32 avalanche hash on int64 tensors holding int32 values."""
    x = _wrap32(((x >> 16) ^ x) * 0x45D9F3B)
    x = _wrap32(((x >> 16) ^ x) * 0x45D9F3B)
    return (x >> 16) ^ x


def _pair_hash(x, h):
    """Combine hash ``h`` with value ``x`` (int32 semantics, wrapping)."""
    h = h ^ x
    return _wrap32(_wrap32(h << 24) + _wrap32(h * 0x193))


def _hashes(x1, x2, seed):
    """The two mixed int32 hashes (as int64 tensors) behind one sample."""
    x1 = _wrap32(torch.as_tensor(x1).to(torch.int64))
    x2 = _wrap32(torch.as_tensor(x2).to(torch.int64))
    seed = _wrap32(torch.as_tensor(seed, dtype=torch.int64))
    prime = torch.tensor(INT32_PRIME, dtype=torch.int64)
    h1 = _pair_hash(_pair_hash(prime, seed), _hash(x1))
    h2 = _pair_hash(_pair_hash(prime, _wrap32(seed + 1)), _hash(x2))
    return h1, h2


def _unit(h: torch.Tensor) -> torch.Tensor:
    """Map an int32 hash to (0, 1] in float32, in the JAX operation order."""
    f32 = torch.float32
    hf = h.to(f32)
    num = (hf + torch.tensor(MAX_INT_32_F, dtype=f32)) + torch.tensor(
        MAX_UINT_32_F_EPS, dtype=f32
    )
    return num / torch.tensor(MAX_UINT_32_F + MAX_UINT_32_F_EPS, dtype=f32)


def int_to_randn(x1, x2, seed) -> torch.Tensor:
    """Map two integer tensors + a seed to N(0, 1) float32 samples."""
    h1, h2 = _hashes(x1, x2, seed)
    u1, u2 = _unit(h1), _unit(h2)
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


# The JAX package's name for the same generator (the reference's plain
# PyTorch mirror of its kernel's RNG); one function serves both here.
int_to_randn_naive = int_to_randn


def get_sample_randn(num_samples: int, num_rays: int, seed,
                     min_block: int = MIN_BLOCK_SIZE, device=None):
    """Per-(ray, step) noise table ``[num_rays, num_samples]``:
    ``i1 = ray * S + step + 1``, ``i2 = i1 + max(R, min_block) * S``."""
    num_rays_pad = max(num_rays, min_block)
    ray = torch.arange(num_rays, dtype=torch.int64, device=device)
    step = torch.arange(num_samples, dtype=torch.int64, device=device)
    i1 = _wrap32(num_samples * ray[:, None] + step[None] + 1)
    i2 = _wrap32(i1 + num_rays_pad * num_samples)
    return int_to_randn(i1, i2, seed)
