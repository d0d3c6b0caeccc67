"""Debug-gated guards (counterpart of ``lightplane_tpu/ops/guards.py``).

Each check reads a value back from the device and so synchronises the host
with it; each is opt-in and does nothing with its flag unset.

- ``LIGHTPLANE_CHECK_GRADS=1``: the reference asserts every gradient is
  finite after each backward pass (``lightplane_renderer.py:719-722``);
  every fused-operator backward then counts the non-finite values of the
  gradients it produced and raises ``FloatingPointError`` if there are any.
- ``LIGHTPLANE_CHECK_GRID_IDX=1``: every launch of the march and splat
  kernels checks that each ray's ``grid_idx`` lies in ``[0, batches)`` and
  raises ``ValueError`` if not.  Without it the kernels keep memory safe on
  their own: a ray whose index lies outside samples and splats nothing
  (``csrc/march_common.cuh::load_ray``).
"""

from __future__ import annotations

import os

import torch


def _flag(name: str) -> bool:
    return os.environ.get(name, "0") not in ("", "0")


def check_grads_enabled() -> bool:
    return _flag("LIGHTPLANE_CHECK_GRADS")


def check_grid_idx(grid_idx: torch.Tensor, batches: int, kernel: str):
    """When ``LIGHTPLANE_CHECK_GRID_IDX=1``, raise ``ValueError`` if an entry
    of ``grid_idx`` lies outside ``[0, batches)``; with the flag unset read
    nothing back."""
    if not _flag("LIGHTPLANE_CHECK_GRID_IDX") or grid_idx.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(grid_idx))
    if lo < 0 or hi >= batches:
        raise ValueError(
            f"{kernel}: grid_idx out of range: [{lo}, {hi}] outside "
            f"[0, {batches}) (LIGHTPLANE_CHECK_GRID_IDX=1)"
        )


def assert_grads_finite(grads, label: str):
    """Return ``grads`` (a sequence of tensors or Nones) unchanged; when
    ``LIGHTPLANE_CHECK_GRADS=1``, raise ``FloatingPointError`` if any
    floating-point gradient holds a NaN or an infinity."""
    if not check_grads_enabled():
        return grads
    bad = sum(
        int((~torch.isfinite(g)).sum())
        for g in grads
        if g is not None and g.is_floating_point()
    )
    if bad:
        raise FloatingPointError(
            f"lightplane_tpu_torch: {bad} non-finite gradient value(s) after "
            f"the {label} backward pass (LIGHTPLANE_CHECK_GRADS=1)"
        )
    return grads
