"""Debug-gated numerical guards (counterpart of
``lightplane_tpu/ops/guards.py``).

The reference asserts every gradient is finite after each backward pass
(``lightplane_renderer.py:719-722``).  On a GPU that check synchronises the
host with the device, so it is opt-in: set ``LIGHTPLANE_CHECK_GRADS=1`` and
every fused-operator backward counts the non-finite values of the gradients
it produced and raises ``FloatingPointError`` if there are any.  With the
flag unset the guard does nothing.
"""

from __future__ import annotations

import os

import torch


def check_grads_enabled() -> bool:
    return os.environ.get("LIGHTPLANE_CHECK_GRADS", "0") not in ("", "0")


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
