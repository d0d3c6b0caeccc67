"""Image dumps (counterpart of ``lightplane_tpu/utils/io_utils.py``), with
numpy and the standard library only: ``save_image`` writes PNG itself
(``zlib``, ``struct``), and ``colorize_depth`` maps depth through a small
built-in colour table, so neither imageio nor matplotlib is needed.  Video
writing is not ported yet."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def to_uint8(img) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


# Nine stops of matplotlib's "magma" (at 0, 1/8, ..., 1), linearly
# interpolated between: close to the JAX package's matplotlib colour map,
# not equal to it.
_MAGMA = np.array([
    [0.001462, 0.000466, 0.013866],
    [0.113094, 0.065492, 0.276784],
    [0.316654, 0.071690, 0.485380],
    [0.512831, 0.148179, 0.507648],
    [0.716387, 0.214982, 0.475290],
    [0.904281, 0.319610, 0.388137],
    [0.986700, 0.535582, 0.382210],
    [0.996898, 0.769591, 0.534892],
    [0.987053, 0.991438, 0.749504],
], np.float32)


def colorize_depth(
    depth,
    near: Optional[float] = None,
    far: Optional[float] = None,
) -> np.ndarray:
    """An ``[H, W, 3]`` uint8 picture of a depth image: depth normalised
    between its 1st and 99th percentiles (or ``near`` and ``far``) and
    mapped through a nine-stop approximation of the "magma" colour map."""
    d = np.asarray(depth, np.float32)
    lo = np.percentile(d, 1) if near is None else near
    hi = np.percentile(d, 99) if far is None else far
    dn = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    pos = dn * (len(_MAGMA) - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), len(_MAGMA) - 2)
    f = (pos - i0)[..., None]
    rgb = _MAGMA[i0] * (1.0 - f) + _MAGMA[i0 + 1] * f
    return (rgb * 255).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_image(path: str, img):
    """Write an ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` image (uint8, or
    floats in [0, 1]) as an 8-bit PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    color_type = {2: 0, 3: {3: 2, 4: 6}.get(arr.shape[-1])}.get(arr.ndim)
    if color_type is None:
        raise ValueError(f"cannot write an image of shape {arr.shape}")
    h, w = arr.shape[:2]
    # one filter byte (0: none) before each row
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))
