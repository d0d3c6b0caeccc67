"""Image IO (counterpart of ``lightplane_tpu/utils/io_utils.py``), with
numpy and the standard library only: ``save_image`` writes PNG and
``read_png`` reads it (``zlib``, ``struct``), and ``colorize_depth`` maps
depth through matplotlib's "magma" table, copied as numbers, so neither
PIL, imageio nor matplotlib is needed.  ``write_video`` imports imageio
when it is called, as the JAX package's does."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

from ._magma import MAGMA_DATA


def to_uint8(img) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


# matplotlib's "magma" as numbers, so the default map needs no matplotlib;
# float64, as matplotlib keeps it, so the bytes come out the same
_MAGMA = np.array(MAGMA_DATA, np.float64)


def _colormap(name: str):
    """``x in [0, 1] -> [..., 3]`` float RGB of the colour map ``name``."""
    if name == "magma":
        return lambda x: _listed(_MAGMA, x)
    try:
        import matplotlib
    except ImportError:
        raise ValueError(
            f"colour map {name!r} needs matplotlib, which does not import; "
            "only 'magma' is built in"
        ) from None
    return lambda x: matplotlib.colormaps[name](x)[..., :3]


def _listed(table: np.ndarray, x) -> np.ndarray:
    """Look ``x`` up in a colour table as matplotlib's ``ListedColormap``
    does: entry ``int(x * N)``, 1.0 on the last entry, NaN black."""
    n = len(table)
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    idx = np.clip(np.where(bad, 0, xa).astype(int), 0, n - 1)
    rgb = table[idx]
    rgb[bad] = 0.0
    return rgb


def colorize_depth(
    depth,
    near: Optional[float] = None,
    far: Optional[float] = None,
    cmap: str = "magma",
) -> np.ndarray:
    """An ``[H, W, 3]`` uint8 picture of a depth image: depth normalised
    between its 1st and 99th percentiles (or ``near`` and ``far``) and
    mapped through the colour map ``cmap``.  "magma" is built in; any other
    map needs matplotlib, and without it raises ``ValueError``."""
    colormap = _colormap(cmap)
    d = np.asarray(depth, np.float32)
    lo = np.percentile(d, 1) if near is None else near
    hi = np.percentile(d, 99) if far is None else far
    dn = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    return (colormap(dn) * 255).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


# PNG colour types: 0 grey, 2 RGB, 3 palette, 4 grey + alpha, 6 RGBA
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def save_image(path: str, img):
    """Write an ``[H, W]``, ``[H, W, 2]`` (grey + alpha), ``[H, W, 3]`` or
    ``[H, W, 4]`` image (uint8, or floats in [0, 1]) as an 8-bit PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    color_type = {2: 0, 3: {2: 4, 3: 2, 4: 6}.get(arr.shape[-1])}.get(arr.ndim)
    if color_type is None:
        raise ValueError(f"cannot write an image of shape {arr.shape}")
    h, w = arr.shape[:2]
    # one filter byte (0: none) before each row
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", header))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def is_png(path: str) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(8) == _PNG_SIGNATURE


def _unfilter_rows(rows: np.ndarray, kinds: np.ndarray, bpp: int):
    """Undo the PNG row filters: ``rows [H, L]`` filtered bytes, ``kinds
    [H]`` each row's filter (0 none, 1 sub, 2 up, 3 average, 4 Paeth),
    ``bpp`` bytes per pixel.  Rows of the first three kinds are undone a row
    at a time; with any average or Paeth row every byte is undone along
    anti-diagonals of pixels, which depend only on earlier ones (left, up,
    up-left)."""
    h, n = rows.shape
    w = n // bpp
    if not np.isin(kinds, (3, 4)).any():
        out = np.zeros((h + 1, n), np.uint8)
        for y in range(h):
            r, kind = rows[y], kinds[y]
            if kind == 1:
                r = np.cumsum(r.reshape(w, bpp), axis=0, dtype=np.uint64)
                r = (r & 0xFF).astype(np.uint8).reshape(n)
            elif kind == 2:
                r = r + out[y]   # uint8 wraps mod 256
            out[y + 1] = r
        return out[1:]
    f = rows.reshape(h, w, bpp).astype(np.int32)
    # one pixel of zeros above and to the left of the image
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    kind_of = kinds.astype(np.int32)
    for k in range(h + w - 1):
        ys = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        xs = k - ys
        a = rec[ys + 1, xs]          # left
        b = rec[ys, xs + 1]          # up
        c = rec[ys, xs]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = kind_of[ys][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(h, n)


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as a uint8 array: ``[H, W]`` (grey),
    ``[H, W, 2]`` (grey + alpha), ``[H, W, 3]`` (RGB) or ``[H, W, 4]``
    (RGBA), as ``np.asarray(PIL.Image.open(path))`` gives them.  Any other
    PNG (16-bit or fewer than 8 bits a sample, palette, interlaced) raises
    ``ValueError`` naming what it lacks."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in its {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color_type, _, _, interlace = header
    if color_type not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color_type} (palette) is "
                         "not supported; only 8-bit grey, grey + alpha, RGB "
                         "and RGBA are")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG samples are not "
                         "supported; only 8-bit ones are")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         "supported")
    ch = _PNG_CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (1 + w * ch)].reshape(h, 1 + w * ch)
    kinds = raw[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter {int(kinds.max())}")
    img = _unfilter_rows(raw[:, 1:], kinds, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 20):
    """Write an mp4 of ``frames`` (uint8, or floats in [0, 1]) with imageio,
    or a gif where imageio has no ffmpeg backend; returns the path
    written."""
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [np.asarray(f) for f in frames]
    frames = [f if f.dtype == np.uint8 else to_uint8(f) for f in frames]
    try:
        imageio.mimwrite(path, frames, fps=fps)
    except Exception:
        alt = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(alt, frames, duration=1.0 / fps)
        return alt
    return path
