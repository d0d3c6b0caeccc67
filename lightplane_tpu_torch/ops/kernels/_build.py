"""Build-at-first-use and ``ctypes`` loading of the CUDA sources in
``lightplane_tpu_torch/csrc``.

The ``*.cu`` files have a plain C interface, so ``nvcc`` compiles them into
one shared library in a few seconds, without PyTorch's headers.  The library
goes to ``build/kernels/`` at the repository root, named by a hash of the
sources and the flags, so a changed source builds anew and an unchanged one
loads the cached file.  Nothing is built or loaded on import: the first call
to :func:`library` does it, and only a CUDA launch calls it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# lightplane_render_fw, argument by argument (see csrc/renderer_fw.cu)
_RENDER_FW_ARGTYPES = (
    [_P] * 11            # origins .. feat
    + [_I, _I, _P, _I]   # num_rays, num_grids, grid_meta, grid_chn
    + [_I, _I, _I, _P]   # n_t, n_o, n_c, mlp_widths
    + [_I, _I, _I]       # enc_chn, color_chn, width
    + [_I, _I, _F, _F]   # num_samples, num_samples_inf, disparity, gain
    + [_I, _I, _F, _I, _I, _I]  # mask, contract, sigma, seed, stride, R_noise
    + [_P]               # stream
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of lightplane_tpu_torch are built at first use and need "
        "the CUDA toolkit"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _cache_key(sources) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources into ``build/kernels/liblightplane_<hash>.so``
    unless that file exists; returns its path.  Raises with nvcc's stderr
    when the build fails."""
    sources = _sources()
    out = BUILD_DIR / f"liblightplane_{_cache_key(sources)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builders never see a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process, with the
    argument types of every entry point set."""
    lib = ctypes.CDLL(str(build()))
    lib.lightplane_render_fw.argtypes = _RENDER_FW_ARGTYPES
    lib.lightplane_render_fw.restype = _I
    lib.lightplane_render_fw_smem_bytes.argtypes = [_I, _I, _I]
    lib.lightplane_render_fw_smem_bytes.restype = ctypes.c_longlong
    lib.lightplane_cuda_error_string.argtypes = [_I]
    lib.lightplane_cuda_error_string.restype = ctypes.c_char_p
    return lib
