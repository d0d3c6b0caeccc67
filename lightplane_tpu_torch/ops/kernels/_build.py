"""Build-at-first-use and ``ctypes`` loading of the CUDA sources in
``lightplane_tpu_torch/csrc``.

The ``*.cu`` files have a plain C interface, so ``nvcc`` compiles them
without PyTorch's headers: one ``nvcc`` per source, all started together,
then one link into a shared library.  The library goes to ``build/kernels/``
at the repository root, named by a hash of the sources (``*.cu`` and
``*.cuh``) and the flags, so a changed source builds anew and an unchanged
one loads the cached file.  Nothing is built or loaded on import: the first
call to :func:`library` does it, and only a CUDA launch calls it.
``defines`` (``NAME=value`` strings, passed to ``nvcc`` as ``-D``) build a
variant of the sources beside the default one: ``chip_smoke.py --ablate``
uses them to switch parts of a kernel off, and the relu-mask recording
build of R2 and S2 (``renderer_bw.RELU_MASKS_BUILD``) is one.
``nice`` lowers the priority of a build's ``nvcc`` runs (``nice -n``), so
that a build started beside other work takes the cores that work leaves;
``SECONDS[defines]`` holds each source's compile time from the last build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# lightplane_render_fw, argument by argument (see csrc/renderer_fw.cu)
_RENDER_FW_ARGTYPES = (
    [_P] * 11            # origins .. feat
    + [_I, _I, _P, _I]   # num_rays, num_grids, grid_meta, grid_chn
    + [_I, _I, _I, _P]   # n_t, n_o, n_c, mlp_widths
    + [_I, _I, _I, _I]   # enc_chn, color_chn, width, warps
    + [_I, _I, _F, _F]   # num_samples, num_samples_inf, disparity, gain
    + [_I, _I, _F, _I, _I, _I]  # mask, contract, sigma, seed, stride, R_noise
    + [_P, _P, _P, _I, _P]  # scaffold, its dims, color grid, its count, table
    + [_P]               # workspace (the wide build's)
    + [_P]               # probe (the wide build's recording build's)
    + [_P]               # stream
)
# lightplane_render_bw (see csrc/renderer_bw.cu)
_RENDER_BW_ARGTYPES = (
    [_P] * 16            # origins .. mlp, nlt_final .. g_feat, g_grid .. partial
    + [_I, _I, _P, _I]   # num_rays, num_grids, grid_meta, grid_chn
    + [_I, _I, _I, _P]   # n_t, n_o, n_c, mlp_widths
    + [_I, _I, _I, _I]   # enc_chn, color_chn, width, rays_per_block
    + [_I, _I, _F, _F]   # num_samples, num_samples_inf, disparity, gain
    + [_I, _I, _F, _I, _I, _I]  # mask, contract, sigma, seed, stride, R_noise
    + [_P, _P, _P, _I, _P]  # scaffold, its dims, color grid, its count, table
    + [_P]               # g_color_grid
    + [_P]               # relu_masks (the recording build's)
    + [_P]               # workspace (the wide build's)
    + [_P]               # probe (the wide build's recording build's)
    + [_P]               # stream
)

# lightplane_splat_fw (see csrc/splatter_fw.cu)
_SPLAT_FW_ARGTYPES = (
    [_P] * 10            # origins .. mlp, feat, w
    + [_I, _I, _P, _I]   # num_rays, num_out_grids, out_meta, out_chn
    + [_I, _P, _I]       # num_in_grids, in_meta, in_chn
    + [_I, _P, _I]       # n_layers, mlp_widths, width
    + [_I, _I, _F, _I, _I]  # num_samples, num_samples_inf, disparity, mask,
                            # contract
    + [_P, _I]           # bricks, stage
    + [_P, _P, _P, _P, ctypes.c_longlong]  # counts, cursor, offsets, runs,
                                           # capacity
    + [_P, _I, ctypes.c_longlong]  # item_start, runs_per_item, max_items
    + [_I, _I]           # step_values, batch_limit
    + [_P]               # stream
)
# lightplane_splat_fw_mlp, the wide MLP build's pass F (csrc/splatter_fw.cu)
_SPLAT_FW_MLP_ARGTYPES = (
    [_P] * 10            # origins .. mlp, values, workspace
    + [_I, _I, _P, _I]   # num_rays, num_out_grids, out_meta, out_chn
    + [_I, _P, _I]       # num_in_grids, in_meta, in_chn
    + [_I, _P, _I]       # n_layers, mlp_widths, width
    + [_I, _I, _F, _I, _I]  # num_samples, num_samples_inf, disparity, mask,
                            # contract
    + [_P]               # stream
)
# lightplane_splat_bw (see csrc/splatter_bw.cu)
_SPLAT_BW_ARGTYPES = (
    [_P] * 14            # origins .. mlp, g_out, g_enc, g_mlp, partial,
                         # stage, g_vec
    + [_I, _I, _P, _I]   # num_rays, num_out_grids, out_meta, out_chn
    + [_I, _P, _I]       # num_in_grids, in_meta, in_chn
    + [_I, _P, _I, _I]   # n_layers, mlp_widths, width, rows
    + [_I, _I, _F, _I, _I]  # num_samples, num_samples_inf, disparity, mask,
                            # contract
    + [_I]               # part
    + [_P]               # relu_masks (the recording build's)
    + [_P]               # workspace (the wide build's)
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


def _cache_key(sources, flags) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _run_all(cmds, nice=0):
    """Run the commands in parallel (at ``nice``); return each one's
    seconds; raise with the stderr of the first that fails."""
    prefix = ["nice", "-n", str(nice)] if nice and shutil.which("nice") else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen(prefix + cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]

    def wait(proc):
        err = proc.communicate()[1]
        return err, time.perf_counter() - t0

    with ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(wait, procs))
    for cmd, proc, (err, _) in zip(cmds, procs, done):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{err}"
            )
    return [seconds for _, seconds in done]


# each source's compile time (seconds) in the last build of each defines
SECONDS: dict = {}


def build(defines=(), nice=0) -> Path:
    """Compile the sources, with ``-D`` for each of ``defines``, into
    ``build/kernels/liblightplane_<hash>.so`` unless that file exists;
    returns its path.  Raises with nvcc's stderr when the build fails."""
    sources = _sources()
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    key = _cache_key(sources + headers, flags)
    out = BUILD_DIR / f"liblightplane_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename the library into place:
    # concurrent builds never see a half-written file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        nvcc = _nvcc()
        seconds = _run_all([[nvcc, *flags, "-c", "-o", str(obj), str(src)]
                            for src, obj in zip(sources, objs)], nice)
        SECONDS[tuple(defines)] = dict(zip((s.name for s in sources),
                                           seconds))
        lib = Path(tmp) / "lib.so"
        _run_all([[nvcc, *flags, "-shared", "-o", str(lib),
                   *map(str, objs)]], nice)
        os.replace(lib, out)
    return out


@functools.cache
def library(defines=()) -> ctypes.CDLL:
    """The kernel library built with ``defines``, loaded once per process,
    with the argument types of every entry point set."""
    lib = ctypes.CDLL(str(build(defines)))
    lib.lightplane_render_fw.argtypes = _RENDER_FW_ARGTYPES
    lib.lightplane_render_fw.restype = _I
    lib.lightplane_render_fw_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.lightplane_render_fw_smem_bytes.restype = ctypes.c_longlong
    lib.lightplane_render_bw.argtypes = _RENDER_BW_ARGTYPES
    lib.lightplane_render_bw.restype = _I
    lib.lightplane_render_bw_smem_bytes.argtypes = [_I, _I, _I, _I, _I]
    lib.lightplane_render_bw_smem_bytes.restype = ctypes.c_longlong
    lib.lightplane_render_bw_partial_floats.argtypes = [_I, _I]
    lib.lightplane_render_bw_partial_floats.restype = ctypes.c_longlong
    lib.lightplane_render_bw_wide_config.argtypes = [
        _I, _I, _I, _I, _P, _I, ctypes.POINTER(_I)]
    lib.lightplane_render_bw_wide_config.restype = _I
    lib.lightplane_render_fw_wide_config.argtypes = [
        _I, _I, _I, _I, _P, ctypes.POINTER(_I)]
    lib.lightplane_render_fw_wide_config.restype = _I
    lib.lightplane_render_wide_pack.argtypes = [_P, _I, _I, _I, _P, _I, _P,
                                                _P]
    lib.lightplane_render_wide_pack.restype = _I
    lib.lightplane_splat_fw.argtypes = _SPLAT_FW_ARGTYPES
    lib.lightplane_splat_fw.restype = _I
    lib.lightplane_splat_fw_smem_bytes.argtypes = [_I] * 5
    lib.lightplane_splat_fw_smem_bytes.restype = ctypes.c_longlong
    lib.lightplane_splat_fw_mlp.argtypes = _SPLAT_FW_MLP_ARGTYPES
    lib.lightplane_splat_fw_mlp.restype = _I
    lib.lightplane_splat_fw_mlp_config.argtypes = [_I, _I, _P,
                                                   ctypes.POINTER(_I)]
    lib.lightplane_splat_fw_mlp_config.restype = _I
    lib.lightplane_splat_bw.argtypes = _SPLAT_BW_ARGTYPES
    lib.lightplane_splat_bw.restype = _I
    lib.lightplane_splat_bw_mlp_config.argtypes = [_I, _I, _P,
                                                   ctypes.POINTER(_I)]
    lib.lightplane_splat_bw_mlp_config.restype = _I
    for attrs in (lib.lightplane_splat_fw_attrs,
                  lib.lightplane_splat_bw_attrs):
        attrs.argtypes = [_I, _I, ctypes.POINTER(_I)]
        attrs.restype = _I
    for attrs in (lib.lightplane_render_fw_attrs,
                  lib.lightplane_render_bw_attrs):
        attrs.argtypes = [_I, ctypes.POINTER(_I)]
        attrs.restype = _I
    lib.lightplane_cuda_error_string.argtypes = [_I]
    lib.lightplane_cuda_error_string.restype = ctypes.c_char_p
    return lib
