#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``lightplane_tpu_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without its result line:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, which must be 9.0; TF32 is switched off.
2. Build: ``nvcc`` compiles ``lightplane_tpu_torch/csrc/*.cu`` (cached under
   ``build/kernels/`` by a hash of the sources).
3. Kernel vs plain PyTorch version on the card, at small sizes, over the
   configurations the kernel supports.
4. The slice: the ``LightplaneRenderer`` module at the repository's headline
   render config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2 with hidden 32,
   harmonic ray embedding, 256 samples) serves four 256 x 256 frames from
   four orbit poses through the CUDA kernel; frame 0 is checked against the
   plain version and both are timed.

The last two lines are a JSON line per kernel and the result line
``{"ok": true, "device": {...}}``.  Needs no network and no JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# tests/utils.py::compare_one bounds (max, mean, mean relative |diff|)
MAX_DIFF, MEAN_DIFF, MEAN_REL_DIFF = 0.1, 2e-3, 7e-4
# The kernel and the plain version differ only in float rounding (summation
# order, fused multiply-adds, CUDA's expf/logf): both are f32 on the card.
KERNEL_MAX_ABS = 1e-3

IMAGE = 256
SLICE = dict(
    num_samples=256, color_chn=3, grid_chn=32, mlp_hidden_chn=32,
    mlp_n_layers_trunk=2, mlp_n_layers_opacity=2, mlp_n_layers_color=2,
    opacity_init_bias=-2.0, ray_embedding_num_harmonics=3, bg_color=1.0,
)


def compare(name, x, y, max_abs=KERNEL_MAX_ABS, magnitude_scaled=False):
    """Assert the compare_one bounds and ``max |x - y| <= max_abs`` (both
    absolute bounds scaled by the data's magnitude when asked); returns
    (max |diff|, mean |diff|)."""
    x = x.detach().double().cpu().numpy()
    y = y.detach().double().cpu().numpy()
    assert x.shape == y.shape, f"{name}: shape {x.shape} vs {y.shape}"
    assert np.isfinite(x).all() and np.isfinite(y).all(), f"{name}: non-finite"
    adiff = np.abs(x - y)
    rel = adiff / (0.5 * (np.abs(x) + np.abs(y)) + 1e-4)
    scale_max = max(1.0, float(np.abs(x).max())) if magnitude_scaled else 1.0
    scale_mean = max(1.0, float(np.abs(x).mean())) if magnitude_scaled else 1.0
    mx, mn = float(adiff.max()), float(adiff.mean())
    print(f"    {name:6s} max|d| {mx:.3e}  mean|d| {mn:.3e}  "
          f"mean rel {float(rel.mean()):.3e}")
    assert mx <= MAX_DIFF * scale_max, f"{name}: max |diff| {mx}"
    assert mn <= MEAN_DIFF * scale_mean, f"{name}: mean |diff| {mn}"
    assert rel.mean() <= MEAN_REL_DIFF, f"{name}: mean rel diff {rel.mean()}"
    assert mx <= max_abs * scale_max, f"{name}: max |diff| {mx} > {max_abs}"
    return mx, mn


def cuda_ms(fn, warmup=2, reps=7):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_case(lp, rng, n_rays, grid_shapes, hidden=32, layers=(2, 2, 2),
                batch=1):
    """Rays aimed from a shell at z=-2 toward the origin, a random
    grid-list and a decoder, all made from ``rng`` on the card."""
    dev = "cuda"
    origins = rng.standard_normal((n_rays, 3)) / 3.0 + np.array([0, 0, -2.0])
    targets = rng.standard_normal((n_rays, 3)) * 0.2
    near = 0.1 + 0.05 * rng.random(n_rays)
    far = 3.0 + 0.2 * rng.random(n_rays)
    grid_idx = rng.integers(0, batch, n_rays)
    chn = grid_shapes[0][-1]
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    dp = lp.init_decoder_params(
        gen, n_layers_trunk=layers[0], n_layers_opacity=layers[1],
        n_layers_color=layers[2], input_chn=chn, hidden_chn=hidden,
        color_chn=3, opacity_init_bias=-1.0, device=dev,
    )
    enc = rng.standard_normal((n_rays, dp.n_hidden_color[0])) * 0.1

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    rays = lp.Rays(
        directions=t(targets - origins), origins=t(origins),
        grid_idx=t(grid_idx, torch.int64), near=t(near), far=t(far),
        encoding=t(enc),
    )
    grid = [t(rng.standard_normal(s) * 0.5) for s in grid_shapes]
    return rays, grid, dp


def orbit_rays(lp, azimuth, device):
    """Raster-order pinhole rays of one 256 x 256 frame from a camera at
    distance 2 from the origin, looking at it; near 1, far 3."""
    pos = np.array([2.0 * np.sin(azimuth), 0.0, -2.0 * np.cos(azimuth)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    ys, xs = np.meshgrid(np.linspace(-0.5, 0.5, IMAGE),
                         np.linspace(-0.5, 0.5, IMAGE), indexing="ij")
    d = (xs.reshape(-1, 1) * right + ys.reshape(-1, 1) * up + fwd)
    n = IMAGE * IMAGE

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return lp.Rays(
        directions=t(d), origins=t(np.tile(pos, (n, 1))),
        grid_idx=t(np.zeros(n), torch.int64), near=t(np.full(n, 1.0)),
        far=t(np.full(n, 3.0)),
    )


def phase_device():
    print("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}, capability {cap}, "
          f"{torch.cuda.device_count()} device(s)")
    assert cap == (9, 0), f"needs a Hopper (sm_90) card, got {cap}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    print("== phase 2: build")
    from lightplane_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"built {path.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_parity(lp):
    print("== phase 3: kernel vs plain PyTorch version on the card")
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    tri = [(1, 1, 32, 32, 32), (1, 32, 1, 32, 32), (1, 32, 32, 1, 32)]
    cases = [
        ("triplane", dict(grid_shapes=tri), {}),
        ("voxel_batch2", dict(grid_shapes=[(2, 16, 16, 16, 16)], batch=2), {}),
        ("voxel_plane_mask",
         dict(grid_shapes=[(1, 16, 16, 16, 16), (1, 1, 24, 20, 16)]),
         dict(mask_out_of_bounds_samples=True)),
        ("contract", dict(grid_shapes=tri), dict(contract_coords=True)),
        ("noise", dict(grid_shapes=tri),
         dict(inject_noise_sigma=1.0, inject_noise_seed=3)),
        ("samples_inf8", dict(grid_shapes=tri),
         dict(num_samples_inf=8, disparity_at_inf=1e-3)),
        ("mlp_1_3_2_h64",
         dict(grid_shapes=[(1, 16, 16, 16, 16)], hidden=64, layers=(1, 3, 2)),
         {}),
        ("mlp_0_1_3",
         dict(grid_shapes=[(1, 16, 16, 16, 32)], layers=(0, 1, 3)), {}),
        ("voxel64_32ch", dict(grid_shapes=[(1, 64, 64, 64, 32)]), {}),
    ]
    worst = 0.0
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for name, case_kw, render_kw in cases:
            rays, grid, dp = random_case(lp, rng, 4096, **case_kw)
            kw = dict(num_samples=48, gain=1.5, **render_kw)
            out_k = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
            out_p = lp.lightplane_renderer(rays, grid, dp, impl="torch", **kw)
            torch.cuda.synchronize()
            print(f"  {name}: {render_kw or ''}")
            # background samples reach nlt ~ 1e3: bounds scale with it
            scaled = "num_samples_inf" in render_kw
            for label, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
                worst = max(worst, compare(label, a, b,
                                           magnitude_scaled=scaled)[0])
            if name == "triplane":
                out_n = lp.lightplane_renderer_naive(rays, grid, dp, **kw)
                print("  triplane, kernel vs the materializing naive renderer:")
                for label, a, b in zip(("depth", "nlt", "feat"), out_k, out_n):
                    compare(label, a, b)
            if scaled:
                # the kernel's own disparity schedule: the unsplit march
                grid_flat, _, sizes, _ = lp.process_and_flatten_grid(
                    grid, None)
                cfg = rmod._RenderCfg(
                    num_samples=48, num_samples_inf=8, gain=1.5,
                    mask_out_of_bounds_samples=False, contract_coords=False,
                    disparity_at_inf=1e-3, inject_noise_sigma=0.0,
                    grid_sizes=sizes, color_grid_sizes=None,
                    n_hidden_trunk=dp.n_hidden_trunk,
                    n_hidden_opacity=dp.n_hidden_opacity,
                    n_hidden_color=dp.n_hidden_color,
                    scaffold_size=None, num_rays_noise=len(rays),
                    out_chn=dp.color_chn,
                )
                geom = (rays.directions, rays.origins, rays.near, rays.far,
                        rays.grid_idx.to(torch.int32), None, 0)
                diff = (grid_flat, None, dp.mlp_params, rays.encoding)
                print("  samples_inf8, unsplit march in one kernel launch:")
                for label, a, b in zip(
                    ("depth", "nlt", "feat"),
                    rfw.render_fwd_cuda(cfg, geom, diff),
                    rfw.render_fwd_torch(cfg, geom, diff),
                ):
                    compare(label, a, b, magnitude_scaled=True)
    print(f"  all configs within bounds; worst max|d| {worst:.3e}")


def phase_slice(lp, smi):
    print("== phase 4: the slice, 4 frames of 256x256 rays x 256 samples")
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    module = lp.LightplaneRenderer(generator=gen, device=dev, **SLICE)
    res, chn = 32, SLICE["grid_chn"]
    grid = [
        (torch.randn(s, generator=gen) * 0.1).to(dev)
        for s in [(1, 1, res, res, chn), (1, res, 1, res, chn),
                  (1, res, res, 1, chn)]
    ]
    requests = [orbit_rays(lp, a, dev) for a in np.arange(4) * np.pi / 2]
    image_size = (IMAGE, IMAGE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rfw.LAUNCHES = 0
    with torch.inference_mode():
        frames = [module(r, grid, image_size=image_size) for r in requests]
    torch.cuda.synchronize()
    launches = rfw.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    print(f"  served {len(frames)} frames; kernel launches {launches}; "
          f"peak allocated {peak / 2**20:.1f} MiB  [{smi}]")
    assert launches == len(requests), launches
    n = IMAGE * IMAGE
    for depth, alpha, rgb in frames:
        assert depth.shape == (n,) and alpha.shape == (n,)
        assert rgb.shape == (n, SLICE["color_chn"])
        for x in (depth, alpha, rgb):
            assert torch.isfinite(x).all()
        assert float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0
    print(f"  frame 0: alpha in [{float(frames[0][1].min()):.4f}, "
          f"{float(frames[0][1].max()):.4f}], mean rgb "
          f"{frames[0][2].mean(0).tolist()}")

    with torch.inference_mode():
        plain = module(requests[0], grid, image_size=image_size, impl="torch")
    torch.cuda.synchronize()
    print("  frame 0, kernel vs plain version:")
    errs = [compare(label, a, b)[0]
            for label, a, b in zip(("depth", "alpha", "rgb"), frames[0], plain)]

    # the kernel call on its own: the renderer at the frame's rays and
    # embedding, kernel against plain version
    with torch.inference_mode():
        r0 = requests[0]
        rays_enc = lp.Rays(
            directions=r0.directions, origins=r0.origins,
            grid_idx=r0.grid_idx, near=r0.near, far=r0.far,
            encoding=module._get_ray_embedding(r0.directions),
        )
        dp = module.get_decoder_params()
        call = dict(num_samples=SLICE["num_samples"], gain=module.gain)

        def kernel():
            lp.lightplane_renderer(rays_enc, grid, dp, impl="cuda", **call)

        def plain_fn():
            lp.lightplane_renderer(rays_enc, grid, dp, impl="torch", **call)

        def frame():
            module(r0, grid, image_size=image_size)

        def frame_plain():
            module(r0, grid, image_size=image_size, impl="torch")

        kernel_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain_fn, warmup=1, reps=5)
        frame_ms = cuda_ms(frame)
        frame_plain_ms = cuda_ms(frame_plain, warmup=1, reps=5)
    print(f"  kernel call: median {kernel_ms:.3f} ms; plain version "
          f"{plain_ms:.3f} ms  [{smi}]")
    print(f"  module frame: median {frame_ms:.3f} ms through the kernel, "
          f"{frame_plain_ms:.3f} ms through the plain version  [{smi}]")
    print(f"  peak allocated while serving: {peak} bytes  [{smi}]")
    return dict(
        name="renderer_fw", route="cuda",
        source="lightplane_tpu_torch/csrc/renderer_fw.cu",
        replaces="lightplane_tpu/ops/kernels/renderer_pallas.py:2073",
        launches=launches, max_abs_err=max(errs), ms=kernel_ms,
        plain_ms=plain_ms,
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import lightplane_tpu_torch as lp

    t0 = time.perf_counter()
    smi, name = phase_device()
    phase_build()
    phase_parity(lp)
    kernel = phase_slice(lp, smi)
    assert "jax" not in sys.modules, "the port imported jax"
    print(f"== done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
