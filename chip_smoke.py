#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``lightplane_tpu_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py            # the phases below
    python3 chip_smoke.py --ablate   # phases 1-2, R2 and S1 with parts off

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without its result line:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, which must be 9.0; TF32 is switched off.
2. Build: ``nvcc`` compiles ``lightplane_tpu_torch/csrc/*.cu`` (cached under
   ``build/kernels/`` by a hash of the sources).
3. The forward kernel (R1) vs its plain PyTorch version on the card, at
   4096 rays and 48 samples, over fourteen configurations it supports, five
   of them the big shapes that the TPU's W3 sampler served (a 3 x 128^2
   and a 3 x 100^2 triplane, a batch of two 32^3 grids, a contracted 32^3
   grid, an 8^3 + 24^3 pyramid; all 16ch).
3b. The backward kernel (R2) vs its plain version on the same fourteen
   configurations, with the JAX parity tests' N(0, 0.05) decoders:
   gradients of a fixed random-projection loss w.r.t. the grid-list,
   ``mlp_params`` and ``rays.encoding`` through
   ``lightplane_renderer(impl="cuda")`` (R1 + R2) and ``impl="torch"``.
   First, on the triplane config with the initialiser's decoder, where f32
   gradients are rough at relu kinks, it prints how far each f32 version is
   from the f64 run and how close that ray came to a kink.
3c. Scaffold gating (R3) and the relu-field colour grid (R1-rf) in R1 and
   R2 vs their plain versions, on the triplane config: random, empty and
   half-empty binary scaffolds, one from ``calculate_scaffold`` at 64^3, and
   two relu-field configs (one with a scaffold); it prints how many gates
   sit within 1e-6 of a rounding boundary, where an ulp flips a gate.
4. Serving: the ``LightplaneRenderer`` module at the repository's headline
   render config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2 with hidden 32,
   harmonic ray embedding, 256 samples) serves four 256 x 256 frames from
   four orbit poses through R1; frame 0 is checked against the plain
   version and both are timed.  Before it, the memory that earlier phases
   leave allocated is printed, and serving's peak is read above it too.
5. Training: the same model as ``nn.Module`` plus triplane
   ``nn.Parameter``s takes 12 Adam steps of one full frame each through
   R1 + R2 against targets a second model renders; the fw+bw step, each
   kernel and the plain versions are timed, and peak memory is read at 128
   and 256 samples.
6. The splatter's forward kernel (S1) and adjoint (S2) vs their plain
   versions on the card: the raw accumulators, the normalised grid and the
   gradients of a fixed random-projection loss w.r.t. the encoding (and,
   with the MLP, the input grid and ``mlp_params``), through
   ``lightplane_splatter_raw`` / ``lightplane_(mlp_)splatter`` with
   ``impl="cuda"`` and ``impl="torch"``.  Configs: the eight variants of
   ``tests/test_splatter_parity.py`` at 4096 rays, 32 samples and 16^3
   grids; the eight grid shapes of ``tests/test_splatter_sorted.py``; one
   128^2 camera view at 96 samples into a 160^3 x 64ch voxel grid and into
   a 3 x 128^2 x 32ch triplane; and phase 7's MLP splatter at its shapes
   (MLP 32 -> 32 -> 64, the 64-wide kernels, from a 3 x 128^2 x 32ch input
   triplane into 160^3 x 64ch) over one such view.
7. The splatter at full width (``bench.py``'s splatter headline): 16 views
   x 128^2 rays x 96 samples into one 160^3 x 64ch voxel grid.  The fw+bw
   step of ``lightplane_splatter`` (loss ``sum(out^2)``), S1 and S2 alone and
   their plain versions are timed, peak memory is read at 48 and 96
   samples; then the ``LightplaneMLPSplatter`` (MLP 32 -> 32 -> 64) over
   the same rays with a 3 x 128^2 x 32ch input triplane.
8. Lift-then-render (``bench.py``'s batched 512^2 memory workload): per-pixel
   32-channel encodings of 2 and of 4 images are splatted into a 3 x 128^2
   x 32ch triplane (96 samples) and rendered back (256 samples, decoder
   2/2/2 with hidden 32); one backward reaches the encodings and the
   decoder through R2 and S2.  Step time, peak memory, and the marginal
   memory per image.
9. Scene fitting: the port's trainer
   (``lightplane_tpu_torch.examples.fit_single_scene.main``) at the JAX
   app's default width (triplane 3 x 64^2 x 32ch, 128 samples, 4096 rays,
   the synthetic scene) for 600 steps, with scaffold updates before and
   after an upsample to 3 x 128^2 x 32ch at 256 samples: ms per step between
   events, occupancy, eval PSNR and SSIM (the last must beat the first),
   launches; 20 steps with and without the scaffold; a profiled step; R1
   and R2 alone with the scaffold; then a relu-field model (density and
   colour triplanes of 3 x 64^2 x 32ch) takes 12 Adam steps.

Phases 4, 5, 7, 8 and 9 each set the kernels' launch counts to 0 just
before they drive their path and read them just after.  Every phase prints
its time.  The last lines are the card's name and power limit, a JSON line
with every kernel (its launches on its main path, the trainer of phase 9
for R1 and R2 and the splatter step of phase 7 for S1 and S2, its error
against the plain version, its time, the plain version's time and the least
time the card could take, and for R1 and R2 the same for the scaffold and
relu-field branches) and the result line ``{"ok": true, "device":
{...}}``.  Needs no network and no JAX.

``--ablate`` builds variants of the kernels with parts switched off (the
``LIGHTPLANE_ABLATE`` bits of ``csrc/march_common.cuh``), one build each,
all started together, and times each twice in turn: R2 at the slice shape,
S1 at the splatter headline.
"""

import copy
import gc
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

# H100 SXM peaks (NVIDIA's data sheet): FP32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

IMAGE = 256
SLICE = dict(
    num_samples=256, color_chn=3, grid_chn=32, mlp_hidden_chn=32,
    mlp_n_layers_trunk=2, mlp_n_layers_opacity=2, mlp_n_layers_color=2,
    opacity_init_bias=-2.0, ray_embedding_num_harmonics=3, bg_color=1.0,
)


# the parity configs of phases 3 and 3b: (name, random_case kwargs,
# renderer kwargs); voxel64_32ch is the 64^3 x 32ch grid beyond a TPU's VMEM
_TRI = [(1, 1, 32, 32, 32), (1, 32, 1, 32, 32), (1, 32, 32, 1, 32)]


def _tri16(res):
    return [(1, 1, res, res, 16), (1, res, 1, res, 16), (1, res, res, 1, 16)]


PARITY_CASES = [
    ("triplane", dict(grid_shapes=_TRI), {}),
    ("voxel_batch2", dict(grid_shapes=[(2, 16, 16, 16, 16)], batch=2), {}),
    ("voxel_plane_mask",
     dict(grid_shapes=[(1, 16, 16, 16, 16), (1, 1, 24, 20, 16)]),
     dict(mask_out_of_bounds_samples=True)),
    ("contract", dict(grid_shapes=_TRI), dict(contract_coords=True)),
    ("noise", dict(grid_shapes=_TRI),
     dict(inject_noise_sigma=1.0, inject_noise_seed=3)),
    ("samples_inf8", dict(grid_shapes=_TRI),
     dict(num_samples_inf=8, disparity_at_inf=1e-3)),
    ("mlp_1_3_2_h64",
     dict(grid_shapes=[(1, 16, 16, 16, 16)], hidden=64, layers=(1, 3, 2)),
     {}),
    ("mlp_0_1_3",
     dict(grid_shapes=[(1, 16, 16, 16, 32)], layers=(0, 1, 3)), {}),
    ("voxel64_32ch", dict(grid_shapes=[(1, 64, 64, 64, 32)]), {}),
    # the big shapes of tests/test_pallas_interpret.py::
    # test_w3_big_shapes_match_scan, which the TPU's W3 sampler (R4) served
    ("w3_triplane128", dict(grid_shapes=_tri16(128), hidden=16), {}),
    ("w3_batched", dict(grid_shapes=[(2, 32, 32, 32, 16)], hidden=16,
                        batch=2, grid_idx=1), {}),
    ("w3_contracted", dict(grid_shapes=[(1, 32, 32, 32, 16)], hidden=16),
     dict(contract_coords=True)),
    ("w3_triplane100", dict(grid_shapes=_tri16(100), hidden=16), {}),
    ("w3_pyramid", dict(grid_shapes=[(1, 8, 8, 8, 16), (1, 24, 24, 24, 16)],
                        hidden=16), {}),
]


def compare(name, x, y, max_abs=KERNEL_MAX_ABS, magnitude_scaled=False,
            max_rel=None):
    """Assert the compare_one bounds and ``max |x - y| <= max_abs`` (both
    absolute bounds scaled by the data's magnitude when asked), or, given
    ``max_rel``, ``max |x - y| <= max_rel * max |y|``; returns (max |diff|,
    mean |diff|)."""
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
    if max_rel is None:
        assert mx <= max_abs * scale_max, f"{name}: max |diff| {mx}"
    else:
        limit = max_rel * float(np.abs(y).max())
        assert mx <= limit, f"{name}: max |diff| {mx} > {limit}"
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
                batch=1, grid_idx=None, relu_field=False):
    """Rays aimed from a shell at z=-2 toward the origin (every ray on batch
    ``grid_idx`` when given), a random grid-list and a decoder (with
    ``relu_field``, the separate colour grid's, with no trunk), all made
    from ``rng`` on the card."""
    dev = "cuda"
    origins = rng.standard_normal((n_rays, 3)) / 3.0 + np.array([0, 0, -2.0])
    targets = rng.standard_normal((n_rays, 3)) * 0.2
    near = 0.1 + 0.05 * rng.random(n_rays)
    far = 3.0 + 0.2 * rng.random(n_rays)
    idx = rng.integers(0, batch, n_rays)
    if grid_idx is not None:
        idx = np.full(n_rays, grid_idx)
    chn = grid_shapes[0][-1]
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    dp = lp.init_decoder_params(
        gen, n_layers_trunk=layers[0], n_layers_opacity=layers[1],
        n_layers_color=layers[2], input_chn=chn, hidden_chn=hidden,
        color_chn=3, opacity_init_bias=-1.0,
        use_separate_color_grid=relu_field, device=dev,
    )
    enc = rng.standard_normal((n_rays, dp.n_hidden_color[0])) * 0.1

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    rays = lp.Rays(
        directions=t(targets - origins), origins=t(origins),
        grid_idx=t(idx, torch.int64), near=t(near), far=t(far),
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

    worst = 0.0
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for name, case_kw, render_kw in PARITY_CASES:
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
                cfg, geom, diff = unsplit_march(lp, rmod, rays, grid, dp,
                                                **kw)
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
    base = torch.cuda.memory_allocated()

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
    print(f"  peak allocated while serving: {peak} bytes, {peak - base} "
          f"above the {base} held before it  [{smi}]")
    return dict(
        name="renderer_fw", route="cuda",
        source="lightplane_tpu_torch/csrc/renderer_fw.cu",
        replaces="lightplane_tpu/ops/kernels/renderer_pallas.py:2073",
        launches=launches, max_abs_err=max(errs), ms=kernel_ms,
        plain_ms=plain_ms,
    )


def held_memory():
    """Print what the phases before serving leave allocated, and free
    cuBLAS's workspaces (allocated by PyTorch, held after a matrix product)
    so that serving's peak counts serving's own."""
    print("== memory held after phases 1-3b")
    gc.collect()
    torch.cuda.synchronize()
    print(f"  {torch.cuda.memory_allocated()} bytes allocated")
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
        print(f"  {torch.cuda.memory_allocated()} bytes after freeing "
              f"cuBLAS's workspaces")


def unsplit_march(lp, rmod, rays, grid, dp, color_grid=None, **kw):
    """``(cfg, geom, diff)`` of the whole march, background samples
    included, as ``lightplane_renderer(rays, grid, dp, **kw)`` builds them
    and one kernel launch runs it."""
    grid_flat, cgrid_flat, sizes, csizes = lp.process_and_flatten_grid(
        grid, color_grid)
    return rmod._march_inputs(rays, grid_flat, cgrid_flat, sizes, csizes, dp,
                              **kw)


def slice_march(lp, rmod, module, grid, rays):
    """``(cfg, geom, diff)`` of ``module``'s march over ``rays`` in their
    order, with its ray embedding, as its forward hands them to R1."""
    with torch.no_grad():
        enc = module._get_ray_embedding(rays.directions)
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    m = module
    return unsplit_march(
        lp, rmod, rays, [g.detach() for g in grid], m.get_decoder_params(),
        num_samples=m.num_samples, gain=m.gain,
        num_samples_inf=m.num_samples_inf,
        mask_out_of_bounds_samples=m.mask_out_of_bounds_samples,
        contract_coords=m.contract_coords, disparity_at_inf=m.disparity_at_inf,
    )


def kernel_work(rmod, cfg, geom, diff):
    """(FLOPs, bytes) the forward and the backward kernel must do on these
    inputs: decoder multiply-adds per ray-sample (each layer's real width,
    the heads' last layers only the outputs used), times 1 forward, times 3
    backward (recompute, input gradients, weight gradients); plus C
    multiply-adds for every in-bounds sampling corner of this run's points,
    of the grid-list and the colour grid-list (once forward, twice
    backward: sample and splat).  With a scaffold only the samples whose
    gate is not 0 count: the others change nothing.  Bytes: every input
    read once and every output written once."""
    from lightplane_tpu_torch.ops.grid_sample import sample_grid_rep

    directions, origins, near, far, grid_idx, scaffold = geom[:6]
    grid_flat, cgrid_flat, mlp, _ = diff
    mlp_numel = mlp.numel()
    R = directions.shape[0]
    C = grid_flat.shape[1]
    color_chn = cfg.out_chn
    macs = 0
    for m, widths in enumerate((cfg.n_hidden_trunk, cfg.n_hidden_opacity,
                                cfg.n_hidden_color)):
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            # the colour head's last layer computes the rendered channels
            last_color = m == 2 and i == len(widths) - 2
            macs += a * (color_chn if last_color else b)
    corners = samples = 0
    all_sizes = cfg.grid_sizes + (cfg.color_grid_sizes or ())
    with torch.no_grad():
        for s in range(cfg.tot_num_samples):
            t, _ = rmod._step_depth_delta(cfg, near, far, s)
            pts = rmod._step_points(cfg, origins, directions, t)
            occupied = torch.ones_like(t)
            if scaffold is not None:
                occupied = (sample_grid_rep(
                    scaffold, (cfg.scaffold_size + (1,),), pts, grid_idx,
                    True, mode="nearest")[:, 0] != 0).float()
            samples += float(occupied.sum())
            keep = occupied
            if cfg.mask_out_of_bounds_samples:
                keep = keep * (pts.abs() <= 1.0).all(-1).float()
            for _, D, H, W, _ in all_sizes:
                n = keep
                for k, size in enumerate((W, H, D)):
                    if size == 1:
                        continue
                    f0 = torch.floor(((pts[:, k] + 1.0) * 0.5) * size - 0.5)
                    n = n * (((f0 >= 0) & (f0 < size)).float()
                             + ((f0 >= -1) & (f0 < size - 1)).float())
                corners += float(n.sum())
    flops_fw = 2.0 * (samples * macs + corners * C)
    flops_bw = 2.0 * (3 * samples * macs + 2 * corners * C)
    rays_bytes = 4 * R * (3 + 3 + 1 + 1 + 1 + cfg.n_hidden_color[0])
    params_bytes = 4 * (grid_flat.numel() + mlp_numel)
    if cgrid_flat is not None:
        params_bytes += 4 * cgrid_flat.numel()
    if scaffold is not None:
        rays_bytes += 4 * scaffold.numel()
    bytes_fw = rays_bytes + params_bytes + 4 * R * (2 + color_chn)
    # + nlt and the cotangents in, the gradients of the grid, the MLP and
    # the encodings out
    bytes_bw = (rays_bytes + params_bytes + 4 * R * (3 + color_chn)
                + params_bytes + 4 * R * cfg.n_hidden_color[0])
    return (flops_fw, bytes_fw), (flops_bw, bytes_bw)


def bound(flops, nbytes):
    """The least milliseconds the card could take, and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def projected_grads(lp, rays, grid, dp, impl, proj, naive=False, **kw):
    """Gradients of ``sum(proj * outputs)`` w.r.t. the grid-list,
    ``mlp_params``, ``rays.encoding`` and the colour grid-list (if
    ``kw`` has one)."""
    cgrid = [g.detach().clone().requires_grad_(True)
             for g in kw.get("color_grid") or []]
    if cgrid:
        kw = dict(kw, color_grid=cgrid)
    grid = [g.detach().clone().requires_grad_(True) for g in grid]
    mlp = dp.mlp_params.detach().clone().requires_grad_(True)
    enc = rays.encoding.detach().clone().requires_grad_(True)
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    dp = lp.DecoderParams(mlp, dp.n_hidden_trunk, dp.n_hidden_opacity,
                          dp.n_hidden_color, dp.color_chn)
    if naive:
        out = lp.lightplane_renderer_naive(rays, grid, dp, **kw)
    else:
        out = lp.lightplane_renderer(rays, grid, dp, impl=impl, **kw)
    sum((o * p).sum() for o, p in zip(out, proj)).backward()
    return [g.grad for g in grid] + [mlp.grad, enc.grad] + [g.grad
                                                            for g in cgrid]


def as_f64(lp, rays, grid, dp, proj):
    """The same inputs in float64, for the plain version's reference run."""
    d = torch.float64
    rays = lp.Rays(rays.directions.to(d), rays.origins.to(d), rays.grid_idx,
                   rays.near.to(d), rays.far.to(d), rays.encoding.to(d))
    dp = lp.DecoderParams(dp.mlp_params.to(d), dp.n_hidden_trunk,
                          dp.n_hidden_opacity, dp.n_hidden_color,
                          dp.color_chn)
    return rays, [g.to(d) for g in grid], dp, [p.to(d) for p in proj]


def kw_f64(kw):
    """Renderer keyword arguments with their scaffold and colour grid-list
    in float64."""
    d = torch.float64
    out = dict(kw)
    if kw.get("scaffold") is not None:
        out["scaffold"] = kw["scaffold"].to(d)
    if kw.get("color_grid") is not None:
        out["color_grid"] = [g.to(d) for g in kw["color_grid"]]
    return out


# The kernel and its plain version differ only in f32 rounding, but the
# gradient of a relu MLP jumps where a pre-activation crosses 0: at a
# pre-activation within rounding of 0, two f32 evaluations may take opposite
# sides and a gradient moves by a whole term, up to several 1e-3 x max |g|
# at these shapes (kink_check prints it).  So the configs give no
# cotangent to the rays that come within KINK_MARGIN of a kink (measured in
# f64, relative to the pre-activation's terms; f32 rounding is ~1e-7 of
# them), and hold the kernel within compare_one's bounds and max |d| <=
# 1e-3 x max |g| of each gradient: no floor of 1, so stricter than 1e-3 x
# max(1, max |g|).
GRAD_MAX_REL = 1e-3
KINK_MARGIN = 1e-5


def grad_compare(names, got, plain, ref, magnitude_scaled=False):
    """Hold ``got`` against ``plain`` within compare_one's bounds and
    GRAD_MAX_REL, and print both against ``ref``, ``plain``'s f64 run;
    returns the worst max |got - plain|."""
    worst = 0.0
    for name, a, b, r in zip(names, got, plain, ref):
        r = r.detach().double()
        e_a = float((a.detach().double() - r).abs().max())
        e_b = float((b.detach().double() - r).abs().max())
        mx, _ = compare(name, a, b, magnitude_scaled=magnitude_scaled,
                        max_rel=GRAD_MAX_REL)
        worst = max(worst, mx)
        print(f"           max|g| {float(r.abs().max()):.3e}, max|d| from "
              f"f64: {e_a:.3e} and {e_b:.3e}")
    return worst


def kink_margin(rmod, cfg, geom, diff, colour_only=False):
    """Per ray, the smallest |x| / sum |terms of x| over the march of every
    x that goes through a relu of the decoder (only the colour MLP's with
    ``colour_only``, the ones the encoding gradient sees)."""
    from lightplane_tpu_torch.ops.grid_sample import sample_grid_rep
    from lightplane_tpu_torch.ops.mlp_utils import (
        flattened_decoder_params_to_list,
    )

    directions, origins, near, far, grid_idx = geom[:5]
    grid_flat, cgrid_flat, mlp, enc = diff
    w_t, b_t, w_o, b_o, w_c, b_c = flattened_decoder_params_to_list(
        mlp, cfg.n_hidden_trunk, cfg.n_hidden_opacity, cfg.n_hidden_color)
    margin = torch.full_like(near, float("inf"))

    def relu(x, terms, seen=True):
        """relu(x), noting how near x comes to 0 against its terms."""
        nonlocal margin
        if seen:
            ratio = torch.where(terms > 0, x.abs() / terms, float("inf"))
            margin = torch.minimum(margin, ratio.amin(-1))
        return torch.relu(x)

    def dense(x, w, b):
        return x @ w + b, x.abs() @ w.abs() + b.abs()

    rest = not colour_only
    for s in range(cfg.tot_num_samples):
        t, _ = rmod._step_depth_delta(cfg, near, far, s)
        pts = rmod._step_points(cfg, origins, directions, t)
        mask = cfg.mask_out_of_bounds_samples
        x = sample_grid_rep(grid_flat, cfg.grid_sizes, pts, grid_idx, mask)
        terms = sample_grid_rep(grid_flat.abs(), cfg.grid_sizes, pts,
                                grid_idx, mask)
        for w, b in zip(w_t, b_t):
            x = relu(*dense(x, w, b), rest)
            terms = x
        trunk = x = relu(x, terms, rest)  # the feature's, with no trunk MLP
        if cgrid_flat is not None:
            # relu-field: relu of the colour grid sample feeds the colour head
            trunk = relu(
                sample_grid_rep(cgrid_flat, cfg.color_grid_sizes, pts,
                                grid_idx, mask),
                sample_grid_rep(cgrid_flat.abs(), cfg.color_grid_sizes, pts,
                                grid_idx, mask))
        for w, b in zip(w_o[:-1], b_o[:-1]):
            x = relu(*dense(x, w, b), rest)
        x = trunk + enc
        for w, b in zip(w_c[:-1], b_c[:-1]):
            x = relu(*dense(x, w, b))
    return margin


def kink_check(lp, rmod, rng):
    """The triplane config with every ray's cotangent: each f32 version's
    encoding gradient against the f64 run, and how near the ray where each
    is farthest from it comes to a kink of the colour MLP."""
    rays, grid, dp = random_case(lp, rng, 4096, grid_shapes=_TRI)
    kw = dict(num_samples=48, gain=1.5)
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    n = len(rays)
    proj = [torch.randn(s, generator=gen).cuda() for s in [(n,), (n,), (n, 3)]]
    g_k = projected_grads(lp, rays, grid, dp, "cuda", proj, **kw)[-1]
    g_p = projected_grads(lp, rays, grid, dp, "torch", proj, **kw)[-1]
    rays64, grid64, dp64, proj64 = as_f64(lp, rays, grid, dp, proj)
    g_r = projected_grads(lp, rays64, grid64, dp64, "torch", proj64, **kw)[-1]
    with torch.no_grad():
        margin = kink_margin(rmod, *unsplit_march(lp, rmod, rays64, grid64,
                                                  dp64, **kw),
                             colour_only=True)
    print("  triplane, every ray's cotangent: g_enc of each f32 version "
          "against the f64 run, and the colour MLP's kink margin of its "
          "worst ray")
    print(f"    kink margin over all {n} rays: median "
          f"{float(margin.median()):.2e}; {int((margin < KINK_MARGIN).sum())}"
          f" rays under {KINK_MARGIN:g}")
    for label, g in (("kernel", g_k), ("plain", g_p)):
        err = (g.double() - g_r).abs().amax(-1)
        i = int(err.argmax())
        print(f"    {label:6s} max|d| {float(err[i]):.3e} at ray {i}, kink "
              f"margin {float(margin[i]):.2e}")


def phase_backward_parity(lp):
    print("== phase 3b: backward kernel vs plain PyTorch version on the card")
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    worst = 0.0
    rng = np.random.default_rng(1)
    kink_check(lp, rmod, rng)
    print(f"  the {len(PARITY_CASES)} configs; rays within {KINK_MARGIN:g} of "
          f"a relu kink "
          f"get no cotangent:")
    for name, case_kw, render_kw in PARITY_CASES:
        rays, grid, dp = random_case(lp, rng, 4096, **case_kw)
        kw = dict(num_samples=48, gain=1.5, **render_kw)
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        n = len(rays)
        proj = [torch.randn(s, generator=gen).cuda()
                for s in [(n,), (n,), (n, 3)]]
        rays64, grid64, dp64, _ = as_f64(lp, rays, grid, dp, proj)
        with torch.no_grad():
            keep = kink_margin(rmod, *unsplit_march(
                lp, rmod, rays64, grid64, dp64, **kw)) >= KINK_MARGIN
        w = keep.float()
        proj = [p * (w if p.dim() == 1 else w[:, None]) for p in proj]
        proj64 = [p.double() for p in proj]
        before = rbw.LAUNCHES
        g_k = projected_grads(lp, rays, grid, dp, "cuda", proj, **kw)
        torch.cuda.synchronize()
        assert rbw.LAUNCHES == before + 1, "the backward kernel did not run"
        g_p = projected_grads(lp, rays, grid, dp, "torch", proj, **kw)
        g_r = projected_grads(lp, rays64, grid64, dp64, "torch", proj64, **kw)
        names = [f"g_grid{i}" for i in range(len(grid))] + ["g_mlp", "g_enc"]
        print(f"  {name}: {render_kw or ''} ({n - int(keep.sum())} of {n} "
              f"rays without a cotangent)")
        # background samples put gradients at O(1/disparity): compare_one's
        # absolute bounds scale with them, as in the JAX parity tests
        scaled = "num_samples_inf" in render_kw
        worst = max(worst, grad_compare(names, g_k, g_p, g_r, scaled))
        if name == "triplane":
            g_n = projected_grads(lp, rays, grid, dp, None, proj, naive=True,
                                  **kw)
            g_nr = projected_grads(lp, rays64, grid64, dp64, None, proj64,
                                   naive=True, **kw)
            print("  triplane, the kernels vs autograd of the naive renderer "
                  "(f64: the naive renderer's):")
            grad_compare(names, g_k, g_n, g_nr)
        if scaled:
            cfg, geom, diff = unsplit_march(lp, rmod, rays, grid, dp, **kw)
            cfg64, geom64, diff64 = unsplit_march(lp, rmod, rays64, grid64,
                                                  dp64, **kw)
            with torch.no_grad():
                nlt = rfw.render_fwd_torch(cfg, geom, diff)[1]
                nlt64 = rfw.render_fwd_torch(cfg64, geom64, diff64)[1]
                g_out = (proj[0], proj[1], proj[2].contiguous())
                print("  samples_inf8, unsplit march in one kernel launch:")
                g_u = rbw.render_bwd_cuda(cfg, geom, diff, nlt, g_out)
                g_v = rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
                g_w = rbw.render_bwd_torch(cfg64, geom64, diff64, nlt64,
                                           tuple(g.double() for g in g_out))
            pick = (0, 2, 3)
            grad_compare(("g_grid", "g_mlp", "g_enc"), [g_u[i] for i in pick],
                         [g_v[i] for i in pick], [g_w[i] for i in pick],
                         magnitude_scaled=True)
    print(f"  all configs within bounds; worst max|d| {worst:.3e}")


def gate_boundary_count(rmod, cfg, geom):
    """How many (ray, step) gates of the scaffold sit within 1e-6 (in
    cells) of a half-cell rounding boundary, where an ulp of the point would
    flip the nearest cell."""
    directions, origins, near, far = geom[:4]
    _, D, H, W = cfg.scaffold_size
    n = 0
    with torch.no_grad():
        for s in range(cfg.tot_num_samples):
            t, _ = rmod._step_depth_delta(cfg, near, far, s)
            pts = rmod._step_points(cfg, origins, directions, t)
            near_edge = torch.zeros_like(t, dtype=torch.bool)
            for k, size in enumerate((W, H, D)):
                if size > 1:
                    f = ((pts[:, k] + 1.0) * 0.5) * size - 0.5
                    near_edge |= (f - torch.floor(f) - 0.5).abs() < 1e-6
            n += int(near_edge.sum())
    return n


def branch_cases(lp, rng):
    """Phase 3c's configs: (name, rays, grid, decoder, renderer kwargs)."""
    cases = []
    for name in ("random", "empty", "halfz"):
        rays, grid, dp = random_case(lp, rng, 4096, grid_shapes=_TRI)
        sc = (torch.rand((1, 24, 20, 28), generator=torch.Generator()
                         .manual_seed(int(rng.integers(1 << 30)))) > 0.5)
        sc = sc.float().cuda()
        if name == "empty":
            sc.zero_()
        elif name == "halfz":
            sc[:, 12:] = 0.0
        cases.append((f"scaffold_{name}", rays, grid, dp, dict(scaffold=sc)))
    # a scaffold from calculate_scaffold at 64^3 over the config's own
    # decoder and grid: the top 5% of the dense opacity, dilated by one cell
    rays, grid, dp = random_case(lp, rng, 4096, grid_shapes=_TRI)
    module = lp.LightplaneRenderer(
        num_samples=48, color_chn=3, grid_chn=32, mlp_hidden_chn=32,
        opacity_init_bias=-1.0, gain=1.5, device="cuda")
    with torch.no_grad():
        module.mlp_params.copy_(dp.mlp_params)
        pts = torch.rand((64, 4096, 3), generator=torch.Generator()
                         .manual_seed(3)).cuda() * 2.0 - 1.0
        op = module.eval_opacity_at_points(pts, torch.zeros(
            64, dtype=torch.int64, device="cuda"), grid)
        threshold = float(torch.quantile(op.flatten(), 0.95))
    sc = module.calculate_scaffold(grid, (1, 64, 64, 64), threshold=threshold,
                                   dilate_scaffold=1)
    cases.append(("scaffold_calculated_64", rays, grid, dp,
                  dict(scaffold=sc, contract_coords=True)))
    # the relu-field: a density and a colour triplane, no trunk MLP
    for name, extra in (("relu_field", {}),
                        ("relu_field_scaffold_mask",
                         dict(mask_out_of_bounds_samples=True))):
        rays, grid, dp = random_case(lp, rng, 4096, grid_shapes=_TRI,
                                     layers=(0, 2, 2), relu_field=True)
        cgrid = [torch.as_tensor(rng.standard_normal(s) * 0.5,
                                 dtype=torch.float32, device="cuda")
                 for s in _TRI]
        kw = dict(color_grid=cgrid, **extra)
        if extra:
            kw["scaffold"] = (torch.rand((1, 32, 32, 32), generator=torch
                                         .Generator().manual_seed(5)) > 0.3
                              ).float().cuda()
        cases.append((name, rays, grid, dp, kw))
    return cases


def phase_branch_parity(lp):
    print("== phase 3c: scaffold gating (R3) and the relu-field colour grid "
          "(R1-rf) in R1 and R2 vs their plain versions on the card")
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    rng = np.random.default_rng(31)
    errs = {"scaffold": [0.0, 0.0], "relu_field": [0.0, 0.0]}
    for name, rays, grid, dp, extra in branch_cases(lp, rng):
        kw = dict(num_samples=48, gain=1.5, **extra)
        kind = "relu_field" if "color_grid" in extra else "scaffold"
        cfg, geom, diff = unsplit_march(lp, rmod, rays, grid, dp, **kw)
        line = f"  {name}:"
        if cfg.scaffold_size is not None:
            occ = float(extra["scaffold"].mean())
            line += (f" scaffold {cfg.scaffold_size}, occupancy {occ:.3f}; "
                     f"{gate_boundary_count(rmod, cfg, geom)} of "
                     f"{len(rays) * cfg.tot_num_samples} (ray, step) gates "
                     f"within 1e-6 of a rounding boundary")
        print(line)
        with torch.no_grad():
            fw0 = rfw.LAUNCHES
            out_k = lp.lightplane_renderer(rays, grid, dp, impl="cuda", **kw)
            torch.cuda.synchronize()
            assert rfw.LAUNCHES == fw0 + 1, "the forward kernel did not run"
            out_p = lp.lightplane_renderer(rays, grid, dp, impl="torch", **kw)
        for label, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
            errs[kind][0] = max(errs[kind][0], compare(label, a, b)[0])
        # gradients on cotangents that skip the rays near a relu kink
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        n = len(rays)
        proj = [torch.randn(s, generator=gen).cuda()
                for s in [(n,), (n,), (n, 3)]]
        rays64, grid64, dp64, _ = as_f64(lp, rays, grid, dp, proj)
        kw64 = kw_f64(kw)
        with torch.no_grad():
            keep = kink_margin(rmod, *unsplit_march(
                lp, rmod, rays64, grid64, dp64, **kw64)) >= KINK_MARGIN
        w = keep.float()
        proj = [p * (w if p.dim() == 1 else w[:, None]) for p in proj]
        proj64 = [p.double() for p in proj]
        bw0 = rbw.LAUNCHES
        g_k = projected_grads(lp, rays, grid, dp, "cuda", proj, **kw)
        torch.cuda.synchronize()
        assert rbw.LAUNCHES == bw0 + 1, "the backward kernel did not run"
        g_p = projected_grads(lp, rays, grid, dp, "torch", proj, **kw)
        g_r = projected_grads(lp, rays64, grid64, dp64, "torch", proj64,
                              **kw64)
        names = ([f"g_grid{i}" for i in range(len(grid))] + ["g_mlp", "g_enc"]
                 + [f"g_cgrid{i}" for i in range(len(extra.get("color_grid")
                                                     or []))])
        print(f"    gradients ({n - int(keep.sum())} of {n} rays within "
              f"{KINK_MARGIN:g} of a relu kink get no cotangent):")
        errs[kind][1] = max(errs[kind][1],
                            grad_compare(names, g_k, g_p, g_r))
        if name == "scaffold_empty":
            assert all(float(x.abs().max()) == 0.0 for x in out_k + tuple(g_k))
        else:
            assert float(out_k[1].abs().max()) > 0.0
    print(f"  all configs within bounds; worst max|d| (R1, R2): {errs}")
    return errs


def phase_training(lp, smi):
    print("== phase 5: training, 12 Adam steps of 256x256 rays x 256 samples")
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.utils import grid_utils

    dev = "cuda"
    res, chn = 32, SLICE["grid_chn"]
    image_size = (IMAGE, IMAGE)

    def model(seed):
        gen = torch.Generator().manual_seed(seed)
        module = lp.LightplaneRenderer(generator=gen, device=dev, **SLICE)
        grid = grid_utils.init_3d_representation(gen, "triplane", res, chn,
                                                 device=dev)
        return module, grid

    teacher, teacher_grid = model(1)
    poses = [orbit_rays(lp, a, dev) for a in np.arange(4) * np.pi / 2]
    with torch.inference_mode():
        targets = [teacher(r, teacher_grid, image_size=image_size)[2]
                   for r in poses]
    student, grid = model(0)
    grid = [torch.nn.Parameter(g) for g in grid]
    emb = student.harmonic_ray_embedding_linear
    opt = torch.optim.Adam([
        {"params": grid, "lr": 5e-2},
        {"params": list(student.parameters()), "lr": 5e-3},
    ])
    torch.cuda.synchronize()

    losses, step_ms = [], []
    rfw.LAUNCHES = rbw.LAUNCHES = 0
    for step in range(12):
        i = step % len(poses)
        before = rbw.LAUNCHES
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad(set_to_none=True)
        # the fit example's loss: MSE + 1e-3 * TV
        _, _, rgb = student(poses[i], grid, image_size=image_size)
        loss = (torch.mean((rgb - targets[i]) ** 2)
                + 1e-3 * grid_utils.grid_tv_loss(grid))
        loss.backward()
        opt.step()
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        assert rbw.LAUNCHES == before + 1, "one backward launch per step"
        for name, g in [(f"grid{k}", p.grad) for k, p in enumerate(grid)] + [
            ("mlp_params", student.mlp_params.grad),
            ("embedding.weight", emb.weight.grad),
        ]:
            assert g is not None and torch.isfinite(g).all(), name
            assert float(g.abs().sum()) > 0.0, f"{name}: zero gradient"
        losses.append(loss.item())
    launches = {"renderer_fw": rfw.LAUNCHES, "renderer_bw": rbw.LAUNCHES}
    print(f"  losses {[round(v, 6) for v in losses]}")
    print(f"  kernel launches on the training path: {launches}")
    assert launches == {"renderer_fw": 12, "renderer_bw": 12}, launches
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    print(f"  mean loss, first 4 steps {first:.6f}, last 4 steps {last:.6f}")
    assert last < first, "the loss did not fall"
    module_step_ms = statistics.median(step_ms[1:])
    print(f"  module training step (fw + bw + Adam): median "
          f"{module_step_ms:.3f} ms over steps 2-12  [{smi}]")

    # the functional renderer's fw+bw step at the bench shape, on the
    # inputs that the module's forward hands to the kernels
    r0 = poses[0]
    cfg, geom, diff = slice_march(lp, rmod, student, grid, r0)
    diff = tuple(None if x is None else x.detach() for x in diff)
    grid_flat, _, mlp, enc0 = diff
    dp = student.get_decoder_params()
    gen = torch.Generator().manual_seed(5)
    n = len(r0)
    proj = [torch.randn(s, generator=gen).to(dev)
            for s in [(n,), (n,), (n, 3)]]
    rays_enc = lp.Rays(r0.directions, r0.origins, r0.grid_idx, r0.near,
                       r0.far, enc0)

    def fw_bw(impl="cuda", num_samples=SLICE["num_samples"]):
        return projected_grads(lp, rays_enc, [g.detach() for g in grid], dp,
                               impl, proj, num_samples=num_samples,
                               gain=student.gain)

    step = cuda_ms(fw_bw, warmup=2, reps=7)
    print(f"  fw+bw step of lightplane_renderer through R1 + R2: median "
          f"{step:.3f} ms, {n / step * 1e3:.0f} rays/s  [{smi}]")
    t0 = time.perf_counter()
    fw_bw("torch")
    torch.cuda.synchronize()
    plain_step = 1e3 * (time.perf_counter() - t0)
    print(f"  fw+bw step through the plain versions: {plain_step:.1f} ms "
          f"(one run)  [{smi}]")

    peaks = {}
    for ns in (128, 256):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fw_bw(num_samples=ns)
        torch.cuda.synchronize()
        peaks[ns] = torch.cuda.max_memory_allocated()
        print(f"  peak allocated, fw+bw step at {ns} samples: {peaks[ns]} "
              f"bytes ({(peaks[ns] - base) / 2**20:.1f} MiB above the "
              f"{base / 2**20:.1f} MiB held before it)  [{smi}]")
    assert peaks[256] <= 1.05 * peaks[128], peaks

    # each kernel on its own at the slice shape, against its plain version
    # (and the plain version's f64 run, for the record)
    f64 = torch.float64
    geom64 = tuple(x.to(f64) if torch.is_tensor(x) and x.is_floating_point()
                   else x for x in geom)
    diff64 = tuple(None if x is None else x.to(f64) for x in diff)
    with torch.no_grad():
        _, nlt, _ = rfw.render_fwd_cuda(cfg, geom, diff)
        g_out = tuple(p.contiguous() for p in proj)
        bw_ms = cuda_ms(lambda: rbw.render_bwd_cuda(cfg, geom, diff, nlt,
                                                    g_out))
        fw_ms = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff))
        # compared on cotangents that skip the rays near a relu kink, as in
        # phase 3b
        keep = kink_margin(rmod, cfg, geom64, diff64) >= KINK_MARGIN
        w = keep.float()
        g_out = (g_out[0] * w, g_out[1] * w, g_out[2] * w[:, None])
        g_k = rbw.render_bwd_cuda(cfg, geom, diff, nlt, g_out)
        t0 = time.perf_counter()
        g_p = rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
        torch.cuda.synchronize()
        bw_plain_ms = 1e3 * (time.perf_counter() - t0)
        nlt64 = rfw.render_fwd_torch(cfg, geom64, diff64)[1]
        g_r = rbw.render_bwd_torch(cfg, geom64, diff64, nlt64,
                                   tuple(g.to(f64) for g in g_out))
    print(f"  R2 alone: median {bw_ms:.3f} ms; its plain version "
          f"{bw_plain_ms:.1f} ms (one run); R1 alone: median {fw_ms:.3f} ms"
          f"  [{smi}]")
    print(f"  R2 vs its plain version at the slice shape (the module's "
          f"decoder after 12 steps; {n - int(keep.sum())} of {n} rays within "
          f"{KINK_MARGIN:g} of a relu kink get no cotangent):")
    pick = (0, 2, 3)
    bw_err = grad_compare(("g_grid", "g_mlp", "g_enc"), [g_k[i] for i in pick],
                          [g_p[i] for i in pick], [g_r[i] for i in pick])

    (fl_fw, by_fw), (fl_bw, by_bw) = kernel_work(rmod, cfg, geom, diff)
    b_fw, by_fw_kind = bound(fl_fw, by_fw)
    b_bw, by_bw_kind = bound(fl_bw, by_bw)
    print(f"  work: R1 {fl_fw / 1e9:.1f} GFLOP, {by_fw / 1e6:.2f} MB -> bound "
          f"{b_fw:.3f} ms ({by_fw_kind}); R2 {fl_bw / 1e9:.1f} GFLOP, "
          f"{by_bw / 1e6:.2f} MB -> bound {b_bw:.3f} ms ({by_bw_kind})")
    print(f"  R2 at {fl_bw / bw_ms / 1e9:.2f} TFLOP/s, "
          f"{100 * b_bw / bw_ms:.1f}% of its bound  [{smi}]")
    return launches, dict(fw_bound=(b_fw, by_fw_kind),
                          bw=dict(ms=bw_ms, plain_ms=bw_plain_ms,
                                  err=bw_err, bound=(b_bw, by_bw_kind)))


# ---- the splatter (phases 6-8) ------------------------------------------

# bench.py's splatter headline (bench.py:328-357): 16 views of 128^2 rays,
# 96 samples, one 160^3 x 64ch voxel grid
SPLAT_VIEWS, SPLAT_VIEW_RES, SPLAT_SAMPLES = 16, 128, 96
SPLAT_VOXEL = (1, 160, 160, 160, 64)
# the splatter's kernels against their plain versions: compare_one's bounds
# and max |d| <= 1e-3 x max |ref| of each tensor
SPLAT_MAX_REL = 1e-3


def tri_sizes(res, chn, batch=1):
    return [(batch, 1, res, res, chn), (batch, res, 1, res, chn),
            (batch, res, res, 1, chn)]


def view_rays(lp, n_views, size, enc):
    """Raster-order rays of the views of ``sphere_cameras(n_views, 2.5, 25
    deg)``, ``size``^2 pixels each at focal ``size`` x 1.1, near 0.5, far 3.5
    (``benchmarks/splatter_speed.py::make_rays``), on the card, with the
    encoding ``enc``."""
    from lightplane_tpu_torch.utils.cameras import camera_rays, sphere_cameras

    cams = sphere_cameras(n_views, radius=2.5, elevation_deg=25.0)
    o, d = zip(*[camera_rays(c, size, size, size * 1.1, 0.5, 3.5)
                 for c in cams])
    n = len(cams) * size * size

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device="cuda")

    return lp.Rays(directions=t(np.concatenate(d)),
                   origins=t(np.concatenate(o)),
                   grid_idx=t(np.zeros(n), torch.int64),
                   near=t(np.full(n, 0.5)), far=t(np.full(n, 3.5)),
                   encoding=enc)


def splat_case(lp, rng, n_rays, out_sizes, kind="shell", batch=1, mlp=None,
               in_sizes=None):
    """Rays (``shell``: aimed from a shell at z=-2 toward the origin, as
    tests/utils.py::random_rays; ``sorted``: as
    tests/test_splatter_sorted.py; ``view``: one 128^2 camera view), their
    encodings, and with ``mlp = n_hidden`` a splatter MLP and a flat input
    grid-list of ``in_sizes``, all made from ``rng`` on the card."""
    dev = "cuda"

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    enc_chn = mlp[0] if mlp else out_sizes[0][-1]
    enc = t(rng.standard_normal((n_rays, enc_chn)) * 0.1)
    if kind == "view":
        rays = view_rays(lp, 1, SPLAT_VIEW_RES, enc)
    else:
        origins = rng.standard_normal((n_rays, 3)) / 3.0
        if kind == "shell":
            origins = origins + np.array([0.0, 0.0, -2.0])
            d = rng.standard_normal((n_rays, 3)) * 0.2 - origins
            near = 0.1 + 0.05 * rng.random(n_rays)
            far = 3.0 + 0.2 * rng.random(n_rays)
        else:
            d = rng.standard_normal((n_rays, 3)) * 0.3 - origins
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            near, far = np.full(n_rays, 0.1), np.full(n_rays, 3.0)
        rays = lp.Rays(directions=t(d), origins=t(origins),
                       grid_idx=t(rng.integers(0, batch, n_rays),
                                  torch.int64),
                       near=t(near), far=t(far), encoding=enc)
    sp = igrid = None
    if mlp:
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        sp = lp.init_splatter_params(gen, len(mlp) - 1, mlp[0], mlp[1],
                                     mlp[-1])
        v_in = sum(int(np.prod(g[:-1])) for g in in_sizes)
        igrid = t(rng.standard_normal((v_in, mlp[0])) * 0.5)
    return rays, sp, igrid


def splat_call(lp, rays, out_sizes, kw, sp, igrid, in_sizes, impl,
               raw=False):
    """``lightplane_splatter_raw`` (``raw``), or the flat normalised grid of
    ``lightplane_splatter`` / ``lightplane_mlp_splatter``."""
    if raw:
        return lp.lightplane_splatter_raw(
            rays, out_sizes, sp, igrid, input_grid_sizes=in_sizes,
            impl=impl, **kw)
    if sp is None:
        return lp.lightplane_splatter(rays, out_sizes, return_list=False,
                                      impl=impl, **kw)
    return lp.lightplane_mlp_splatter(
        rays, out_sizes, sp, igrid, input_grid_sizes=in_sizes,
        return_list=False, impl=impl, **kw)


def splat_grads(lp, rays, out_sizes, kw, sp, igrid, in_sizes, impl, proj):
    """Gradients of ``sum(proj * grid)`` w.r.t. the encoding and, with the
    MLP, the input grid and ``mlp_params``."""
    enc = rays.encoding.detach().clone().requires_grad_(True)
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    leaves = [enc]
    if sp is not None:
        igrid = igrid.detach().clone().requires_grad_(True)
        sp = lp.SplatterParams(
            sp.mlp_params.detach().clone().requires_grad_(True), sp.n_hidden)
        leaves += [igrid, sp.mlp_params]
    out = splat_call(lp, rays, out_sizes, kw, sp, igrid, in_sizes, impl)
    (out * proj).sum().backward()
    return [x.grad for x in leaves]


def splat_kink_margin(rays, sp, igrid, in_sizes, out_sizes, kw):
    """Per ray, in f64, the smallest |x| / sum |terms of x| over the march
    of every pre-activation that goes through a relu of the splatter MLP."""
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.grid_sample import sample_grid_rep
    from lightplane_tpu_torch.ops.mlp_utils import (
        _flattened_one_mlp_params_to_list,
    )

    d = torch.float64
    cfg = smod._SplatCfg(
        kw["num_samples"], kw.get("num_samples_inf", 0),
        kw.get("mask_out_of_bounds_samples", False),
        kw.get("contract_coords", False), kw.get("disparity_at_inf", 1e-5),
        tuple(out_sizes), tuple(in_sizes), sp.n_hidden)
    geom = (rays.directions.to(d), rays.origins.to(d), rays.near.to(d),
            rays.far.to(d), rays.grid_idx)
    enc, grid = rays.encoding.to(d), igrid.to(d)
    ws, bs = _flattened_one_mlp_params_to_list(sp.mlp_params.detach().to(d),
                                               sp.n_hidden)
    margin = torch.full_like(geom[2], float("inf"))
    mask = cfg.mask_out_of_bounds_samples
    with torch.no_grad():
        for s in range(cfg.tot_num_samples):
            pts = smod._march_points(cfg, geom, s)
            x = sample_grid_rep(grid, cfg.input_grid_sizes, pts, geom[4],
                                mask) + enc
            terms = sample_grid_rep(grid.abs(), cfg.input_grid_sizes, pts,
                                    geom[4], mask) + enc.abs()
            for w, b in zip(ws[:-1], bs[:-1]):
                pre = x @ w + b
                terms = terms @ w.abs() + b.abs()
                ratio = torch.where(terms > 0, pre.abs() / terms,
                                    float("inf"))
                margin = torch.minimum(margin, ratio.amin(-1))
                x = terms = torch.relu(pre)
    return margin


def splat_parity(lp, name, rays, out_sizes, kw, sp=None, igrid=None,
                 in_sizes=None, seed=0):
    """Hold S1 and S2 against their plain versions on one config; returns
    the worst max |d| / max |ref|."""
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    n = len(rays)
    if sp is not None:
        keep = splat_kink_margin(rays, sp, igrid, in_sizes, out_sizes,
                                 kw) >= KINK_MARGIN
        rays = rays[keep]
        print(f"  {name}: {kw} ({n - len(rays)} of {n} rays within "
              f"{KINK_MARGIN:g} of a relu kink left out)")
    else:
        print(f"  {name}: {kw}")
    args = (lp, rays, out_sizes, kw, sp, igrid, in_sizes)
    worst = 0.0

    def check(label, a, b):
        nonlocal worst
        mx, _ = compare(label, a, b, max_rel=SPLAT_MAX_REL)
        worst = max(worst, mx / max(float(b.abs().max()), 1e-30))

    with torch.no_grad():
        fw0, bw0 = sfw.LAUNCHES, sbw.LAUNCHES
        feat_k, w_k = splat_call(*args, "cuda", raw=True)
        torch.cuda.synchronize()
        assert sfw.LAUNCHES == fw0 + 1, "the splat kernel did not run"
        feat_p, w_p = splat_call(*args, "torch", raw=True)
        check("feat", feat_k, feat_p)
        check("w", w_k, w_p)
        eps = 1e-5
        check("grid", feat_k / w_k.clamp(min=eps), feat_p / w_p.clamp(min=eps))
    gen = torch.Generator().manual_seed(seed)
    proj = torch.randn(feat_p.shape, generator=gen).cuda()
    g_k = splat_grads(*args, "cuda", proj)
    torch.cuda.synchronize()
    assert sbw.LAUNCHES == bw0 + 1, "the splat adjoint kernel did not run"
    g_p = splat_grads(*args, "torch", proj)
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), g_k, g_p):
        check(label, a, b)
    return worst


def phase_splat_parity(lp):
    print("== phase 6: splatter kernels (S1, S2) vs plain PyTorch versions "
          "on the card")
    rng = np.random.default_rng(6)
    worst = 0.0
    # tests/test_splatter_parity.py's variants at 4096 rays, 32 samples,
    # 16^3 grids; the MLP 8 -> 16 -> 16 as there
    vox, tri = [(2, 16, 16, 16, 16)], tri_sizes(16, 16, batch=2)
    base = dict(num_samples=32)
    variants = [
        ("voxel", vox, {}, None),
        ("triplane", tri, {}, None),
        ("mask", vox, dict(mask_out_of_bounds_samples=True), None),
        ("contract", vox, dict(contract_coords=True), None),
        ("samples_inf3", vox, dict(num_samples_inf=3,
                                   disparity_at_inf=1e-3), None),
        ("rays3", vox, {}, None),
        ("mlp", vox, {}, [(2, 16, 16, 16, 8)]),
        ("mlp_triplane_mask", tri, dict(mask_out_of_bounds_samples=True),
         tri_sizes(16, 8, batch=2)),
    ]
    for name, out_sizes, extra, in_sizes in variants:
        mlp = (8, 16, 16) if in_sizes else None
        n = 3 if name == "rays3" else 4096
        rays, sp, igrid = splat_case(lp, rng, n, out_sizes, batch=2,
                                     mlp=mlp, in_sizes=in_sizes)
        worst = max(worst, splat_parity(lp, name, rays, out_sizes,
                                        dict(base, **extra), sp, igrid,
                                        in_sizes, seed=len(name)))
    # the grid shapes of tests/test_splatter_sorted.py (the TPU's sorted
    # kernel, S4), with its rays, at 4096 rays
    sorted_shapes = [
        ((1, 48, 40, 56, 8), 33, True, False),
        ((1, 40, 36, 44, 4), 17, False, False),
        ((1, 48, 48, 48, 8), 25, True, True),
        ((1, 1, 48, 56, 8), 21, False, False),
        ((1, 40, 1, 56, 8), 21, True, False),
        ((1, 40, 48, 1, 8), 21, False, False),
        ((3, 24, 20, 28, 8), 15, False, False),
        ((2, 1, 48, 40, 4), 15, True, False),
    ]
    for gs, ns, moob, contract in sorted_shapes:
        rays, _, _ = splat_case(lp, rng, 4096, [gs], kind="sorted",
                                batch=gs[0])
        kw = dict(num_samples=ns, mask_out_of_bounds_samples=moob,
                  contract_coords=contract)
        worst = max(worst, splat_parity(lp, f"sorted{gs}", rays, [gs], kw,
                                        seed=ns))
    # one 128^2 camera view into the headline voxel grid (the TPU's big-grid
    # kernels, S3 and S4, served it) and into bench.py's 3 x 128^2 x 32ch
    # lift triplane
    kw = dict(num_samples=SPLAT_SAMPLES)
    for name, out_sizes in (("view_voxel160_64ch", [SPLAT_VOXEL]),
                            ("view_triplane128_32ch", tri_sizes(128, 32))):
        rays, _, _ = splat_case(lp, rng, SPLAT_VIEW_RES ** 2, out_sizes,
                                kind="view")
        worst = max(worst, splat_parity(lp, name, rays, out_sizes, kw))
        gc.collect()
        torch.cuda.empty_cache()
    # phase 7's MLP splatter at its shapes over one view: MLP 32 -> 32 -> 64
    # (the 64-wide builds of S1, S2 and the weight-gradient sum), a 3 x 128^2
    # x 32ch input triplane, the 160^3 x 64ch output grid
    in_sizes = tri_sizes(128, 32)
    rays, sp, igrid = splat_case(lp, rng, SPLAT_VIEW_RES ** 2, [SPLAT_VOXEL],
                                 kind="view", mlp=(32, 32, 64),
                                 in_sizes=in_sizes)
    worst = max(worst, splat_parity(lp, "view_mlp64_voxel160_64ch", rays,
                                    [SPLAT_VOXEL], kw, sp, igrid, in_sizes))
    del rays, sp, igrid
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  all configs within bounds; worst max|d| / max|ref| "
          f"{worst:.3e}")


def splat_work(cfg, geom):
    """(FLOPs, bytes) S1 and S2 (without the MLP) must do on these inputs,
    from the corners this run's points need: each in-bounds output corner
    costs S1 2C + 1 FLOPs (C multiply-adds into the row, 1 add into w) and
    S2 2C (a multiply-add per gathered channel).  Bytes: every input read
    once and every output written once (S1: the rays and encodings in, the
    grids out; S2: the rays and the grid's gradient in, the encodings'
    gradient out)."""
    from lightplane_tpu_torch.ops import splatter as smod

    R, C, V = geom[0].shape[0], cfg.out_chn, cfg.v_total
    corners = 0.0
    with torch.no_grad():
        for s in range(cfg.tot_num_samples):
            pts = smod._march_points(cfg, geom, s)
            keep = torch.ones_like(pts[:, 0])
            if cfg.mask_out_of_bounds_samples:
                keep = (pts.abs() <= 1.0).all(-1).float()
            for _, D, H, W, _ in cfg.output_grid_sizes:
                n = keep
                for k, size in enumerate((W, H, D)):
                    if size == 1:
                        continue
                    f0 = torch.floor(((pts[:, k] + 1.0) * 0.5) * size - 0.5)
                    n = n * (((f0 >= 0) & (f0 < size)).float()
                             + ((f0 >= -1) & (f0 < size - 1)).float())
                corners += float(n.sum())
    geom_bytes = 4 * R * (3 + 3 + 1 + 1 + 1)
    fw = (corners * (2 * C + 1), geom_bytes + 4 * R * C + 4 * V * (C + 1))
    bw = (corners * 2 * C, geom_bytes + 4 * V * C + 4 * R * C)
    return fw, bw


def fwbw_step(lp, rays, out_sizes, kw):
    """One fw+bw step of ``lightplane_splatter``: loss ``sum(out^2)``,
    gradient w.r.t. the encoding."""
    enc = rays.encoding.detach().requires_grad_(True)
    r = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                rays.far, enc)
    out = lp.lightplane_splatter(r, out_sizes, return_list=False, **kw)
    out.square().sum().backward()
    return enc.grad


def device_breakdown(fn, smi, top=6):
    """The device time of one run of ``fn`` by kernel, from
    ``torch.profiler``; the busiest ``top`` kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels' own rows (an operator's row repeats its kernels' time)
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(t for _, t in rows)
    if not total:
        print("  device time by kernel: not measured (the profiler saw no "
              "device time)")
        return
    print(f"  device time of one step by kernel (torch.profiler; "
          f"{total / 1e3:.3f} ms in all)  [{smi}]:")
    for key, t in rows[:top]:
        print(f"    {t / 1e3:9.3f} ms  {key[:100]}")


def phase_splat(lp, smi):
    print(f"== phase 7: the splatter at full width, {SPLAT_VIEWS} x "
          f"{SPLAT_VIEW_RES}^2 rays x {SPLAT_SAMPLES} samples into "
          f"{SPLAT_VOXEL[1]}^3 x {SPLAT_VOXEL[-1]}ch")
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    gen = torch.Generator().manual_seed(7)
    n = SPLAT_VIEWS * SPLAT_VIEW_RES ** 2
    enc = (torch.randn((n, SPLAT_VOXEL[-1]), generator=gen) * 0.1).cuda()
    rays = view_rays(lp, SPLAT_VIEWS, SPLAT_VIEW_RES, enc)
    out_sizes = [SPLAT_VOXEL]
    kw = dict(num_samples=SPLAT_SAMPLES)
    torch.cuda.synchronize()

    # the main path: fw+bw steps of lightplane_splatter
    steps = 8
    sfw.LAUNCHES = sbw.LAUNCHES = 0
    step_ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g = fwbw_step(lp, rays, out_sizes, kw)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = {"splatter_fw": sfw.LAUNCHES, "splatter_bw": sbw.LAUNCHES}
    print(f"  kernel launches over {steps} fw+bw steps: {launches}")
    assert launches == {"splatter_fw": steps, "splatter_bw": steps}, launches
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    step = statistics.median(step_ms[2:])
    print(f"  fw+bw step of lightplane_splatter through S1 + S2: median "
          f"{step:.3f} ms over steps 3-{steps}, {n / step * 1e3:.0f} rays/s"
          f"  [{smi}]")
    device_breakdown(lambda: fwbw_step(lp, rays, out_sizes, kw), smi)

    peaks = {}
    for ns in (48, 96):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwbw_step(lp, rays, out_sizes, dict(kw, num_samples=ns))
        torch.cuda.synchronize()
        peaks[ns] = torch.cuda.max_memory_allocated()
        print(f"  peak allocated, fw+bw step at {ns} samples: {peaks[ns]} "
              f"bytes ({(peaks[ns] - base) / 2**20:.1f} MiB above the "
              f"{base / 2**20:.1f} MiB held before it)  [{smi}]")
    assert abs(peaks[96] - peaks[48]) <= 0.05 * peaks[48], peaks

    # each kernel on its own, and its plain version once, on these inputs
    cfg = smod._SplatCfg(SPLAT_SAMPLES, 0, False, False, 1e-5,
                         tuple(out_sizes), None, ())
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    diff = (enc, None, None)
    with torch.no_grad():
        fw_ms = cuda_ms(lambda: sfw.splat_fwd_cuda(cfg, geom, diff), reps=5)
        feat_k, w_k = sfw.splat_fwd_cuda(cfg, geom, diff)
        g_out = (torch.randn(feat_k.shape, generator=gen) * 0.01).cuda()
        bw_ms = cuda_ms(lambda: sbw.splat_bwd_cuda(cfg, geom, diff, g_out),
                        reps=5)
        g_k = sbw.splat_bwd_cuda(cfg, geom, diff, g_out)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat_p, w_p = sfw.splat_fwd_torch(cfg, geom, diff)
        torch.cuda.synchronize()
        fw_plain_ms = 1e3 * (time.perf_counter() - t0)
        print("  S1 vs its plain version at the headline:")
        fw_err = max(compare("feat", feat_k, feat_p,
                             max_rel=SPLAT_MAX_REL)[0],
                     compare("w", w_k, w_p, max_rel=SPLAT_MAX_REL)[0])
        del feat_k, w_k, feat_p, w_p
        t0 = time.perf_counter()
        g_p = sbw.splat_bwd_torch(cfg, geom, diff, g_out)[0]
        torch.cuda.synchronize()
        bw_plain_ms = 1e3 * (time.perf_counter() - t0)
        print("  S2 vs its plain version at the headline:")
        bw_err = compare("g_enc", g_k, g_p, max_rel=SPLAT_MAX_REL)[0]
    print(f"  S1 alone: median {fw_ms:.3f} ms, plain version "
          f"{fw_plain_ms:.1f} ms (one run); S2 alone: median {bw_ms:.3f} ms,"
          f" plain version {bw_plain_ms:.1f} ms (one run)  [{smi}]")
    (fl_fw, by_fw), (fl_bw, by_bw) = splat_work(cfg, geom)
    b_fw, b_fw_kind = bound(fl_fw, by_fw)
    b_bw, b_bw_kind = bound(fl_bw, by_bw)
    print(f"  work: S1 {fl_fw / 1e9:.1f} GFLOP, {by_fw / 1e6:.1f} MB -> "
          f"bound {b_fw:.3f} ms ({b_fw_kind}); S2 {fl_bw / 1e9:.1f} GFLOP, "
          f"{by_bw / 1e6:.1f} MB -> bound {b_bw:.3f} ms ({b_bw_kind})")
    del g_out, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()
    print_kernel_attrs()
    mlp_splat_step(lp, rays, smi)
    return launches, dict(
        fw=dict(ms=fw_ms, plain_ms=fw_plain_ms, err=fw_err,
                bound=(b_fw, b_fw_kind)),
        bw=dict(ms=bw_ms, plain_ms=bw_plain_ms, err=bw_err,
                bound=(b_bw, b_bw_kind)))


def print_kernel_attrs():
    """Registers and spilled bytes per thread of each splat kernel."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build

    lib = _build.library()
    out = (ctypes.c_int * 3)()
    for name, fn in (("S1", lib.lightplane_splat_fw_attrs),
                     ("S2", lib.lightplane_splat_bw_attrs)):
        for mlp, width in ((0, 0), (1, 32), (1, 64)):
            assert fn(mlp, width, out) == 0
            label = f"MLP W={width}" if mlp else "no MLP"
            print(f"  {name} {label}: {out[0]} registers, {out[1]} bytes "
                  f"spilled per thread")


def mlp_splat_step(lp, rays, smi):
    """The MLP splatter over the headline rays: fw+bw step with gradients
    for the encoding, the input triplane and ``mlp_params``."""
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    gen = torch.Generator().manual_seed(8)
    module = lp.LightplaneMLPSplatter(
        num_samples=SPLAT_SAMPLES, grid_chn=SPLAT_VOXEL[-1],
        input_grid_chn=32, mlp_hidden_chn=32, mlp_n_layers=2,
        generator=gen)
    n = len(rays)
    enc = (torch.randn((n, 32), generator=gen) * 0.1).cuda()
    igrid = [(torch.randn(s, generator=gen) * 0.1).cuda()
             for s in tri_sizes(128, 32)]
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc.requires_grad_(True))
    for g in igrid:
        g.requires_grad_(True)

    def step():
        for x in [enc, module.mlp_params] + igrid:
            x.grad = None
        out = module(rays, [SPLAT_VOXEL], igrid, return_list=False)
        out.square().sum().backward()

    fw0, bw0 = sfw.LAUNCHES, sbw.LAUNCHES
    step_ms = cuda_ms(step, warmup=1, reps=5)
    assert (sfw.LAUNCHES - fw0, sbw.LAUNCHES - bw0) == (6, 6)
    for x in [enc, module.mlp_params] + igrid:
        assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0
    print(f"  LightplaneMLPSplatter (MLP 32 -> 32 -> 64, 3 x 128^2 x 32ch "
          f"input triplane): fw+bw step median {step_ms:.3f} ms, "
          f"{n / step_ms * 1e3:.0f} rays/s  [{smi}]")


def phase_lift_render(lp, smi):
    print("== phase 8: lift-then-render, batches of 512^2 images: splat "
          "into 3 x 128^2 x 32ch, render back at 256 samples")
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    size, chn, res = 512, 32, 128
    gen = torch.Generator().manual_seed(9)
    dp = lp.init_decoder_params(gen, n_layers_opacity=2, n_layers_trunk=2,
                                n_layers_color=2, input_chn=chn,
                                hidden_chn=32, color_chn=3,
                                opacity_init_bias=-2.0)
    mlp = dp.mlp_params.requires_grad_(True)
    out_sizes = tri_sizes(res, chn)
    peaks, times = {}, {}
    for n_img in (2, 4):
        gc.collect()
        torch.cuda.empty_cache()
        n = n_img * size * size
        enc = (torch.randn((n, chn), generator=gen) * 0.1).cuda()
        rays = view_rays(lp, n_img, size, enc.requires_grad_(True))
        zero_enc = torch.zeros((n, 32), device="cuda")
        rays_render = lp.Rays(rays.directions, rays.origins, rays.grid_idx,
                              rays.near, rays.far, zero_enc)

        def step():
            enc.grad = mlp.grad = None
            lifted = lp.lightplane_splatter(rays, out_sizes, num_samples=96)
            depth, nlt, feat = lp.lightplane_renderer(
                rays_render, lifted, dp, num_samples=256, gain=1.0)
            loss = feat.square().sum() + nlt.sum() + depth.sum()
            loss.backward()
            return loss

        step()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sfw.LAUNCHES = sbw.LAUNCHES = rfw.LAUNCHES = rbw.LAUNCHES = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()
        end.record()
        end.synchronize()
        launches = dict(splatter_fw=sfw.LAUNCHES, renderer_fw=rfw.LAUNCHES,
                        renderer_bw=rbw.LAUNCHES, splatter_bw=sbw.LAUNCHES)
        assert set(launches.values()) == {1}, launches
        times[n_img] = start.elapsed_time(end)
        peaks[n_img] = torch.cuda.max_memory_allocated()
        assert torch.isfinite(loss)
        for name, x in (("encodings", enc), ("mlp_params", mlp)):
            assert torch.isfinite(x.grad).all(), name
            assert float(x.grad.abs().sum()) > 0, f"{name}: zero gradient"
        print(f"  batch {n_img} ({n} rays): step {times[n_img]:.3f} ms; "
              f"launches {launches}; peak allocated {peaks[n_img]} bytes "
              f"({(peaks[n_img] - base) / 2**20:.1f} MiB above the "
              f"{base / 2**20:.1f} MiB held before it)  [{smi}]")
        if n_img == 4:
            device_breakdown(step, smi)
        del rays, rays_render, enc, zero_enc
    marginal = (peaks[4] - peaks[2]) / 2
    print(f"  marginal peak memory per 512^2 image: {marginal:.0f} bytes "
          f"({marginal / 2**20:.1f} MiB)  [{smi}]")


# ---- scene fitting (phase 9) ---------------------------------------------

# The JAX app's defaults (examples/fit_single_scene.py: triplane 3 x 64^2 x
# 32ch, MLPs 2/2/2 with hidden 32, 128 samples, 4096 rays, opacity bias -5,
# TV 1e-3, a 1 x 64^3 scaffold, the 24-view 64^2 synthetic scene) with a
# schedule cut to 600 steps: scaffold updates at 200 and 400 around the
# upsample at 300 (to 3 x 128^2 x 32ch, 256 samples), evals at 300 and 600,
# both after the first scaffold update (see in_cube_psnr for why).
FIT_ARGV = ["--n_iter", "600", "--upsample_steps", "300",
            "--update_scaffold_steps", "200", "400", "--eval_rate", "300",
            "--output_dir", "build/fit_smoke", "--seed", "0"]


def timed_steps(fit, n, seed):
    """Milliseconds of ``n`` training steps of ``fit`` (host clock, synced),
    with the ray batches drawn from ``seed``."""
    fit.batch_gen.manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fit.step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def fit_state(fit):
    """A copy of what a training step changes."""
    return ([g.detach().clone() for g in fit.grid],
            {k: v.clone() for k, v in fit.renderer.state_dict().items()},
            copy.deepcopy(fit.opt.state_dict()), fit.sched.state_dict())


def restore_fit(fit, state):
    grid, module, opt, sched = state
    with torch.no_grad():
        for p, g in zip(fit.grid, grid):
            p.copy_(g)
    fit.renderer.load_state_dict(module)
    fit.opt.load_state_dict(copy.deepcopy(opt))
    fit.sched.load_state_dict(sched)


def branch_kernel_times(lp, rmod, rfw, rbw, label, rays, grid, dp, kw, smi):
    """R1 and R2 alone on one config (CUDA events), their plain versions
    once, the kernels against them, and the bound from the samples this
    run's data needs; returns the kernel line's numbers."""
    cfg, geom, diff = unsplit_march(lp, rmod, rays, grid, dp, **kw)
    diff = tuple(None if x is None else x.detach() for x in diff)
    n = len(rays)
    gen = torch.Generator().manual_seed(11)
    g_out = tuple(torch.randn(s, generator=gen).cuda()
                  for s in [(n,), (n,), (n, 3)])
    with torch.no_grad():
        fw_ms = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff))
        out_k = rfw.render_fwd_cuda(cfg, geom, diff)
        nlt = out_k[1]
        bw_ms = cuda_ms(lambda: rbw.render_bwd_cuda(cfg, geom, diff, nlt,
                                                    g_out))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = rfw.render_fwd_torch(cfg, geom, diff)
        torch.cuda.synchronize()
        fw_plain = 1e3 * (time.perf_counter() - t0)
        f64 = torch.float64
        geom64 = tuple(x.to(f64) if torch.is_tensor(x) and x.is_floating_point()
                       else x for x in geom)
        diff64 = tuple(None if x is None else x.to(f64) for x in diff)
        keep = (kink_margin(rmod, cfg, geom64, diff64) >= KINK_MARGIN).float()
        g_out = (g_out[0] * keep, g_out[1] * keep, g_out[2] * keep[:, None])
        g_k = rbw.render_bwd_cuda(cfg, geom, diff, nlt, g_out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_p = rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
        torch.cuda.synchronize()
        bw_plain = 1e3 * (time.perf_counter() - t0)
        nlt64 = rfw.render_fwd_torch(cfg, geom64, diff64)[1]
        g_r = rbw.render_bwd_torch(cfg, geom64, diff64, nlt64,
                                   tuple(g.to(f64) for g in g_out))
    print(f"  {label}: R1 vs its plain version:")
    fw_err = max(compare(k, a, b)[0]
                 for k, a, b in zip(("depth", "nlt", "feat"), out_k, out_p))
    pick = [i for i, g in enumerate(g_k) if g is not None]
    names = [("g_grid", "g_cgrid", "g_mlp", "g_enc")[i] for i in pick]
    print(f"  {label}: R2 vs its plain version ({n - int(keep.sum())} of {n}"
          f" rays within {KINK_MARGIN:g} of a relu kink get no cotangent):")
    bw_err = grad_compare(names, [g_k[i] for i in pick],
                          [g_p[i] for i in pick], [g_r[i] for i in pick])
    (fl_fw, by_fw), (fl_bw, by_bw) = kernel_work(rmod, cfg, geom, diff)
    b_fw, b_bw = bound(fl_fw, by_fw), bound(fl_bw, by_bw)
    print(f"  {label}: R1 alone {fw_ms:.3f} ms (plain {fw_plain:.1f} ms, one "
          f"run; bound {b_fw[0]:.3f} ms, {b_fw[1]}); R2 alone {bw_ms:.3f} ms "
          f"(plain {bw_plain:.1f} ms; bound {b_bw[0]:.3f} ms, {b_bw[1]})"
          f"  [{smi}]")
    return dict(fw=dict(ms=fw_ms, plain_ms=fw_plain, err=fw_err, bound=b_fw),
                bw=dict(ms=bw_ms, plain_ms=bw_plain, err=bw_err, bound=b_bw))


def in_cube_psnr():
    """PSNR against image 0 of the synthetic scene of the same render with
    the scene's density outside the [-1, 1] cube removed
    (``examples/datasets.py::make_synthetic_scene``'s blobs and march): how
    much of the image the blobs draw past the cube, where a scaffold gates
    every sample, as the JAX package's does."""
    from lightplane_tpu_torch.examples.datasets import make_synthetic_scene
    from lightplane_tpu_torch.utils.cameras import camera_rays, sphere_cameras

    ds = make_synthetic_scene()
    rng = np.random.RandomState(0)  # the scene's own draws, seed 0
    centers = rng.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (6, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.3, (6,)).astype(np.float32)
    o, d = camera_rays(sphere_cameras(24, radius=3.0)[0], 64, 64, 64 * 1.2,
                       ds.near, ds.far)
    ts = np.linspace(ds.near, ds.far, 64, dtype=np.float32)
    pts = o[:, None, :] + ts[None, :, None] * d[:, None, :]
    blobs = [np.exp(-np.sum((pts - c) ** 2, -1) / (2 * r ** 2))
             for c, r in zip(centers, radii)]
    sigma = 25.0 * sum(blobs) * (np.abs(pts) <= 1.0).all(-1)
    rgb = sum(b[..., None] * c for b, c in zip(blobs, colors)) / np.maximum(
        sum(blobs)[..., None], 1e-6)
    T = np.exp(-np.concatenate([np.zeros_like(sigma[:, :1]), np.cumsum(
        sigma * (ts[1] - ts[0]), -1)], -1))
    img = ((T[:, :-1] - T[:, 1:])[..., None] * rgb).sum(1) + T[:, -1:]
    return float(-10.0 * np.log10(np.mean((img - ds.image(0)[2].reshape(
        -1, 3)) ** 2)))


def phase_fit(lp, smi):
    print("== phase 9: scene fitting, the port's fit_single_scene at the JAX "
          "app's default width")
    from lightplane_tpu_torch.examples import fit_single_scene as app
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.utils import grid_utils

    print(f"  argv: {' '.join(FIT_ARGV)}")
    rfw.LAUNCHES = rbw.LAUNCHES = 0
    fit = app.main(FIT_ARGV)
    torch.cuda.synchronize()
    launches = {"renderer_fw": rfw.LAUNCHES, "renderer_bw": rbw.LAUNCHES}
    h = fit.history
    print(f"  kernel launches over the fit: {launches}")
    # one forward and one backward per step, one forward per eval render
    assert launches == {"renderer_fw": 600 + len(h["evals"]),
                        "renderer_bw": 600}, launches
    for a, b, ms in h["segments"]:
        print(f"  steps {a}-{b}: {ms:.3f} ms per step  [{smi}]")
    print(f"  scaffold occupancy: {h['scaffolds']}; upsampled at "
          f"{h['upsamples']}; evals (step, PSNR, SSIM): {h['evals']}")
    assert [s for s, _ in h["scaffolds"]] == [200, 400]
    assert [e[0] for e in h["evals"]] == [300, 600]
    # every step after the first scaffold update, and every eval after it,
    # renders with a scaffold
    s0 = h["scaffolds"][0][0]
    gated = 600 - (s0 + 1)
    print(f"  of these, with a scaffold (steps {s0 + 1}-599 and the evals "
          f"after step {s0}): R1 {gated + sum(e[0] > s0 + 1 for e in h['evals'])}"
          f", R2 {gated}")
    assert h["upsamples"] == [300]
    assert [tuple(g.shape) for g in fit.grid] == tri_sizes(128, 32)
    assert fit.num_samples == 256 and fit.scaffold.shape == (1, 64, 64, 64)
    first, last = h["evals"][0][1], h["evals"][-1][1]
    assert np.isfinite(last) and last > first, (first, last)
    print(f"  image 0 rendered without the scene's density outside the "
          f"[-1, 1] cube, where a scaffold gates every sample: PSNR "
          f"{in_cube_psnr():.2f} against the target")

    # what users of the scaffold pay or save: 20 steps at the fitted state,
    # without and with the scaffold, from the same state and ray batches
    state = fit_state(fit)
    scaffold = fit.scaffold
    times = {}
    for label in ("no scaffold", "scaffold", "no scaffold ", "scaffold "):
        fit.scaffold = scaffold if label.startswith("scaffold") else None
        restore_fit(fit, state)
        times.setdefault(label.strip(), []).append(timed_steps(fit, 20, 7))
    restore_fit(fit, state)
    fit.scaffold = scaffold
    for label, ts in times.items():
        print(f"  20 training steps at the fitted state, {label}: "
              f"{' '.join(f'{t:.1f}' for t in ts)} ms  [{smi}]")

    # the device's share of one step (torch.profiler) against its wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit.step()
    torch.cuda.synchronize()
    print(f"  one training step: {1e3 * (time.perf_counter() - t0):.3f} ms "
          f"wall")
    device_breakdown(fit.step, smi, top=8)

    # R1 and R2 alone with the scaffold at the fitted state (the R3 row)
    def batch_rays(n_batches):
        idx = torch.cat([fit.sample_ray_idx(fit.sampling_mode())
                         for _ in range(n_batches)])
        r = fit.rays(idx)
        with torch.no_grad():
            enc = fit.renderer._get_ray_embedding(r.directions)
        return lp.Rays(r.directions, r.origins, r.grid_idx, r.near, r.far,
                       enc)

    rays = batch_rays(1)
    dp = fit.renderer.get_decoder_params()
    dp = lp.DecoderParams(dp.mlp_params.detach(), dp.n_hidden_trunk,
                          dp.n_hidden_opacity, dp.n_hidden_color,
                          dp.color_chn)
    grid = [g.detach() for g in fit.grid]
    kw = dict(num_samples=fit.num_samples, gain=fit.renderer.gain)
    scaffold_row = branch_kernel_times(
        lp, rmod, rfw, rbw, "fitted, with the scaffold", rays, grid, dp,
        dict(kw, scaffold=fit.scaffold), smi)
    branch_kernel_times(lp, rmod, rfw, rbw, "fitted, without it", rays, grid,
                        dp, kw, smi)
    # 4096 rays make 32 blocks of 128 rays for 132 SMs: R1 and R2 at 1, 2
    # and 4 batches, with the scaffold
    for k in (1, 2, 4):
        cfg, geom, diff = unsplit_march(lp, rmod, batch_rays(k), grid, dp,
                                        scaffold=fit.scaffold, **kw)
        m = geom[0].shape[0]
        g_out = (torch.ones(m, device="cuda"), torch.ones(m, device="cuda"),
                 torch.ones((m, 3), device="cuda"))
        with torch.no_grad():
            nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
            fw_k = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff))
            bw_k = cuda_ms(lambda: rbw.render_bwd_cuda(cfg, geom, diff, nlt,
                                                       g_out))
        print(f"  {m} rays ({-(-m // 128)} blocks of 128) with the scaffold: "
              f"R1 {fw_k:.3f} ms, R2 {bw_k:.3f} ms  [{smi}]")
    del fit, state
    gc.collect()
    torch.cuda.empty_cache()

    # a relu-field model trains too: density and colour triplanes of
    # 3 x 64^2 x 32ch, 12 Adam steps of one 64^2 image of the scene
    from lightplane_tpu_torch.examples.datasets import make_synthetic_scene

    ds = make_synthetic_scene()
    o, d, img = (torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                 for a in ds.image(0))
    n = o.shape[0]
    rays = lp.Rays(d, o, torch.zeros(n, dtype=torch.int64, device="cuda"),
                   torch.full((n,), ds.near, device="cuda"),
                   torch.full((n,), ds.far, device="cuda"))
    gen = torch.Generator().manual_seed(12)
    module = lp.LightplaneRenderer(
        num_samples=128, color_chn=3, grid_chn=32, mlp_hidden_chn=32,
        use_separate_color_grid=True, bg_color=1.0, generator=gen,
        device="cuda")
    grid = [torch.nn.Parameter(g) for g in grid_utils.init_3d_representation(
        gen, "triplane", 64, 32, device="cuda")]
    cgrid = [torch.nn.Parameter(g) for g in grid_utils.init_3d_representation(
        gen, "triplane", 64, 32, device="cuda")]
    opt = torch.optim.Adam([{"params": grid + cgrid, "lr": 5e-2},
                            {"params": list(module.parameters()),
                             "lr": 5e-3}])
    target = img.reshape(-1, 3)
    losses = []
    rfw.LAUNCHES = rbw.LAUNCHES = 0
    for _ in range(12):
        opt.zero_grad(set_to_none=True)
        _, _, rgb = module(rays, grid, cgrid, image_size=(ds.height,
                                                           ds.width))
        loss = torch.mean((rgb - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    rf_launches = (rfw.LAUNCHES, rbw.LAUNCHES)
    print(f"  relu-field (3 x 64^2 x 32ch density + colour triplanes, 128 "
          f"samples): 12 Adam steps of one {ds.height}^2 image, losses "
          f"{[round(v, 5) for v in losses]}; launches (R1, R2) {rf_launches}")
    assert rf_launches == (12, 12), rf_launches
    assert losses[-1] < losses[0], losses
    for name, ps in (("grid", grid), ("color grid", cgrid)):
        for p in ps:
            assert torch.isfinite(p.grad).all(), name
            assert float(p.grad.abs().sum()) > 0.0, f"{name}: zero gradient"
    with torch.no_grad():
        enc = module._get_ray_embedding(rays.directions)
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    dp = module.get_decoder_params()
    dp = lp.DecoderParams(dp.mlp_params.detach(), dp.n_hidden_trunk,
                          dp.n_hidden_opacity, dp.n_hidden_color,
                          dp.color_chn)
    rf_row = branch_kernel_times(
        lp, rmod, rfw, rbw, "relu-field", rays, [g.detach() for g in grid],
        dp, dict(num_samples=128, gain=module.gain,
                 color_grid=[g.detach() for g in cgrid]), smi)
    return launches, scaffold_row, rf_row


# csrc/march_common.cuh's LIGHTPLANE_ABLATE bits of each variant: atomics
# into the grid (R2's grid gradient, S1's splat) scalar or switched off, R2's
# MLP weight-gradient pass switched off
ABLATIONS = {"scalar_atomics": 1, "no_atomics": 2, "no_wgrad": 4,
             "neither": 6}


def time_variants(variants, fn, smi):
    """Time ``fn(defines)`` for each variant, twice in turn, by CUDA
    events, and print the times."""
    times = {name: [] for name in variants}
    with torch.no_grad():
        for _ in range(2):
            for name, defines in variants.items():
                times[name].append(cuda_ms(lambda: fn(defines), warmup=1,
                                           reps=5))
    for name, ms in times.items():
        print(f"  {name:14s} {' '.join(f'{t:.3f}' for t in ms)} ms "
              f"(median {statistics.median(ms):.3f})  [{smi}]")


def ablate(lp, smi):
    """R2 at the slice shape and S1 at the splatter headline, as built and
    with parts switched off; each variant built with its own -D, all builds
    started together, each timed twice in turn by CUDA events."""
    from concurrent.futures import ThreadPoolExecutor

    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw
    from lightplane_tpu_torch.utils import grid_utils

    r2 = {"shipped": ()}
    r2.update({k: (f"LIGHTPLANE_ABLATE={m}",) for k, m in ABLATIONS.items()})
    s1 = {k: r2[k] for k in ("shipped", "scalar_atomics", "no_atomics")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(r2)) as pool:
        list(pool.map(_build.library, r2.values()))
    print(f"  built {len(r2)} variants in {time.perf_counter() - t0:.1f} s")

    print("== ablation: R2 with parts switched off, at the slice shape")
    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    module = lp.LightplaneRenderer(generator=gen, device=dev, **SLICE)
    grid = grid_utils.init_3d_representation(gen, "triplane", 32,
                                             SLICE["grid_chn"], device=dev)
    rays = orbit_rays(lp, 0.0, dev)
    cfg, geom, diff = slice_march(lp, rmod, module, grid, rays)
    n = len(rays)
    g_out = tuple(torch.randn(s, generator=gen).to(dev)
                  for s in [(n,), (n,), (n, 3)])
    with torch.no_grad():
        nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
    time_variants(r2, lambda d: rbw.render_bwd_cuda(cfg, geom, diff, nlt,
                                                    g_out, d), smi)

    print("== ablation: S1 with parts switched off, at the splatter "
          "headline")
    n = SPLAT_VIEWS * SPLAT_VIEW_RES ** 2
    enc = (torch.randn((n, SPLAT_VOXEL[-1]), generator=gen) * 0.1).cuda()
    rays = view_rays(lp, SPLAT_VIEWS, SPLAT_VIEW_RES, enc)
    cfg = smod._SplatCfg(SPLAT_SAMPLES, 0, False, False, 1e-5,
                         (SPLAT_VOXEL,), None, ())
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    time_variants(s1, lambda d: sfw.splat_fwd_cuda(cfg, geom,
                                                   (enc, None, None), d),
                  smi)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import lightplane_tpu_torch as lp

    t0 = time.perf_counter()

    def timed(fn, *args):
        """Run one phase, print its time and check that no JAX came in."""
        t = time.perf_counter()
        out = fn(*args)
        print(f"   ({fn.__name__}: {time.perf_counter() - t:.1f} s)")
        assert "jax" not in sys.modules, "the port imported jax"
        return out

    smi, name = timed(phase_device)
    timed(phase_build)
    if sys.argv[1:] == ["--ablate"]:
        ablate(lp, smi)
        return 0
    timed(phase_parity, lp)
    timed(phase_backward_parity, lp)
    branch_errs = timed(phase_branch_parity, lp)
    held_memory()
    fw = timed(phase_slice, lp, smi)
    _, train = timed(phase_training, lp, smi)
    gc.collect()
    torch.cuda.empty_cache()
    timed(phase_splat_parity, lp)
    splat_launches, splat = timed(phase_splat, lp, smi)
    timed(phase_lift_render, lp, smi)
    gc.collect()
    torch.cuda.empty_cache()
    fit_launches, scaffold_row, rf_row = timed(phase_fit, lp, smi)
    b_fw, b_fw_kind = train["fw_bound"]
    b_bw, b_bw_kind = train["bw"]["bound"]
    # R1 and R2: launches on this slice's main path (the trainer, phase 9);
    # times, errors and bounds at the render headline (phases 4, 5); the
    # scaffold (R3) and relu-field (R1-rf) branches' worst errors (phase 3c)
    # and times at phase 9's shapes
    branches = {
        key: dict(max_abs_err_scaffold=branch_errs["scaffold"][i],
                  max_abs_err_relu_field=branch_errs["relu_field"][i],
                  **{f"{label}_{k}": v
                     for label, row in (("scaffold", scaffold_row),
                                        ("relu_field", rf_row))
                     for k, v in (("ms", row[key]["ms"]),
                                  ("plain_ms", row[key]["plain_ms"]),
                                  ("bound_ms", row[key]["bound"][0]))})
        for i, key in enumerate(("fw", "bw"))}
    kernels = [
        dict(fw, launches=fit_launches["renderer_fw"], bound_ms=b_fw,
             bound_by=b_fw_kind, library_ms=None, **branches["fw"]),
        dict(name="renderer_bw", route="cuda",
             source="lightplane_tpu_torch/csrc/renderer_bw.cu",
             replaces="lightplane_tpu/ops/kernels/renderer_pallas.py:2798",
             launches=fit_launches["renderer_bw"],
             max_abs_err=train["bw"]["err"], ms=train["bw"]["ms"],
             plain_ms=train["bw"]["plain_ms"], bound_ms=b_bw,
             bound_by=b_bw_kind, library_ms=None, **branches["bw"]),
    ]
    for key, line in (("fw", 57), ("bw", 183)):
        k = splat[key]
        kernels.append(dict(
            name=f"splatter_{key}", route="cuda",
            source=f"lightplane_tpu_torch/csrc/splatter_{key}.cu",
            replaces=f"lightplane_tpu/ops/kernels/splatter_pallas.py:{line}",
            launches=splat_launches[f"splatter_{key}"],
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound"][0], bound_by=k["bound"][1],
            library_ms=None))
    print(f"== done in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
