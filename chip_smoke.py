#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``lightplane_tpu_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py                # the phases below
    python3 chip_smoke.py --only 3b,5,9  # phases 1, 2 and those named
    python3 chip_smoke.py --ablate       # phases 1-2, each kernel, parts off
    python3 chip_smoke.py --ablate S2    # phases 1-2, S2 with parts off
    python3 chip_smoke.py --ablate R2w   # phases 1-2, R2's wide build likewise
    python3 chip_smoke.py --ablate S1w,S2w  # S1's and S2's wide MLP builds

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without its result line:

1. Device: the card's name and power limit (``nvidia-smi``), its compute
   capability, which must be 9.0; TF32 is switched off.
2. Build: ``nvcc`` compiles ``lightplane_tpu_torch/csrc/*.cu`` (cached under
   ``build/kernels/`` by a hash of the sources), one process a source, all
   in parallel; then, at nice 10, the relu-mask recording build of R2 and
   S2 (``-DLIGHTPLANE_RELU_MASKS=1``), which compiles beside the phases
   that need only the shipped build: phase 13's steps, then phases 4, 8
   and 10; each source's compile time; once the recording build is done,
   registers and spilled bytes per thread of every kernel, then phase 13's
   checks and the other phases in order.
3. The forward kernel (R1) vs its plain PyTorch version on the card, at
   4096 rays and 48 samples, over fifteen configurations it supports, five
   of them the big shapes that the TPU's W3 sampler served (a 3 x 128^2
   and a 3 x 100^2 triplane, a batch of two 32^3 grids, a contracted 32^3
   grid, an 8^3 + 24^3 pyramid; all 16ch), one at 37 samples (R1 marches
   32-sample chunks).
3b. The backward kernel (R2) vs its plain version on the same fifteen
   configurations, with the JAX parity tests' N(0, 0.05) decoders:
   gradients of a fixed random-projection loss w.r.t. the grid-list,
   ``mlp_params`` and ``rays.encoding`` through
   ``lightplane_renderer(impl="cuda")`` (R1 + R2) and ``impl="torch"``, on
   cotangents that skip the rays within KINK_MARGIN of a relu kink; then R2
   alone on every ray's cotangent against its plain version under the relu
   masks that the kernel took (``masked_r2_parity``), printing how many rays
   the margin leaves out.  First, on the triplane config with the
   initialiser's decoder, where f32 gradients are rough at relu kinks, it
   prints how far each f32 version is from the f64 run and how close that
   ray came to a kink.
3c. Scaffold gating (R3) and the relu-field colour grid (R1-rf) in R1 and
   R2 vs their plain versions, on the triplane config: random, empty and
   half-empty binary scaffolds, one from ``calculate_scaffold`` at 64^3, and
   two relu-field configs (one with a scaffold); it prints how many gates
   sit within 1e-6 of a rounding boundary, where an ulp flips a gate.  R2
   is held as in 3b, end to end and under its masks.
4. Serving: the ``LightplaneRenderer`` module at the repository's headline
   render config (triplane 3 x 32^2 x 32ch, MLPs 2/2/2 with hidden 32,
   harmonic ray embedding, 256 samples) serves four 256 x 256 frames from
   four orbit poses through R1; frame 0 is checked against the plain
   version and both are timed.  Before it, the memory that earlier phases
   leave allocated is printed, and serving's peak is read above it too.
5. Training: the same model as ``nn.Module`` plus triplane
   ``nn.Parameter``s takes 12 Adam steps of one full frame each through
   R1 + R2 against targets a second model renders; the fw+bw step, each
   kernel and the plain versions are timed, peak memory is read at 128
   and 256 samples, and R2 is held under its masks at this shape.
6. The splatter's forward kernel (S1) and adjoint (S2) vs their plain
   versions on the card, every ray: the raw accumulators, the normalised
   grid and the gradients of a fixed random-projection loss w.r.t. the
   encoding (and, with the MLP, the input grid and ``mlp_params``), through
   ``lightplane_splatter_raw`` / ``lightplane_(mlp_)splatter`` with
   ``impl="cuda"`` and ``impl="torch"``; with the MLP those end-to-end
   gradients leave out the rays within KINK_MARGIN of a relu kink (and say
   so), and S2 alone is held on every ray against its plain version
   replaying the relu masks the kernel took.  Configs: the eight variants of
   ``tests/test_splatter_parity.py`` at 4096 rays, 32 samples and 16^3
   grids; the eight grid shapes of ``tests/test_splatter_sorted.py``; one
   128^2 camera view at 96 samples into a 160^3 x 64ch voxel grid and into
   a 3 x 128^2 x 32ch triplane; and phase 7's MLP splatter at its shapes
   (MLP 32 -> 32 -> 64, the 64-wide kernels, from a 3 x 128^2 x 32ch input
   triplane into 160^3 x 64ch) over one such view.  On every config S1's
   plan kernels are held exactly (integers, each brick's runs sorted)
   against their plain version (``splat_plan_torch``); S2 is held alone on
   every ray, and on every config without the MLP so is S2 with one (its
   "twin": an 8 -> 16 -> C MLP from an 8-channel input grid-list of the
   output's shapes), under its relu masks, with the plan of its pass B over
   the input grid-list held exactly.  Three more configs hold S1 and its
   plan with bricks of 2 x 3 x 2 cells (a triplane, the MLP with masking, 6
   channels with contraction), S1 with its rays in slices, and S2 with the
   MLP (there, or on the twin) with its rays in slices.
7. The splatter at full width (``bench.py``'s splatter headline): 16 views
   x 128^2 rays x 96 samples into one 160^3 x 64ch voxel grid.  The fw+bw
   step of ``lightplane_splatter`` (loss ``sum(out^2)``), S1 and S2 alone and
   their plain versions are timed, S1's plan alone too, with its brick,
   runs and bytes; peak memory is read at 48 and 96 samples; S2 with the
   MLP alone at the MLP splatter's shapes (its time, its plain version's,
   its error, its bounds, its own peak memory at 48, 96 and 192 samples);
   S1 with the MLP alone there (its W = 64 build: its time, its plain
   version's, its error on every ray, its bound); then the
   ``LightplaneMLPSplatter`` (MLP 32 -> 32 -> 64) over the same
   rays with a 3 x 128^2 x 32ch input triplane, its step's device time by
   kernel.
8. Lift-then-render (``bench.py``'s batched 512^2 memory workload): per-pixel
   32-channel encodings of 2 and of 4 images are splatted into a 3 x 128^2
   x 32ch triplane (96 samples) and rendered back (256 samples, decoder
   2/2/2 with hidden 32); one backward reaches the encodings and the
   decoder through R2 and S2.  Step time, peak memory, and the marginal
   memory per image; S1's and S2's times alone at 4 images.
9. Scene fitting: the port's trainer
   (``lightplane_tpu_torch.examples.fit_single_scene.main``) at the JAX
   app's default width (triplane 3 x 64^2 x 32ch, 128 samples, 4096 rays,
   the synthetic scene) for 600 steps, with scaffold updates before and
   after an upsample to 3 x 128^2 x 32ch at 256 samples: ms per step between
   events, occupancy, eval PSNR and SSIM (the last must beat the first),
   launches; 20 steps with and without the scaffold; ms per step with and
   without the host's grid_idx range check (``LIGHTPLANE_CHECK_GRID_IDX``)
   and the host's share against a profiled step; R1 and R2 alone (R2 under
   its masks) with and without the scaffold; R2 at 128, 64 and 32 rays per
   block for 4096, 8192 and 16384 rays and at the size its wrapper picks;
   then a relu-field model (density and colour triplanes of 3 x 64^2 x
   32ch) takes 12 Adam steps.
10. Fitting from files: 8 views of the synthetic scene at 800 x 800
   (NeRF-synthetic's size) written as RGBA PNGs in NeRF-synthetic and in
   NSVF layout (one process a view) into a temporary directory and loaded
   through ``auto_dataset``: both layouts give the written pixels exactly
   and the same rays within 1e-6, and a ``downsample=2`` load (400 x 400)
   is timed, without PIL; ``perceptual_loss`` of two 800^2 images on the
   card, with the random extractor and with random VGG16 weights behind
   ``LIGHTPLANE_VGG_WEIGHTS``, value and gradient against the same code on
   the CPU, with cuDNN in TF32 and in f32 (``PERCEPTUAL_TOL``; VGG's
   gradient given the card's max-pool winners and relu masks, the
   decisions that differ from the CPU's counted), and ``calc_lpips``;
   then the port's trainer on the NeRF-synthetic directory
   in whole-image mode with the perceptual term at the JAX app's default
   width (640,000 rays a step, a scaffold update, three evals: the last
   PSNR must beat the first), cuDNN at PyTorch's default (TF32): ms per
   step, launches of R1, R2 and R3, a step's device time by part (R1, R2,
   the convolutions, the rest), the host's share and a step's peak memory.
11. Data parallel (``lightplane_tpu_torch.parallel``) over two workloads:
   the render headline's fw+bw (phase 4's widths, one 256^2 frame, a
   random projection of the outputs as the loss) and
   ``__graft_entry__.py::dryrun_multichip``'s training step at
   lift-then-render's width (2 images of 512^2 with 32-channel encodings
   lifted by the MLP splatter, 32 -> 32 -> 32 from a 3 x 128^2 x 32ch input
   triplane, into 3 x 128^2 x 32ch at 96 samples, rendered back at 256
   samples, one Adam step).  First a gloo world of two ranks, spawned, both
   on ``cuda:0`` with the kernels phase 2 built, each on half the rays:
   each rank's outputs and loss against the single-process call within
   KERNEL_MAX_ABS and every gradient within DP_GRAD_MAX_REL x max |g|,
   every group's gradient finite and non-zero, each rank's launches of R1,
   R2, S1 and S2 counted; then a world of one NCCL rank in this process:
   the same checks, its launches, and both workloads timed against the
   plain single-process call in turns (the wrapper's overhead).
12. The kernels' wide builds (padded widths 96, 128, 192 and 256: decoder
   and grid widths past 64). (a) R1 and R2 at the render headline with a
   2/2/2 decoder at hidden 256, 192, 128 and 96: timed, with their plain
   versions; at 256 and 128 held on 4096 of the frame's rays (R2 under its
   relu masks) and their layers' pre-pass held bit for bit to its plain
   version, at 128 the fw+bw step; (b) the port's trainer with
   ``--mlp_hidden_chn 128`` for 200 steps (phase 9's scene and width, a
   scaffold update after step 50, evals after steps 100 and 200), then
   with ``--mlp_hidden_chn 256`` for 120 steps (a scaffold after step 30,
   evals after 60 and 120): the loss of a fixed batch must fall, the eval
   PSNR rise, and R1, R2 and R3 launch; then a step's device time by
   kernel; (c) ``LightplaneMLPSplatter`` 32 -> W -> W from a 3 x 128^2 x
   32ch prior into 3 x 128^2 x Wch over phase 7's rays at W = 256, 192, 128
   and 96: one fw+bw step, then S1 and S2 with the MLP timed, each by part
   with its slices of the rays (S1: pass F, the layers' pre-pass, the plans,
   the splat passes; S2: the gathers, pass A, the pre-pass, the plans, pass
   B, the weight-gradient sum); at 256 and 128 held on every ray (S1's
   plan exactly, the pre-pass's splatter schedules bit for bit), at 128
   also S1's own peak memory at 48, 96 and 192 samples (within 5% from 96
   to 192) and a yardstick on no path: S2's pass A over one slice of the
   rays as f32 ``torch.matmul`` calls, beside the kernel's pass A over the
   same rays; (d) the widths in between on phase 3's shapes: R1 and R2 at
   hidden 72, 96 and 160 (one-layer heads: R2 a warpgroup at W = 192), a
   96- and a 160-channel grid, hidden 128 with the relu-field colour grid
   and a scaffold, and the 3/3/3 decoder at hidden 256 (one warp a block);
   S1 and S2 with the MLP at hidden 72 and 160 and into 100 channels.
13. Feature fields at widths 384 and 512 (R1's and R2's builds past 256):
   2 views of 128^2 rays with seeded 512-channel features splatted (96
   samples) into a 3 x 128^2 x 512ch triplane (100.7 MB) and rendered back
   (128 samples) through a 2/2/2 decoder 512 wide with 512 colours, an L2
   loss against the features, 5 Adam steps over the lifted features, a
   residual on the lifted triplane and the decoder (the loss must fall;
   R1, R2, S1 and S2 launch once a step); the same at 384 channels for one
   timed step.  Then (once the recording build is done) R1 and R2 alone
   on each width's march, timed with
   their plain versions and their bounds, and held on 4096 of its rays (R2
   under its relu masks), R1's forward against R2's recomputed forward to
   the bit (``renderer_bw.forward_probes``) and the layers' pre-pass bit for
   bit.

Phases 4, 5, 7, 8, 9, 10, 11, 12 and 13 each set the kernels' launch counts
to 0 just before they drive their path and read them just after.  Every phase
prints its time.  The last lines are the card's name and power limit, a
JSON line with every kernel (its launches on its main path, the trainer of
phase 9 for R1 and R2 and also phase 10's fit from files and phase 11's
data-parallel path, the splatter step of phase 7 for S1 and S2 and its MLP
splatter step for S2 with the MLP, its error against the plain version,
its time, the plain version's time and the least time the card could take,
for R1 and R2 the same for the scaffold and relu-field branches, and for
R1, R2, S1 and S2 with the MLP the same for the wide builds, phase 12's
``wide_W_*`` keys at W = 256, 192, 128 and 96, R1's and R2's with their
warps a SM, and phase 13's ``wide_384_*`` and ``wide_512_*`` for R1 and
R2, their launches on its feature path) and
the result line ``{"ok": true, "device": {...}}``.  Needs no network and no
JAX.

``--only`` runs phases 1 and 2 and the phases it names (for iterating on
one kernel); it prints the result line but no kernels line, which needs
every phase.

``--ablate [R1,R2,S1,S2,R1w,R2w,S1w,S2w]`` builds variants of the kernels with parts
switched off (the ``LIGHTPLANE_ABLATE`` bits of ``csrc/march_common.cuh``),
one build each, all started together, and times each twice in turn: R1 at
the slice shape and at phase 9's trainer shape (without the fit:
``trainer_march``),
R2 at the slice shape, S1 at the splatter headline and at lift-then-render's
splat: its plan alone, plan and tile sums without the flush, as built; and
as built with the bricks that fit 1, 2, 3 or 4 blocks on an SM; S2 at the
splatter headline and at the MLP splatter step: without the input grid's
gradient, without the MLP's weight gradient, the gather alone, as built;
R1w and R2w, R1's and R2's wide builds, at the render headline with its
2/2/2 decoder at hidden 128: R1 without grid sampling, without the decoder,
without either, and R1 with 8, 4 and 2 warps a block (wgmma, wgmma,
mma.sync); R2 without the grid reductions, without the weight-gradient
pass, without either; S1w and S2w, S1 and S2 with the MLP at W = 128, at
phase 12c's MLP splat: S1 as its plans alone (pass F still runs) and
without its flush, S2 without pass B, without the weight gradient, as its
gathers alone; each as built by part.
"""

import copy
import gc
import json
import os
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

# H100 SXM peaks (NVIDIA's data sheet): FP32 on the CUDA cores, TF32 on the
# tensor cores (dense), HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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
    # R1 marches 32 samples a chunk: a count that is not a multiple of 32
    ("samples_37", dict(grid_shapes=_TRI), dict(num_samples=37)),
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
    """Builds the shipped library, then starts R2's relu-mask recording
    build at nice 10 in a thread; returns ``(the recording build's future,
    its start time)`` for ``finish_build``."""
    print("== phase 2: build")
    from concurrent.futures import ThreadPoolExecutor

    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw

    t0 = time.perf_counter()
    path = _build.build()
    print(f"built {path.name} in {time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)}); the recording build now compiles "
          f"at nice {RECORDING_NICE} beside what needs only this one")
    print_build_seconds(())
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    recording = pool.submit(_build.build, rbw.RELU_MASKS_BUILD, RECORDING_NICE)
    pool.shutdown(wait=False)
    return recording, t0


# the recording build's priority: below the shipped build's and the phases'
RECORDING_NICE = 10


def print_build_seconds(defines):
    """Each source's compile time in the last build with ``defines`` (none
    where the library was cached)."""
    from lightplane_tpu_torch.ops.kernels import _build

    seconds = _build.SECONDS.get(tuple(defines))
    if seconds:
        print("  compile seconds by source: " + ", ".join(
            f"{name} {sec:.1f}" for name, sec in seconds.items()))


def finish_build(recording, t0):
    """Waits for the recording build, then prints every kernel's registers
    and spills and the wide plans (``print_kernel_attrs``)."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw

    path = recording.result()
    print(f"== phase 2 (cont.): the recording build {path.name}, done "
          f"{time.perf_counter() - t0:.1f} s after it began")
    print_build_seconds(rbw.RELU_MASKS_BUILD)
    return print_kernel_attrs()


def phase_parity(lp):
    print("== phase 3: kernel vs plain PyTorch version on the card")
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    worst = 0.0
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for name, case_kw, render_kw in PARITY_CASES:
            rays, grid, dp = random_case(lp, rng, 4096, **case_kw)
            kw = {**dict(num_samples=48, gain=1.5), **render_kw}
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

        # the plain versions once each, within the script's time
        kernel_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain_fn, warmup=0, reps=1)
        frame_ms = cuda_ms(frame)
        frame_plain_ms = cuda_ms(frame_plain, warmup=0, reps=1)
    print(f"  kernel call: median {kernel_ms:.3f} ms; plain version "
          f"{plain_ms:.3f} ms (one run)  [{smi}]")
    print(f"  module frame: median {frame_ms:.3f} ms through the kernel, "
          f"{frame_plain_ms:.3f} ms through the plain version (one run)  "
          f"[{smi}]")
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
    print("== memory held before phase 4")
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
    read once and every output written once.  Third, the backward's
    weight-gradient FLOPs (one of its three decoder passes), which R2 runs
    on the tensor cores at width 32, and fourth, the forward's FLOPs in the
    dense layers that R1 runs on the tensor cores, all but the heads' last
    ones (``tf32_bound``), past W = 256 the colour head's last layer among
    them."""
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.grid_sample import sample_grid_rep

    directions, origins, near, far, grid_idx, scaffold = geom[:6]
    grid_flat, cgrid_flat, mlp, _ = diff
    mlp_numel = mlp.numel()
    R = directions.shape[0]
    C = grid_flat.shape[1]
    color_chn = cfg.out_chn
    head_on_tc = rfw._kernel_width(cfg, C) > 256
    macs = macs_tc = 0
    for m, widths in enumerate((cfg.n_hidden_trunk, cfg.n_hidden_opacity,
                                cfg.n_hidden_color)):
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            # the colour head's last layer computes the rendered channels
            last = m > 0 and i == len(widths) - 2
            macs += a * (color_chn if last and m == 2 else b)
            if last and m == 2 and head_on_tc:
                macs_tc += a * color_chn
            elif not last:
                macs_tc += a * b
    corners = samples = 0
    all_sizes = cfg.grid_sizes + (cfg.color_grid_sizes or ())
    f64 = torch.float64
    with torch.no_grad():
        # a chunk of steps at a time ([R, K] points), as the plain versions
        for chunk in rmod._chunk_steps(range(cfg.tot_num_samples), R,
                                       rmod._plain_width(cfg, diff),
                                       near.is_cuda):
            t, _ = rmod._chunk_depth_delta(cfg, near, far, chunk)
            pts = rmod._step_points(cfg, origins, directions, t)
            occupied = torch.ones_like(t)
            if scaffold is not None:
                occupied = (sample_grid_rep(
                    scaffold, (cfg.scaffold_size + (1,),), pts, grid_idx,
                    True, mode="nearest")[..., 0] != 0).float()
            samples += float(occupied.sum(dtype=f64))
            keep = occupied
            if cfg.mask_out_of_bounds_samples:
                keep = keep * (pts.abs() <= 1.0).all(-1).float()
            for _, D, H, W, _ in all_sizes:
                n = keep
                for k, size in enumerate((W, H, D)):
                    if size == 1:
                        continue
                    f0 = torch.floor(((pts[..., k] + 1.0) * 0.5) * size
                                     - 0.5)
                    n = n * (((f0 >= 0) & (f0 < size)).float()
                             + ((f0 >= -1) & (f0 < size - 1)).float())
                corners += float(n.sum(dtype=f64))
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
    return ((flops_fw, bytes_fw), (flops_bw, bytes_bw), 2.0 * samples * macs,
            2.0 * samples * macs_tc)


def bound(flops, nbytes):
    """The least milliseconds the card could take, and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def tf32_bound(flops, flops_tc, nbytes):
    """A kernel's bound with the FLOPs it runs on the tensor cores,
    ``flops_tc`` (R2's weight gradient, R1's dense layers), at the TF32
    peak, three times over (the 3xTF32 split), and the rest at the FP32
    peak: where that work runs since the tensor cores took it."""
    t_ops = ((flops - flops_tc) / PEAK_FP32_FLOPS
             + 3 * flops_tc / PEAK_TF32_FLOPS)
    return 1e3 * max(t_ops, nbytes / PEAK_BYTES_PER_S)


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
    ``colour_only``, the ones the encoding gradient sees); a chunk of steps
    at a time, as the plain versions march (``renderer._chunk_steps``)."""
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
            margin = torch.minimum(margin, ratio.flatten(1).amin(-1))
        return torch.relu(x)

    def dense(x, w, b):
        return x @ w + b, x.abs() @ w.abs() + b.abs()

    rest = not colour_only
    for chunk in rmod._chunk_steps(range(cfg.tot_num_samples), len(near),
                                   rmod._plain_width(cfg, diff),
                                   near.is_cuda):
        t, _ = rmod._chunk_depth_delta(cfg, near, far, chunk)
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
        x = trunk + rmod._per_ray(enc, pts)
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


def masked_r2_parity(rmod, rfw, rbw, cfg, geom, diff, g_out, scaled=False):
    """R2 against its plain version on every ray's cotangent ``g_out``, the
    plain version under the relu masks that the kernel's recomputed forward
    took (its recording build), both from R1's ``nlt``; then the shipped
    build against the recording one.  Prints how many rays lie within
    KINK_MARGIN of a kink (the rays the end-to-end comparisons leave out);
    returns the worst max |kernel - plain|."""
    f64 = torch.float64
    with torch.no_grad():
        nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
        g_m, masks = rbw.render_bwd_cuda_relu_masks(cfg, geom, diff, nlt,
                                                    g_out)
        g_s = rbw.render_bwd_cuda(cfg, geom, diff, nlt, g_out)
        g_p = rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out,
                                   relu_masks=masks)
        geom64 = tuple(x.to(f64) if torch.is_tensor(x)
                       and x.is_floating_point() else x for x in geom)
        diff64 = tuple(None if x is None else x.to(f64) for x in diff)
        near = int((kink_margin(rmod, cfg, geom64, diff64)
                    < KINK_MARGIN).sum())
    n = geom[0].shape[0]
    print(f"    R2 vs its plain version under the kernel's relu masks, every "
          f"ray's cotangent ({near} of {n} rays lie within {KINK_MARGIN:g} "
          f"of a relu kink):")
    names = ("g_grid", "g_cgrid", "g_mlp", "g_enc")
    worst = 0.0
    for name, a, b in zip(names, g_m, g_p):
        if a is not None:
            worst = max(worst, compare(name, a, b, magnitude_scaled=scaled,
                                       max_rel=GRAD_MAX_REL)[0])
    print("    the shipped build vs the recording build:")
    for name, a, b in zip(names, g_s, g_m):
        if a is not None:
            compare(name, a, b, magnitude_scaled=scaled, max_rel=GRAD_MAX_REL)
    return worst


def phase_backward_parity(lp):
    print("== phase 3b: backward kernel vs plain PyTorch version on the card")
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    worst = masked_worst = 0.0
    rng = np.random.default_rng(1)
    kink_check(lp, rmod, rng)
    print(f"  the {len(PARITY_CASES)} configs: end to end (R1 + R2 through "
          f"lightplane_renderer) the rays within {KINK_MARGIN:g} of a relu "
          f"kink get no cotangent; R2 alone, under the kernel's relu masks, "
          f"every ray has one")
    for name, case_kw, render_kw in PARITY_CASES:
        rays, grid, dp = random_case(lp, rng, 4096, **case_kw)
        kw = {**dict(num_samples=48, gain=1.5), **render_kw}
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        n = len(rays)
        proj = [torch.randn(s, generator=gen).cuda()
                for s in [(n,), (n,), (n, 3)]]
        every_ray = tuple(p.contiguous() for p in proj)
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
        masked_worst = max(masked_worst, masked_r2_parity(
            rmod, rfw, rbw, *unsplit_march(lp, rmod, rays, grid, dp, **kw),
            every_ray, scaled))
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
    print(f"  all configs within bounds; worst max|d| {worst:.3e} end to "
          f"end, {masked_worst:.3e} under the kernel's masks")


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
        every_ray = tuple(p.contiguous() for p in proj)
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
                            grad_compare(names, g_k, g_p, g_r),
                            masked_r2_parity(rmod, rfw, rbw, cfg, geom, diff,
                                             every_ray))
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

    # each kernel on its own at the slice shape; R2 against its plain
    # version under the kernel's relu masks, every ray's cotangent
    with torch.no_grad():
        _, nlt, _ = rfw.render_fwd_cuda(cfg, geom, diff)
        g_out = tuple(p.contiguous() for p in proj)
        bw_ms = cuda_ms(lambda: rbw.render_bwd_cuda(cfg, geom, diff, nlt,
                                                    g_out))
        fw_ms = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
        torch.cuda.synchronize()
        bw_plain_ms = 1e3 * (time.perf_counter() - t0)
    print(f"  R2 alone: median {bw_ms:.3f} ms; its plain version "
          f"{bw_plain_ms:.1f} ms (one run); R1 alone: median {fw_ms:.3f} ms"
          f"  [{smi}]")
    print("  R2 at the slice shape (the module's decoder after 12 steps):")
    bw_err = masked_r2_parity(rmod, rfw, rbw, cfg, geom, diff, g_out)

    (fl_fw, by_fw), (fl_bw, by_bw), fl_wg, fl_tc = kernel_work(
        rmod, cfg, geom, diff)
    b_fw, by_fw_kind = bound(fl_fw, by_fw)
    b_bw, by_bw_kind = bound(fl_bw, by_bw)
    b_fw_tc = tf32_bound(fl_fw, fl_tc, by_fw)
    b_tc = tf32_bound(fl_bw, fl_wg, by_bw)
    print(f"  work: R1 {fl_fw / 1e9:.1f} GFLOP, {by_fw / 1e6:.2f} MB -> bound "
          f"{b_fw:.3f} ms ({by_fw_kind}); with its {fl_tc / 1e9:.1f} GFLOP "
          f"of dense layers at the TF32 peak, three passes: {b_fw_tc:.3f} ms")
    print(f"  R2 {fl_bw / 1e9:.1f} GFLOP, {by_bw / 1e6:.2f} MB -> bound "
          f"{b_bw:.3f} ms ({by_bw_kind}); with its {fl_wg / 1e9:.1f} GFLOP of "
          f"weight gradient at the TF32 peak, three passes: {b_tc:.3f} ms")
    print(f"  R1 at {fl_fw / fw_ms / 1e9:.2f} TFLOP/s, "
          f"{100 * b_fw_tc / fw_ms:.1f}% of its TF32 bound; R2 at "
          f"{fl_bw / bw_ms / 1e9:.2f} TFLOP/s, {100 * b_bw / bw_ms:.1f}% of "
          f"its bound  [{smi}]")
    return launches, dict(fw_bound=(b_fw, by_fw_kind), fw_bound_tf32=b_fw_tc,
                          bw=dict(ms=bw_ms, plain_ms=bw_plain_ms,
                                  err=bw_err, bound=(b_bw, by_bw_kind),
                                  bound_tf32=b_tc))


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
    cfg = splat_march(smod, rays, out_sizes, kw, sp, igrid, in_sizes)[0]
    geom = (rays.directions.to(d), rays.origins.to(d), rays.near.to(d),
            rays.far.to(d), rays.grid_idx)
    enc, grid = rays.encoding.to(d), igrid.to(d)
    ws, bs = _flattened_one_mlp_params_to_list(sp.mlp_params.detach().to(d),
                                               sp.n_hidden)
    margin = torch.full_like(geom[2], float("inf"))
    mask = cfg.mask_out_of_bounds_samples
    with torch.no_grad():
        # a chunk of steps at a time, as the plain versions march
        for chunk in smod._splat_chunks(cfg, geom, (enc, grid)):
            pts = smod._chunk_points(cfg, geom, chunk)
            x = sample_grid_rep(grid, cfg.input_grid_sizes, pts, geom[4],
                                mask) + enc[:, None]
            terms = sample_grid_rep(grid.abs(), cfg.input_grid_sizes, pts,
                                    geom[4], mask) + enc.abs()[:, None]
            for w, b in zip(ws[:-1], bs[:-1]):
                pre = x @ w + b
                terms = terms @ w.abs() + b.abs()
                ratio = torch.where(terms > 0, pre.abs() / terms,
                                    float("inf"))
                margin = torch.minimum(margin, ratio.flatten(1).amin(-1))
                x = terms = torch.relu(pre)
    return margin


def splat_march(smod, rays, out_sizes, kw, sp, igrid, in_sizes):
    """``(cfg, geom, diff)`` of the splat, as ``lightplane_(mlp_)splatter``
    hands them to S1 and S2 (``igrid`` already flat)."""
    cfg = smod._SplatCfg(
        kw["num_samples"], kw.get("num_samples_inf", 0),
        kw.get("mask_out_of_bounds_samples", False),
        kw.get("contract_coords", False), kw.get("disparity_at_inf", 1e-5),
        tuple(out_sizes), None if sp is None else tuple(in_sizes),
        () if sp is None else tuple(sp.n_hidden))
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    diff = (rays.encoding, igrid, None if sp is None else sp.mlp_params)
    return cfg, geom, diff


def plan_parity(cfg, geom, diff, bricks=None, inputs=False):
    """Hold S1's plan kernels (count, prefix sum, fill) exactly against
    their plain version: the counts and offsets per brick, and the runs in
    each brick once sorted (the kernel's order within a brick is its
    atomics').  With ``inputs``, the plan over the input grid-list that
    S2's pass B splats by."""
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    sizes = cfg.input_grid_sizes if inputs else None
    if bricks is None:
        bricks = sfw.pick_bricks(cfg, grid_sizes=sizes)
    shape = sfw.plan_shape(cfg, bricks, geom[0].shape[0], sizes)
    with torch.no_grad():
        plain = sfw.splat_plan_torch(cfg, geom, bricks, sizes)
        for g in range(len(bricks)):
            counts, offsets, runs = sfw.splat_plan_cuda(
                cfg, geom, diff, bricks, grid=g, inputs=inputs)
            got = sfw.canonical_runs(counts, offsets, runs)
            c_p, o_p, r_p = sfw.plan_slice(*plain, shape, g)
            assert torch.equal(counts, c_p), f"plan {g}: counts differ"
            assert torch.equal(offsets, o_p), f"plan {g}: offsets differ"
            assert torch.equal(got, r_p), f"plan {g}: runs differ"
    print(f"    {'pass B plan (input grid-list)' if inputs else 'plan'}: "
          f"bricks {bricks}, {shape.n_bricks} bricks, {plain[2].shape[0]} "
          f"runs, equal to its plain version")


def splat_parity(lp, name, rays, out_sizes, kw, sp=None, igrid=None,
                 in_sizes=None, seed=0):
    """Hold S1 and S2 against their plain versions on one config, every ray:
    S1's raw accumulators and normalised grid; the gradients of a projection
    of the normalised grid end to end (S1 + S2 under autograd); and with the
    MLP, S2 alone against its plain version replaying the relu masks that
    the kernel took (its recording build), then the shipped build against
    the recording one.  With the MLP the end-to-end gradients leave out the
    rays within KINK_MARGIN of a relu kink, where f32 gradients jump, and
    say so.  Returns the worst max |d| / max |ref|."""
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    n = len(rays)
    print(f"  {name}: {kw}")
    args = (lp, rays, out_sizes, kw, sp, igrid, in_sizes)
    worst = 0.0
    plan_parity(*splat_march(smod, rays, out_sizes, kw, sp, igrid, in_sizes))

    def check(label, a, b):
        nonlocal worst
        mx, _ = compare(label, a, b, max_rel=SPLAT_MAX_REL)
        worst = max(worst, mx / max(float(b.abs().max()), 1e-30))

    with torch.no_grad():
        fw0 = sfw.LAUNCHES
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
    e2e = args
    if sp is not None:
        keep = splat_kink_margin(rays, sp, igrid, in_sizes, out_sizes,
                                 kw) >= KINK_MARGIN
        e2e = (lp, rays[keep]) + args[2:]
        print(f"    end to end, the {n - int(keep.sum())} of {n} rays within "
              f"{KINK_MARGIN:g} of a relu kink left out:")
    bw0 = sbw.LAUNCHES
    g_k = splat_grads(*e2e, "cuda", proj)
    torch.cuda.synchronize()
    assert sbw.LAUNCHES == bw0 + 1, "the splat adjoint kernel did not run"
    g_p = splat_grads(*e2e, "torch", proj)
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), g_k, g_p):
        check(label, a, b)
    # S2 alone, every ray, on the cotangent that the normalised grid's
    # projection sends to the raw accumulator; without the MLP, also S2
    # with one (its twin: an 8 -> 16 -> C MLP from an 8-channel input
    # grid-list of the output's shapes) on the projection itself
    cfg, geom, diff = splat_march(smod, rays, out_sizes, kw, sp, igrid,
                                  in_sizes)
    g_feat = proj / w_p.clamp(min=eps)
    if sp is None:
        with torch.no_grad():
            g_s = sbw.splat_bwd_cuda(cfg, geom, diff, g_feat)[0]
            g_r = sbw.splat_bwd_torch(cfg, geom, diff, g_feat)[0]
        print(f"    S2 alone vs its plain version, all {n} rays:")
        check("g_enc", g_s, g_r)
        cfg, geom, diff = mlp_twin(lp, cfg, geom, seed)
        g_feat = proj
        print("    its MLP twin (8 -> 16 -> C, 8-channel input grid-list of "
              "the output's shapes), on the projection as g_out:")
    worst = max(worst, s2_alone(cfg, geom, diff, g_feat, scaled=sp is None))
    return worst


def mlp_twin(lp, cfg, geom, seed):
    """``(cfg, geom, diff)`` of a splat of no MLP, given an 8 -> 16 -> C
    MLP and an 8-channel input grid-list of the output's shapes, made from
    ``seed`` on the card."""
    import dataclasses

    gen = torch.Generator().manual_seed(seed)
    C = cfg.out_chn
    in_sizes = tuple(tuple(gs[:4]) + (8,) for gs in cfg.output_grid_sizes)
    sp = lp.init_splatter_params(gen, 2, 8, 16, C)
    cfg = dataclasses.replace(cfg, input_grid_sizes=in_sizes,
                              n_hidden=tuple(sp.n_hidden))
    R = geom[0].shape[0]
    enc = (torch.randn((R, 8), generator=gen) * 0.1).cuda()
    igrid = (torch.randn((cfg.v_total, 8), generator=gen) * 0.5).cuda()
    return cfg, geom, (enc, igrid, sp.mlp_params)


def s2_alone(cfg, geom, diff, g_feat, scaled=False):
    """S2 with the MLP alone on every ray against its plain version
    replaying the relu masks that the kernel took (its recording build),
    then the shipped build against the recording one, and pass B's plan
    over the input grid-list exactly; returns the worst max |d| / max
    |ref|.  ``scaled`` scales compare_one's absolute bounds by the
    gradients' magnitude, for a unit cotangent summed over every step of
    many rays (g_mlp ~1e3 at a 128^2 view of 96 steps, where f32 sums in two
    orders differ by ~1e-4 of it; the 1e-3 x max |ref| bound holds as is)."""
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw

    plan_parity(cfg, geom, diff, inputs=True)
    with torch.no_grad():
        g_m, masks = sbw.splat_bwd_cuda_relu_masks(cfg, geom, diff, g_feat)
        g_s = sbw.splat_bwd_cuda(cfg, geom, diff, g_feat)
        g_r = sbw.splat_bwd_torch(cfg, geom, diff, g_feat, relu_masks=masks)
    assert int(masks.count_nonzero()) > 0
    print(f"    S2 alone vs its plain version under the kernel's relu masks, "
          f"all {geom[0].shape[0]} rays:")
    worst = 0.0
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), g_m, g_r):
        mx, _ = compare(label, a, b, max_rel=SPLAT_MAX_REL,
                        magnitude_scaled=scaled)
        worst = max(worst, mx / max(float(b.abs().max()), 1e-30))
    print("    the shipped build vs the recording build:")
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), g_s, g_m):
        compare(label, a, b, max_rel=SPLAT_MAX_REL, magnitude_scaled=scaled)
    return worst


def phase_splat_parity(lp):
    print("== phase 6: splatter kernels (S1, S2) vs plain PyTorch versions "
          "on the card")
    from lightplane_tpu_torch.ops import splatter as smod

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
    # S1 with bricks smaller than it picks, so that every ray crosses many
    # and the halo rows of neighbouring bricks overlap in the flush; with
    # and without the MLP, and with C % 4 != 0 (scalar reductions)
    for name, out_sizes, extra, mlp, chn in (
            ("small_bricks_triplane", tri, {}, None, 16),
            ("small_bricks_mlp_mask", vox,
             dict(mask_out_of_bounds_samples=True), (8, 16, 16), 16),
            ("small_bricks_6ch_contract", [(2, 16, 16, 16, 6)],
             dict(contract_coords=True), None, 6)):
        in_sizes = [(2, 16, 16, 16, 8)] if mlp else None
        rays, sp, igrid = splat_case(lp, rng, 4096, out_sizes, batch=2,
                                     mlp=mlp, in_sizes=in_sizes)
        kw = dict(base, **extra)
        march = splat_march(smod, rays, out_sizes, kw, sp, igrid, in_sizes)
        worst = max(worst, small_brick_parity(name, *march),
                    sliced_parity(name, *march))
        if not mlp:
            march = mlp_twin(lp, *march[:2], seed=chn)
        worst = max(worst, sliced_adjoint_parity(name, *march))
    print(f"  all configs within bounds; worst max|d| / max|ref| "
          f"{worst:.3e}")


def small_brick_parity(name, cfg, geom, diff):
    """S1 and its plan with 2 x 3 x 2 bricks against the plain versions;
    returns max |d| / max |ref|."""
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    bricks = tuple(tuple(c if size > 1 else 1
                         for c, size in zip((2, 3, 2), gs[1:4]))
                   for gs in cfg.output_grid_sizes)
    print(f"  {name}: bricks {bricks}")
    plan_parity(cfg, geom, diff, bricks)
    worst = 0.0
    with torch.no_grad():
        got = sfw.splat_fwd_cuda(cfg, geom, diff, bricks=bricks)
        want = sfw.splat_fwd_torch(cfg, geom, diff)
    for label, a, b in zip(("feat", "w"), got, want):
        mx, _ = compare(label, a, b, max_rel=SPLAT_MAX_REL)
        worst = max(worst, mx / max(float(b.abs().max()), 1e-30))
    return worst


def sliced_parity(name, cfg, geom, diff):
    """S1 with run lists of at most 1000 rays' runs, so that it plans and
    splats the rays in slices (``splatter_fw.ray_slices``), against the
    plain version; returns max |d| / max |ref|."""
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    bricks = sfw.pick_bricks(cfg)
    per_ray = [sfw.plan_shape(sfw._sub_cfg(cfg, g), (b,), 1).capacity
               for g, b in enumerate(bricks)]
    kept = sfw.PLAN_MAX_RUNS
    sfw.PLAN_MAX_RUNS = 1000 * min(per_ray)
    try:
        slices = [len(sfw.ray_slices(cfg, g, b, geom[0].shape[0]))
                  for g, b in enumerate(bricks)]
        assert min(slices) > 1, slices
        with torch.no_grad():
            plans = sfw.PLAN_LAUNCHES
            got = sfw.splat_fwd_cuda(cfg, geom, diff)
            assert sfw.PLAN_LAUNCHES - plans == sum(slices)
            want = sfw.splat_fwd_torch(cfg, geom, diff)
    finally:
        sfw.PLAN_MAX_RUNS = kept
    print(f"  {name}: the rays in {slices} slices per sub-grid")
    worst = 0.0
    for label, a, b in zip(("feat", "w"), got, want):
        mx, _ = compare(label, a, b, max_rel=SPLAT_MAX_REL)
        worst = max(worst, mx / max(float(b.abs().max()), 1e-30))
    return worst


def sliced_adjoint_parity(name, cfg, geom, diff):
    """S2 with the MLP, its staging and pass B's run lists capped at a few
    hundred rays each, so that it runs its passes over slices of the rays
    (``splatter_bw.adjoint_slices``), against its plain version under the
    kernel's relu masks; returns max |d| / max |ref|."""
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    bricks = sfw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    per_ray = max(4 * cfg.tot_num_samples * cfg.n_hidden[0],
                  8 * max(sfw.plan_shape(cfg, (b,), 1, (gs,)).capacity
                          for gs, b in zip(cfg.input_grid_sizes, bricks)))
    kept = sfw.PLAN_MAX_RUNS
    sfw.PLAN_MAX_RUNS = 300 * per_ray // 8
    gen = torch.Generator().manual_seed(3)
    g_feat = torch.randn((cfg.v_total, cfg.out_chn), generator=gen).cuda()
    try:
        slices = len(sbw.adjoint_slices(cfg, bricks, geom[0].shape[0]))
        assert slices > 1, slices
        with torch.no_grad():
            got, masks = sbw.splat_bwd_cuda_relu_masks(cfg, geom, diff,
                                                       g_feat)
            want = sbw.splat_bwd_torch(cfg, geom, diff, g_feat,
                                       relu_masks=masks)
    finally:
        sfw.PLAN_MAX_RUNS = kept
    print(f"  {name}: S2 with the MLP over the rays in {slices} slices, "
          f"under its relu masks:")
    worst = 0.0
    # a unit cotangent summed over every step: bounds scaled as s2_alone's
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), got, want):
        mx, _ = compare(label, a, b, max_rel=SPLAT_MAX_REL,
                        magnitude_scaled=True)
        worst = max(worst, mx / max(float(b.abs().max()), 1e-30))
    return worst


def grid_corners_needed(cfg, geom, sizes):
    """In-bounds linear-interpolation corners of the grid-list ``sizes``
    over this run's sampled steps, and the sampled steps that have one."""
    from lightplane_tpu_torch.ops import splatter as smod

    corners = steps = 0.0
    with torch.no_grad():
        for s in range(cfg.tot_num_samples):
            pts = smod._march_points(cfg, geom, s)
            keep = torch.ones_like(pts[:, 0])
            if cfg.mask_out_of_bounds_samples:
                keep = (pts.abs() <= 1.0).all(-1).float()
            step = torch.zeros_like(keep)
            for _, D, H, W, _ in sizes:
                n = keep
                for k, size in enumerate((W, H, D)):
                    if size == 1:
                        continue
                    f0 = torch.floor(((pts[:, k] + 1.0) * 0.5) * size - 0.5)
                    n = n * (((f0 >= 0) & (f0 < size)).float()
                             + ((f0 >= -1) & (f0 < size - 1)).float())
                corners += float(n.sum())
                step = step + n
            steps += float((step > 0).sum())
    return corners, steps


def splat_mlp_work(cfg, geom):
    """(FLOPs, FLOPs on the tensor cores, bytes) S2 with the MLP must do on
    these inputs: per sampled step with an output corner the MLP's products,
    2 d_in d_out FLOPs each, on the tensor cores: every layer's input
    gradient and weight gradient, and the forward of every layer but the
    last (its output has no relu, so the adjoint needs only its input); per
    in-bounds output corner 2C (the gather of g_out) and per input corner
    4 C_in (the sample and the splat of g_in).  Bytes: every input read
    once (rays, encodings, g_out, the input grid-list, the MLP) and every
    output written once (g_enc, the input grid's gradient, g_mlp)."""
    R, C, C_in = geom[0].shape[0], cfg.out_chn, cfg.n_hidden[0]
    v_in = sum(int(np.prod(gs[:-1])) for gs in cfg.input_grid_sizes)
    n_params = sum(a * b + b for a, b in zip(cfg.n_hidden, cfg.n_hidden[1:]))
    out_corners, steps = grid_corners_needed(cfg, geom,
                                             cfg.output_grid_sizes)
    in_corners, _ = grid_corners_needed(cfg, geom, cfg.input_grid_sizes)
    macs = [a * b for a, b in zip(cfg.n_hidden, cfg.n_hidden[1:])]
    flops_tc = steps * 2.0 * (3 * sum(macs) - macs[-1])
    flops = flops_tc + out_corners * 2 * C + in_corners * 4 * C_in
    nbytes = 4 * (R * 9 + R * C_in + cfg.v_total * C + v_in * C_in
                  + n_params + R * C_in + v_in * C_in + n_params)
    return flops, flops_tc, nbytes


def splat_work(cfg, geom):
    """(FLOPs, bytes) S1 and S2 (without the MLP) must do on these inputs,
    from the corners this run's points need: each in-bounds output corner
    costs S1 2C + 1 FLOPs (C multiply-adds into the row, 1 add into w) and
    S2 2C (a multiply-add per gathered channel).  Bytes: every input read
    once and every output written once (S1: the rays and encodings in, the
    grids out; S2: the rays and the grid's gradient in, the encodings'
    gradient out)."""
    R, C, V = geom[0].shape[0], cfg.out_chn, cfg.v_total
    corners, _ = grid_corners_needed(cfg, geom, cfg.output_grid_sizes)
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


def device_breakdown(fn, smi, top=6, runs=1, groups=(), parts=None):
    """The device time of one run of ``fn`` by kernel (the mean of ``runs``
    runs), from ``torch.profiler``; prints the busiest ``top`` kernels and,
    given ``groups`` (``(label, name fragments)`` pairs), the time of each
    group's kernels (a kernel whose lower-cased name holds one of the
    fragments; the rest under "rest"), in ms into the dict ``parts`` where
    given; returns the total in ms (None where the profiler saw no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # the kernels' own rows (an operator's row repeats its kernels' time)
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((e.key, e.self_device_time_total / runs)
                   for e in prof.key_averages()
                   if e.device_type == cuda and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    total = sum(t for _, t in rows)
    if not total:
        print("  device time by kernel: not measured (the profiler saw no "
              "device time)")
        return None
    print(f"  device time of one step by kernel (torch.profiler"
          f"{f', mean of {runs} steps' if runs > 1 else ''}; "
          f"{total / 1e3:.3f} ms in all)  [{smi}]:")
    for key, t in rows[:top]:
        print(f"    {t / 1e3:9.3f} ms  {key[:100]}")
    if groups:
        sums = {label: 0.0 for label, _ in groups}
        sums["rest"] = 0.0
        for key, t in rows:
            label = next((label for label, frags in groups
                          if any(f in key.lower() for f in frags)), "rest")
            sums[label] += t
        print("  by part: " + ", ".join(
            f"{label} {t / 1e3:.3f} ms ({100 * t / total:.1f}%)"
            for label, t in sums.items()))
        if parts is not None:
            parts.update({label: t / 1e3 for label, t in sums.items()})
    return total / 1e3


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
    sfw.LAUNCHES = sbw.LAUNCHES = sfw.PLAN_LAUNCHES = 0
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
    print(f"  kernel launches over {steps} fw+bw steps: {launches}, S1's "
          f"plan {sfw.PLAN_LAUNCHES}")
    assert launches == {"splatter_fw": steps, "splatter_bw": steps}, launches
    assert sfw.PLAN_LAUNCHES == steps, sfw.PLAN_LAUNCHES
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

    # S1's own peak: its accumulators and one plan, whose run list grows
    # with the samples up to PLAN_MAX_RUNS runs and then splits the rays
    geom = (rays.directions, rays.origins, rays.near, rays.far,
            rays.grid_idx.to(torch.int32))
    diff = (enc, None, None)
    for ns in (48, 96, 192):
        cfg = smod._SplatCfg(ns, 0, False, False, 1e-5, tuple(out_sizes),
                             None, ())
        bricks = sfw.pick_bricks(cfg)
        shape = sfw.plan_shape(cfg, bricks, n)
        n_slices = len(sfw.ray_slices(cfg, 0, bricks[0], n))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            out = sfw.splat_fwd_cuda(cfg, geom, diff)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        # feat and w, one run list, and at most 12 int32 arrays of a brick
        # each (two slices' counts, offsets, item starts and temporaries)
        cap = (4 * cfg.v_total * (cfg.out_chn + 1)
               + 8 * min(shape.capacity, sfw.PLAN_MAX_RUNS)
               + 48 * (shape.n_bricks + 1) + 2**22)
        print(f"  peak allocated by S1 alone at {ns} samples: {peak} bytes "
              f"above the {base} held before it; run list bound "
              f"{8 * shape.capacity} bytes in {n_slices} slice(s) of at "
              f"most {8 * sfw.PLAN_MAX_RUNS}  [{smi}]")
        assert peak <= cap, (ns, peak, cap)

    # each kernel on its own, and its plain version once, on these inputs
    cfg = smod._SplatCfg(SPLAT_SAMPLES, 0, False, False, 1e-5,
                         tuple(out_sizes), None, ())
    bricks = sfw.pick_bricks(cfg)
    shape = sfw.plan_shape(cfg, bricks, n)
    with torch.no_grad():
        fw_ms = cuda_ms(lambda: sfw.splat_fwd_cuda(cfg, geom, diff), reps=5)
        plan_ms = cuda_ms(lambda: sfw.splat_plan_cuda(cfg, geom, diff),
                          reps=5)
        counts = sfw.splat_plan_cuda(cfg, geom, diff)[0]
        n_runs = int(counts.sum())
        rows = max(sfw._tile_rows(gs, b) for gs, b in zip(out_sizes, bricks))
        smem = sfw.splat_smem_bytes(0, 0, rows, SPLAT_VOXEL[-1],
                                    sfw._stage_chn(cfg))
        print(f"  S1's plan: bricks {bricks}, {shape.n_bricks} bricks, "
              f"{n_runs} runs ({n_runs / n:.1f} a ray, {int(counts.max())} "
              f"in the fullest brick); run list {8 * shape.capacity} bytes "
              f"(capacity {shape.capacity}), counts and offsets "
              f"{4 * (3 * shape.n_bricks + 2)} bytes; a block's shared "
              f"memory {smem} bytes ({sfw.SPLAT_WARPS} warps); the plan "
              f"alone median {plan_ms:.3f} ms  [{smi}]")
        del counts
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
    mlp = s2_mlp_alone(lp, smod, rays, gen, smi)
    gc.collect()
    torch.cuda.empty_cache()
    fw_mlp = s1_mlp_alone(lp, smod, rays, smi)
    gc.collect()
    torch.cuda.empty_cache()
    fw_mlp["launches"], mlp["launches"] = mlp_splat_step(lp, rays, smi)
    return launches, dict(
        fw=dict(ms=fw_ms, plain_ms=fw_plain_ms, err=fw_err,
                bound=(b_fw, b_fw_kind), plan_ms=plan_ms, runs=n_runs),
        bw=dict(ms=bw_ms, plain_ms=bw_plain_ms, err=bw_err,
                bound=(b_bw, b_bw_kind)),
        bw_mlp=mlp, fw_mlp=fw_mlp)


def s1_mlp_alone(lp, smod, rays, smi):
    """S1 with the MLP (its narrow build, W = 64, the MLP's 64 outputs: the
    MLP run inside the splat pass) alone at the MLP splatter's shapes over
    the headline rays:
    its time, its plain version's (one run), its error against the plain
    version and its bound (``splat_mlp_fw_work``)."""
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    cfg, geom, diff = mlp_splat_march(lp, smod, rays,
                                      torch.Generator().manual_seed(9))
    assert sfw._mlp_width(cfg) == 64
    with torch.no_grad():
        ms = cuda_ms(lambda: sfw.splat_fwd_cuda(cfg, geom, diff), warmup=1,
                     reps=5)
        feat_k, w_k = sfw.splat_fwd_cuda(cfg, geom, diff)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat_p, w_p = sfw.splat_fwd_torch(cfg, geom, diff)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
    print("  S1 with the MLP vs its plain version at the MLP splatter's "
          "shapes, every ray:")
    err = max(compare("feat", feat_k, feat_p, max_rel=SPLAT_MAX_REL,
                      magnitude_scaled=True)[0],
              compare("w", w_k, w_p, max_rel=SPLAT_MAX_REL,
                      magnitude_scaled=True)[0])
    del feat_k, w_k, feat_p, w_p
    flops, nbytes = splat_mlp_fw_work(cfg, geom)
    b_ms, b_kind = bound(flops, nbytes)
    print(f"  S1 with the MLP alone (W = 64): median {ms:.3f} ms, plain "
          f"version {plain_ms:.1f} ms (one run); work {flops / 1e9:.1f} "
          f"GFLOP, {nbytes / 1e6:.1f} MB -> bound {b_ms:.3f} ms ({b_kind})  "
          f"[{smi}]")
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=(b_ms, b_kind))


def s2_mlp_alone(lp, smod, rays, gen, smi):
    """S2 with the MLP alone at the MLP splatter's shapes over the headline
    rays: its time, its plain version's (one run), its error against the
    plain version replaying the recording build's relu masks, its bounds,
    and its own peak memory at 48, 96 and 192 samples (its staging and
    pass B's run lists stop growing at PLAN_MAX_RUNS' bytes)."""
    import dataclasses

    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    cfg, geom, diff = mlp_splat_march(lp, smod, rays, gen)
    n = geom[0].shape[0]
    g_out = (torch.randn((cfg.v_total, cfg.out_chn), generator=gen)
             * 0.01).cuda()
    peaks = {}
    for ns in (48, 96, 192):
        cfg_n = dataclasses.replace(cfg, num_samples=ns)
        bricks = sfw.pick_bricks(cfg_n, grid_sizes=cfg_n.input_grid_sizes)
        slices = len(sbw.adjoint_slices(cfg_n, bricks, n))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            out = sbw.splat_bwd_cuda(cfg_n, geom, diff, g_out)
        torch.cuda.synchronize()
        peaks[ns] = torch.cuda.max_memory_allocated() - base
        del out
        print(f"  peak allocated by S2 with the MLP alone at {ns} samples: "
              f"{peaks[ns]} bytes above the {base} held before it, the rays "
              f"in {slices} slice(s)  [{smi}]")
    # the staged g_in and g_vec and pass B's run list, each within
    # PLAN_MAX_RUNS' bytes, and 128 MiB for the outputs and the rest
    cap = 3 * 8 * sfw.PLAN_MAX_RUNS + 2**27
    assert max(peaks.values()) <= cap, (peaks, cap)
    assert abs(peaks[192] - peaks[96]) <= 0.05 * peaks[96], peaks
    with torch.no_grad():
        ms = cuda_ms(lambda: sbw.splat_bwd_cuda(cfg, geom, diff, g_out),
                     warmup=1, reps=5)
        got = sbw.splat_bwd_cuda(cfg, geom, diff, g_out)
        rec, masks = sbw.splat_bwd_cuda_relu_masks(cfg, geom, diff, g_out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sbw.splat_bwd_torch(cfg, geom, diff, g_out)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        want = sbw.splat_bwd_torch(cfg, geom, diff, g_out, relu_masks=masks)
    print("  S2 with the MLP vs its plain version under the recording "
          "build's relu masks, at the MLP splatter's shapes:")
    err = 0.0
    # sums over 2.5e7 steps: bounds scaled as s2_alone's
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), got, want):
        err = max(err, compare(label, a, b, max_rel=SPLAT_MAX_REL,
                               magnitude_scaled=True)[0])
    print("  the recording build vs the shipped one:")
    for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), rec, got):
        compare(label, a, b, max_rel=SPLAT_MAX_REL, magnitude_scaled=True)
    del got, rec, masks, want
    flops, flops_tc, nbytes = splat_mlp_work(cfg, geom)
    b_ms, b_kind = bound(flops, nbytes)
    b_tf32 = tf32_bound(flops, flops_tc, nbytes)
    print(f"  S2 with the MLP alone: median {ms:.3f} ms, plain version "
          f"{plain_ms:.1f} ms (one run); work {flops / 1e9:.1f} GFLOP "
          f"({flops_tc / 1e9:.1f} on the tensor cores), {nbytes / 1e6:.1f} "
          f"MB -> bound {b_ms:.3f} ms ({b_kind}), {b_tf32:.3f} ms with the "
          f"MLP in 3xTF32  [{smi}]")
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound=(b_ms, b_kind),
                bound_tf32=b_tf32)


def print_kernel_attrs():
    """Registers and spilled bytes per thread of each kernel build; returns
    R1's and R2's wide builds' warps a SM at phase 12's decoder by width."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw

    lib = _build.library()
    out = (ctypes.c_int * 3)()
    for name, fn in (("R1", lib.lightplane_render_fw_attrs),
                     ("R2", lib.lightplane_render_bw_attrs),
                     ("R2 recording masks", _build.library(
                         rbw.RELU_MASKS_BUILD).lightplane_render_bw_attrs)):
        for width in (32, 64):
            assert fn(width, out) == 0
            print(f"  {name} W={width}: {out[0]} registers, {out[1]} bytes "
                  f"spilled per thread")
    assert lib.lightplane_splat_fw_attrs(2, 0, out) == 0
    print(f"  S1 plan (fill pass): {out[0]} registers, {out[1]} bytes spilled "
          f"per thread")
    for name, fn in (("S1", lib.lightplane_splat_fw_attrs),
                     ("S2", lib.lightplane_splat_bw_attrs),
                     ("S2 recording masks", _build.library(
                         rbw.RELU_MASKS_BUILD).lightplane_splat_bw_attrs)):
        for mlp, width in ((0, 0), (1, 32), (1, 64)):
            assert fn(mlp, width, out) == 0
            label = f"MLP W={width}" if mlp else "no MLP"
            print(f"  {name} {label}: {out[0]} registers, {out[1]} bytes "
                  f"spilled per thread")
            if name == "S2":
                assert out[1] == 0, f"{name} {label} spills"
    for kind, label in ((2, "g_vec gather (with the MLP)"),
                        (3, "gather of 16 or 32 channels")):
        assert lib.lightplane_splat_bw_attrs(kind, 0, out) == 0
        print(f"  S2's {label}: {out[0]} registers, {out[1]} bytes spilled "
              f"per thread")
        assert out[1] == 0, f"S2's {label} spills"
    conf = (ctypes.c_int * 5)()
    widths = (ctypes.c_int * 3)(32, 32, SPLAT_VOXEL[-1])
    assert lib.lightplane_splat_bw_mlp_config(64, 2, widths, conf) == 0
    print(f"  S2 pass A at the MLP splatter's MLP (32 -> 32 -> "
          f"{SPLAT_VOXEL[-1]}): {conf[0]} warps a block, {conf[1]} blocks "
          f"resident, {conf[3]} bytes of shared memory a block, rows of "
          f"{conf[2]} partial sums")
    # the wide builds (W = 96, 128, 192, 256: csrc/renderer_wide.cuh, S1's
    # pass F and S2's pass A)
    masks = _build.library(rbw.RELU_MASKS_BUILD)
    for name, fn in (("R1", lib.lightplane_render_fw_attrs),
                     ("R2", lib.lightplane_render_bw_attrs),
                     ("R2 recording masks", masks.lightplane_render_bw_attrs),
                     ("S1 MLP pass F", lambda w, o:
                      lib.lightplane_splat_fw_attrs(1, w, o)),
                     ("S2 MLP pass A", lambda w, o:
                      lib.lightplane_splat_bw_attrs(1, w, o)),
                     ("S2 MLP pass A recording masks",
                      lambda w, o: masks.lightplane_splat_bw_attrs(1, w, o))):
        # the renderer's builds go on to 384 and 512
        for width in (96, 128, 192, 256) + ((384, 512) if name[:2] in (
                "R1", "R2") else ()):
            assert fn(width, out) == 0
            print(f"  {name} W={width} (wide build): {out[0]} registers, "
                  f"{out[1]} bytes spilled per thread")
    assert lib.lightplane_splat_fw_attrs(3, 0, out) == 0
    print(f"  S1's per-step splat (pass S of the wide MLP build): {out[0]} "
          f"registers, {out[1]} bytes spilled per thread")
    print_wide_splat_plans(lib)
    return print_wide_plans(lib)


def print_wide_splat_plans(lib):
    """S1's pass F and S2's pass A at phase 12's MLP splat (W = 128 and
    96): warps a block (one block a SM), shared memory and the workspace of
    packed layers, as the C side plans them, held to the wrappers' plans."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    for width in WIDE_HIDDEN:
        nh = (WIDE_SPLAT_IN, width, width)
        widths = (ctypes.c_int * 3)(*nh)
        layers = rfw.wide_layers(2, 0, 0, nh)
        fw = (ctypes.c_int * 3)()
        assert lib.lightplane_splat_fw_mlp_config(width, 2, widths, fw) == 0
        assert tuple(fw) == (sfw.PASS_F_WARPS, sfw.pass_f_smem_bytes(width),
                             rfw.wide_pack_bytes(sfw.splat_products(
                                 layers, False))), tuple(fw)
        bw = (ctypes.c_int * 5)()
        assert lib.lightplane_splat_bw_mlp_config(width, 2, widths, bw) == 0
        warps, smem = sbw.wide_a_plan(width, nh)
        assert (bw[0], bw[3], bw[4]) == (
            warps, smem, rfw.wide_pack_bytes(sfw.splat_products(
                layers, True))), tuple(bw)
        mlp = " -> ".join(map(str, nh))
        print(f"  S1 pass F at phase 12's MLP splat ({mlp}, W = {width}): "
              f"{fw[0]} warps a block and a SM, {fw[1]} bytes of shared "
              f"memory a block, a workspace of {fw[2]} bytes of packed "
              f"layers")
        print(f"  S2 pass A there: {bw[0]} warps a block and a SM, {bw[3]} "
              f"bytes of shared memory a block, a workspace of {bw[4]} "
              f"bytes; {bw[1]} rows (one a block) of {bw[2]} partial sums, "
              f"{4 * bw[1] * bw[2]} bytes")


def wide_head(hidden):
    """The n_hidden tuples of phase 12's decoder (2/2/2, 32 channels in,
    3 colours) at ``hidden``."""
    return (32, hidden, hidden, hidden, hidden, 1, hidden, hidden, 3)


def print_wide_plans(lib):
    """R1's and R2's wide builds at phase 12's decoder (2/2/2 at each of
    WIDE_HIDDEN): warps a block (one block a SM: a warp's rays march in
    lockstep with the block's), shared memory, the workspace of packed
    layers, and R2's partial-sum buffer (a row per block), each as the C
    side plans it and held to the wrapper's plan.  Returns R1's and R2's
    warps a SM by width."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    warps = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for hidden, head, where in (
            [(h, wide_head(h), f"phase 12's decoder (2/2/2, hidden {h})")
             for h in WIDE_HIDDEN]
            + [(c, feature_head(c), f"phase 13's feature decoder (2/2/2, "
                f"{c} wide, {c} colours)") for c in FEATURE_CHN]):
        widths = (ctypes.c_int * len(head))(*head)
        fw = (ctypes.c_int * 5)()
        assert lib.lightplane_render_fw_wide_config(hidden, 2, 2, 2, widths,
                                                    fw) == 0
        layers = rfw.wide_layers(2, 2, 2, head)
        assert tuple(fw[:3]) + (fw[4],) == (
            rfw.wide_fw_warps(hidden), rfw.wide_fw_smem_bytes(hidden),
            rfw.wide_pack_bytes(rfw.wide_products(layers, 2, 2, False)),
            rfw.wide_fw_scratch_bytes(hidden)), tuple(fw)
        bw = (ctypes.c_int * 6)()
        assert lib.lightplane_render_bw_wide_config(hidden, 2, 2, 2, widths,
                                                    0, bw) == 0
        plan = rbw.wide_bw_plan(hidden, 2, 2, 2, head, False)
        assert (bw[0], bw[3], bw[4], bw[2], bw[5]) == (
            plan.warps, plan.smem_bytes, plan.workspace_bytes,
            plan.row_floats, plan.scratch_bytes), (tuple(bw), plan)
        assert bw[1] == plan.partial_rows(sms), (bw[1], sms)
        print(f"  R1 wide at {where}: {fw[0]} warps a block and a SM, "
              f"{fw[1]} bytes of shared memory a block, a workspace of "
              f"{fw[2]} bytes of packed layers and {fw[3]} blocks' scratch "
              f"of {fw[4]} bytes")
        print(f"  R2 wide there: {bw[0]} warps a block and a SM, {bw[3]} "
              f"bytes of shared memory a block, a workspace of {bw[4]} "
              f"bytes and {bw[1]} blocks' scratch of {bw[5]} bytes; the "
              f"partial-sum buffer {bw[1]} rows (one a block) of {bw[2]} "
              f"floats, {4 * bw[1] * bw[2]} bytes")
        warps[hidden] = (fw[0], bw[0])
    return warps


def mlp_splat_step(lp, rays, smi):
    """The MLP splatter over the headline rays: fw+bw step with gradients
    for the encoding, the input triplane and ``mlp_params``; returns S1's
    and S2's launches over the six timed steps (the counts set to 0 just
    before)."""
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

    step()  # warm-up
    torch.cuda.synchronize()
    sfw.LAUNCHES = sbw.LAUNCHES = 0
    step_ms = cuda_ms(step, warmup=1, reps=5)
    launches = (sfw.LAUNCHES, sbw.LAUNCHES)
    assert launches == (6, 6), launches
    for x in [enc, module.mlp_params] + igrid:
        assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0
    print(f"  LightplaneMLPSplatter (MLP 32 -> 32 -> 64, 3 x 128^2 x 32ch "
          f"input triplane): fw+bw step median {step_ms:.3f} ms, "
          f"{n / step_ms * 1e3:.0f} rays/s; launches (S1, S2) {launches} "
          f"[{smi}]")
    device_breakdown(step, smi, top=10)
    return launches


def lift_splat_ms(lp, rays, out_sizes):
    """S1's and S2's times alone on lift-then-render's splat."""
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    cfg, geom, _ = splat_march(smod, rays, out_sizes,
                               dict(num_samples=96), None, None, None)
    diff = (rays.encoding.detach(), None, None)
    with torch.no_grad():
        s1 = cuda_ms(lambda: sfw.splat_fwd_cuda(cfg, geom, diff), reps=5)
        g_out = torch.randn((cfg.v_total, cfg.out_chn), device="cuda")
        s2 = cuda_ms(lambda: sbw.splat_bwd_cuda(cfg, geom, diff, g_out),
                     reps=5)
    return s1, s2


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
            s1_ms, s2_ms = lift_splat_ms(lp, rays, out_sizes)
            print(f"  alone at batch 4 (splat into 3 x {res}^2 x {chn}ch, "
                  f"96 samples): S1 median {s1_ms:.3f} ms, S2 median "
                  f"{s2_ms:.3f} ms  [{smi}]")
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
    once, R1 against its plain version and R2 against its plain version
    under the kernel's relu masks, and the bound from the samples this run's
    data needs; returns the kernel line's numbers."""
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
        t0 = time.perf_counter()
        rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
        torch.cuda.synchronize()
        bw_plain = 1e3 * (time.perf_counter() - t0)
    print(f"  {label}: R1 vs its plain version:")
    fw_err = max(compare(k, a, b)[0]
                 for k, a, b in zip(("depth", "nlt", "feat"), out_k, out_p))
    print(f"  {label}:")
    bw_err = masked_r2_parity(rmod, rfw, rbw, cfg, geom, diff, g_out)
    (fl_fw, by_fw), (fl_bw, by_bw), fl_wg, fl_tc = kernel_work(
        rmod, cfg, geom, diff)
    b_fw, b_bw = bound(fl_fw, by_fw), bound(fl_bw, by_bw)
    b_fw_tc = tf32_bound(fl_fw, fl_tc, by_fw)
    b_tc = tf32_bound(fl_bw, fl_wg, by_bw)
    print(f"  {label}: R1 alone {fw_ms:.3f} ms (plain {fw_plain:.1f} ms, one "
          f"run; bound {b_fw[0]:.3f} ms, {b_fw[1]}; {b_fw_tc:.3f} ms with "
          f"the dense layers at the TF32 peak); R2 alone {bw_ms:.3f} ms "
          f"(plain {bw_plain:.1f} ms; bound {b_bw[0]:.3f} ms, {b_bw[1]}; "
          f"{b_tc:.3f} ms with the weight gradient at the TF32 peak)"
          f"  [{smi}]")
    return dict(fw=dict(ms=fw_ms, plain_ms=fw_plain, err=fw_err, bound=b_fw,
                        bound_tf32=b_fw_tc),
                bw=dict(ms=bw_ms, plain_ms=bw_plain, err=bw_err, bound=b_bw,
                        bound_tf32=b_tc))


def pick_size(rbw, cfg, geom, diff):
    """The block size that R2's wrapper takes for these inputs."""
    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    a = rfw.launch_args(cfg, geom, diff, "pick_size")
    smem = rbw.block_smem_bytes(_build.library(), a, diff[1] is not None)
    return rbw.pick_rays_per_block(
        a.R, smem, torch.cuda.get_device_properties(0).multi_processor_count)


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
    rfw.SCAFFOLD_LAUNCHES = rbw.SCAFFOLD_LAUNCHES = 0
    fit = app.main(FIT_ARGV)
    torch.cuda.synchronize()
    launches = {"renderer_fw": rfw.LAUNCHES, "renderer_bw": rbw.LAUNCHES}
    gated = (rfw.SCAFFOLD_LAUNCHES, rbw.SCAFFOLD_LAUNCHES)
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
    print(f"  of these, passed a scaffold (R3): R1 {gated[0]}, R2 "
          f"{gated[1]}")
    # every step after the first scaffold update, and every eval after it,
    # renders with a scaffold
    assert gated == scaffold_schedule(600, h), (gated, h["scaffolds"])
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

    # the host's share of a step, with the kernels' grid_idx range check
    # read back to the host at every launch (LIGHTPLANE_CHECK_GRID_IDX=1, as
    # every launch did before the kernels checked the range themselves) and
    # without it: ms per step over 20 steps (host clock, synced) against
    # the device time of one step (torch.profiler)
    shares = {}
    for flag in ("1", "0", "1", "0"):
        os.environ["LIGHTPLANE_CHECK_GRID_IDX"] = flag
        restore_fit(fit, state)
        wall = timed_steps(fit, 20, 9) / 20
        shares.setdefault(flag, []).append(wall)
    os.environ.pop("LIGHTPLANE_CHECK_GRID_IDX")
    restore_fit(fit, state)
    device_ms = device_breakdown(fit.step, smi, top=8)
    for flag, label in (("1", "with the host range check"),
                        ("0", "without it (the default)")):
        wall = statistics.median(shares[flag])
        share = (f"host share {100 * (1 - device_ms / wall):.1f}% against "
                 f"{device_ms:.3f} ms of device time" if device_ms
                 else "host share not measured")
        print(f"  a step after the upsample, {label}: "
              f"{' '.join(f'{t:.3f}' for t in shares[flag])} ms per step "
              f"(20 steps each), {share}  [{smi}]")

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
    # R1 and R2 at 1, 2 and 4 batches, with the scaffold; R2 at each block
    # size, in turn, and at the one its wrapper picks
    for k in (1, 2, 4):
        cfg, geom, diff = unsplit_march(lp, rmod, batch_rays(k), grid, dp,
                                        scaffold=fit.scaffold, **kw)
        m = geom[0].shape[0]
        g_out = (torch.ones(m, device="cuda"), torch.ones(m, device="cuda"),
                 torch.ones((m, 3), device="cuda"))
        sizes = rbw.RAYS_PER_BLOCK
        bw_k = {r: [] for r in sizes}
        with torch.no_grad():
            nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
            fw_k = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff))
            for r in sizes + sizes[::-1]:
                bw_k[r].append(cuda_ms(lambda: rbw.render_bwd_cuda(
                    cfg, geom, diff, nlt, g_out, rays_per_block=r)))
            picked = cuda_ms(lambda: rbw.render_bwd_cuda(cfg, geom, diff,
                                                         nlt, g_out))
        by_size = ", ".join(
            f"{r} rays/block ({-(-m // r)} blocks) "
            f"{' '.join(f'{t:.3f}' for t in bw_k[r])}" for r in sizes)
        print(f"  {m} rays with the scaffold: R1 {fw_k:.3f} ms; R2 "
              f"{by_size} ms; as its wrapper picks "
              f"({pick_size(rbw, cfg, geom, diff)} rays/block) {picked:.3f} "
              f"ms  [{smi}]")
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


# ---- fitting from files (phase 10) ---------------------------------------

# Views of the synthetic scene at NeRF-synthetic's own size, written as a
# dataset directory; a view is many seconds of numpy, so one process a view.
FILES_VIEWS = 8
FILES_SIZE = 800
# The JAX app's default width (as phase 9) in whole-image mode with the
# perceptual term, one 800^2 image (640,000 rays) a step: a scaffold update
# after step 39, evals after steps 40, 80 and 120, all with the scaffold.
FILES_STEPS = 120
FILES_ARGV = ["--ray_sampling", "image", "--perceptual_weight", "0.05",
              "--n_iter", str(FILES_STEPS), "--update_scaffold_steps", "39",
              "--eval_rate", "40", "--output_dir", "build/fit_files",
              "--seed", "0"]
# The perceptual loss on the card against the same code on the CPU in f32:
# bounds on (|d value| / |value|, mean |d grad| / mean |grad|, max |d grad|
# / max |grad|) for each cuDNN precision.  In f32 the two differ in
# summation order and cuDNN's algorithms only.  TF32 (PyTorch's default for
# cuDNN, what a user's process runs) rounds each convolution's inputs to 10
# mantissa bits (2^-11 relative), which moves a value by ~1e-4 of itself
# and a gradient, through ~2 x 7 convolutions of sums that cancel, by ~1e-3
# of its mean.  Discrete decisions taken on near-ties move whole gradient
# entries instead: a relu whose pre-activation rounding moves across 0, a
# 2x2 max pool whose winner changes.  The random extractor (3 relus,
# average pooling) is held as it stands, its max to 0.1 of the largest for
# its relus.  VGG's max pools and 7 relus decide otherwise often enough
# (at 800^2 on an H100, ~3% of the windows and ~1e-4 of the relus in TF32)
# to move its gradient by 0.18 of its mean, so its gradient is held against
# the CPU given the card's pool winners and relu masks (``vgg_maps``), and
# printed as it stands, with the decisions that differ counted.
PERCEPTUAL_TOL = {"f32": (1e-4, 1e-4, 0.1), "tf32": (1e-2, 1e-2, 0.1)}
# the step's device time in parts, by kernel name: R2 is its march and the
# sum of its blocks' weight-gradient rows; cuDNN's convolution kernels are
# named for their tiles (sm90_xmma_..., cutlass_...)
FIT_PARTS = (("R1", ("render_fw_kernel",)),
             ("R2", ("render_bw_kernel", "reduce_mlp_grad_kernel")),
             ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                               "xmma", "cutlass", "implicit", "winograd",
                               "nchw", "nhwc")))


def scaffold_schedule(n_iter, h):
    """R1's and R2's launches that a trainer run of ``n_iter`` steps with
    history ``h`` passes a scaffold: the steps after the first scaffold
    update, and the evals made after it (an eval after step ``s`` is
    recorded as ``s + 1``)."""
    s0 = h["scaffolds"][0][0]
    gated = n_iter - (s0 + 1)
    return gated + sum(e[0] > s0 for e in h["evals"]), gated


def write_scene_files(root, n_views, size):
    """``n_views`` views of the synthetic scene at ``size``^2 as RGBA PNGs
    (the colour over black divided by the opacity, as Blender writes them),
    in NeRF-synthetic layout under ``root/nerf`` and NSVF layout under
    ``root/nsvf``; returns the written pixels and the two directories."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from lightplane_tpu_torch.examples.datasets import synthetic_view
    from lightplane_tpu_torch.utils.cameras import sphere_cameras
    from lightplane_tpu_torch.utils.io_utils import save_image, to_uint8

    c2ws = sphere_cameras(n_views, radius=3.0)
    # a thread a view: numpy's array work runs outside the GIL
    with ThreadPoolExecutor(min(n_views, os.cpu_count() or 1)) as pool:
        views = list(pool.map(synthetic_view, c2ws, [size] * n_views))
    nerf, nsvf = os.path.join(root, "nerf"), os.path.join(root, "nsvf")
    for d in ("pose", "rgb"):
        os.makedirs(os.path.join(nsvf, d))
    frames, pixels = [], []
    for i, (c2w, (img, alpha)) in enumerate(zip(c2ws, views)):
        a = alpha[..., None]
        color = np.clip((img - (1.0 - a)) / np.maximum(a, 1e-6), 0.0, 1.0)
        px = to_uint8(np.concatenate([color, a], axis=-1))
        pixels.append(px)
        path = os.path.join(nerf, "train", f"r_{i}.png")
        save_image(path, px)
        shutil.copy(path, os.path.join(nsvf, "rgb", f"0_{i:04d}.png"))
        np.savetxt(os.path.join(nsvf, "pose", f"0_{i:04d}.txt"), c2w)
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
    with open(os.path.join(nerf, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 2 * float(np.arctan(0.5 / 1.2)),
                   "frames": frames}, f)
    with open(os.path.join(nsvf, "intrinsics.txt"), "w") as f:
        f.write(f"{1.2 * size} {size / 2} {size / 2} 0.\n0. 0. 0.\n1.\n")
    return pixels, nerf, nsvf


def vgg_maps(fn, img_chw, blocks, decisions=None):
    """``VGG16Features.forward`` of ``fn`` step by step: ``(the block maps,
    the maps each 2x2 max pool took, (each pool's winners, each relu's
    mask))``, a winner the index of its window's max in the map, as
    ``max_pool2d`` returns it, a mask where the relu passes.  With
    ``decisions`` given, each pool is a gather at its winners and each relu
    a product with its mask (a relu where the mask is None): the same
    function up to rounding, with the gradient routed as those decisions
    route it."""
    import torch.nn.functional as F

    from lightplane_tpu_torch.utils.nnfm_loss import _VGG16_CFG

    x = fn.normalize(img_chw)
    feats, pre, winners, masks, li = [], [], [], [], 0
    for bi in range(max(blocks) + 1):
        for _ in _VGG16_CFG[bi]:
            x = F.conv2d(x, getattr(fn, f"w{li}"), getattr(fn, f"b{li}"),
                         padding=1)
            m = None if decisions is None else decisions[1][li]
            if m is None:
                m, x = x > 0, F.relu(x)
            else:
                x = x * m
            masks.append(m)
            li += 1
        if bi in blocks:
            feats.append(x[0])
        if bi == max(blocks):
            break
        pre.append(x)
        if decisions is None:
            x, i = F.max_pool2d(x, 2, return_indices=True)
        else:
            i = decisions[0][bi]
            x = x.flatten(2).gather(2, i.flatten(2)).view(i.shape)
        winners.append(i)
    return feats, pre, (winners, masks)


class _GivenDecisions:
    """A ``features_fn`` for ``perceptual_loss`` that runs ``vgg_maps``
    with the decisions of each image in turn (the prediction's, then the
    target's)."""

    def __init__(self, fn, decisions):
        self.fn, self.decisions = fn, list(decisions)

    def __call__(self, img_chw, blocks):
        return vgg_maps(self.fn, img_chw, blocks, self.decisions.pop(0))[0]


def pool_flips(pre_cpu, pre_card, cpu, card):
    """Each max pool's windows whose winner on the card differs from the
    CPU's (``pre_*``: the maps the pools took, ``cpu`` and ``card``: the
    winners): ``(windows, differing, of them ties on the CPU, largest gap,
    unexplained)``.  A tie is a window whose four CPU values are equal; the
    gap, the CPU's winner's value less the card's winner's, over the map's
    RMS; a differing winner is explained where the gap is within the two
    maps' own differences at the two pixels (as it must be if the card's
    pool took its own map's max)."""
    import torch.nn.functional as F

    out = []
    for x, xg, ic, ig in zip(pre_cpu, pre_card, cpu, card):
        xg, ig = xg.cpu(), ig.cpu()
        diff = ic != ig
        xf, d = x.flatten(2), (xg - x).abs().flatten(2)
        gap = (xf.gather(2, ic.flatten(2))
               - xf.gather(2, ig.flatten(2))).view(ic.shape)[diff]
        slack = (d.gather(2, ic.flatten(2))
                 + d.gather(2, ig.flatten(2))).view(ic.shape)[diff]
        spread = (F.max_pool2d(x, 2) + F.max_pool2d(-x, 2))[diff]
        rms = float(x.square().mean().sqrt())
        out.append((ic.numel(), int(diff.sum()), int((spread == 0).sum()),
                    float(gap.max()) / rms if gap.numel() else 0.0,
                    int((gap > slack + 1e-6 * rms).sum())))
    return out


def perceptual_parity(label, kind, pred, tgt, fn_gpu, fn_cpu, blocks, smi):
    """``perceptual_loss(pred, tgt)`` and its gradient w.r.t. ``pred`` on
    the card, with cuDNN in TF32 and in f32, against the CPU in f32, within
    ``PERCEPTUAL_TOL[precision]``; prints each error and the fw+bw time.
    For VGG (``kind == "vgg"``) the gradient is held against the CPU given
    the card's max-pool winners and relu masks (``vgg_maps``), and the
    windows and relus that decide otherwise than on the CPU are counted."""
    from lightplane_tpu_torch.utils.metrics import perceptual_loss

    def run(p, t, fn):
        p = p.detach().clone().requires_grad_(True)
        v = perceptual_loss(p, t, fn, blocks=blocks)
        v.backward()
        return float(v.detach()), p.grad.double().cpu().numpy()

    def errors(v, g, v_ref, g_ref):
        d = np.abs(g - g_ref)
        return (abs(v - v_ref) / abs(v_ref),
                float(d.mean()) / float(np.abs(g_ref).mean()),
                float(d.max()) / float(np.abs(g_ref).max()))

    images = (pred, tgt)
    v_ref, g_ref = run(pred.cpu(), tgt.cpu(), fn_cpu)
    if kind == "vgg":
        with torch.no_grad():
            cpu = [vgg_maps(fn_cpu, im.cpu().permute(2, 0, 1), blocks)[1:]
                   for im in images]
    held = []
    try:
        for prec, tf32 in (("tf32", True), ("f32", False)):
            torch.backends.cudnn.allow_tf32 = tf32
            v, g = run(pred, tgt, fn_gpu)
            d_val, d_mean, d_max = errors(v, g, v_ref, g_ref)
            ms = cuda_ms(lambda: run(pred, tgt, fn_gpu), warmup=1, reps=5)
            print(f"  {label}, blocks {blocks}, convolutions in {prec}: value "
                  f"{v:.6f} (CPU f32 {v_ref:.6f}, rel {d_val:.2e}); "
                  f"gradient max |d| {d_max:.2e} x max |g|, mean |d| "
                  f"{d_mean:.2e} x mean |g|; fw+bw {ms:.3f} ms  [{smi}]")
            if kind == "vgg":
                card, unexplained = [], 0
                for name, im, (pre, (wc, mc)) in zip(("prediction", "target"),
                                                     images, cpu):
                    with torch.no_grad():
                        _, pre_g, (wg, mg) = vgg_maps(
                            fn_gpu, im.permute(2, 0, 1), blocks)
                    for k, (n, nd, ties, gap, bad) in enumerate(
                            pool_flips(pre, pre_g, wc, wg)):
                        unexplained += bad
                        print(f"    {name}, pool {k}: {nd} of {n} windows "
                              f"take another winner than on the CPU, {ties} "
                              f"of them ties there, {bad} not explained by "
                              f"the maps' difference; largest gap {gap:.2e} "
                              f"x the map's RMS")
                    flips = [int((a != b.cpu()).sum()) for a, b in zip(mc, mg)]
                    print(f"    {name}, relus passing on one side only, by "
                          f"layer: {flips} of {[a.numel() for a in mc]}")
                    card.append(([w.cpu() for w in wg],
                                 [m.cpu() for m in mg]))
                    del pre_g
                assert unexplained == 0, (label, prec, unexplained)
                _, g_w = run(pred.cpu(), tgt.cpu(), _GivenDecisions(
                    fn_cpu, [(w, [None] * len(m)) for w, m in card]))
                _, d_w_mean, d_w_max = errors(v, g, v_ref, g_w)
                _, g_d = run(pred.cpu(), tgt.cpu(), _GivenDecisions(
                    fn_cpu, card))
                _, d_mean, d_max = errors(v, g, v_ref, g_d)
                print(f"    against the CPU given the card's pool winners: "
                      f"gradient max |d| {d_w_max:.2e} x max |g|, mean |d| "
                      f"{d_w_mean:.2e} x mean |g|; given its winners and "
                      f"relu masks: max |d| {d_max:.2e}, mean |d| "
                      f"{d_mean:.2e}")
            held.append((prec, d_val, d_mean, d_max))
    finally:
        torch.backends.cudnn.allow_tf32 = False   # phase 1's setting
    for prec, *errs in held:
        for err, tol in zip(errs, PERCEPTUAL_TOL[prec]):
            assert err <= tol, (label, prec, errs)


def phase_fit_files(lp, smi):
    print(f"== phase 10: fitting from files, {FILES_VIEWS} views at "
          f"{FILES_SIZE}^2 through the dataset loaders, whole-image steps "
          f"with the perceptual term")
    import importlib.util
    import tempfile

    from lightplane_tpu_torch.examples import fit_single_scene as app
    from lightplane_tpu_torch.examples.datasets import auto_dataset
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.utils import metrics, nnfm_loss

    has_pil = importlib.util.find_spec("PIL") is not None
    pil_before = "PIL" in sys.modules
    print(f"  PIL importable on this machine: {has_pil}")
    with tempfile.TemporaryDirectory() as tmp:
        # 1. the dataset, in two layouts, through auto_dataset
        t0 = time.perf_counter()
        pixels, nerf, nsvf = write_scene_files(tmp, FILES_VIEWS, FILES_SIZE)
        print(f"  wrote {FILES_VIEWS} RGBA views of {FILES_SIZE}^2 in "
              f"NeRF-synthetic and NSVF layout in "
              f"{time.perf_counter() - t0:.1f} s ({FILES_VIEWS} threads)")
        want = []
        for px in pixels:   # the written pixels, composited over white
            a = px.astype(np.float32) / 255.0
            want.append((a[..., :3] * a[..., 3:] + (1.0 - a[..., 3:]))
                        .reshape(-1, 3))
        want = np.concatenate(want)
        loaded = {}
        for name, root in (("nerf", nerf), ("nsvf", nsvf)):
            t0 = time.perf_counter()
            ds = loaded[name] = auto_dataset(root)
            print(f"  auto_dataset({name}): {ds.n_images} images "
                  f"{ds.height}x{ds.width}, {ds.origins.shape[0]} rays, near "
                  f"{ds.near} far {ds.far}, in "
                  f"{time.perf_counter() - t0:.2f} s")
            assert (ds.n_images, ds.height, ds.width) == (
                FILES_VIEWS, FILES_SIZE, FILES_SIZE)
            assert np.array_equal(ds.gt, want), f"{name}: pixels differ"
        d_rays = max(float(np.abs(getattr(loaded["nerf"], f)
                                  - getattr(loaded["nsvf"], f)).max())
                     for f in ("origins", "directions"))
        print(f"  both layouts load the written pixels exactly; their rays "
              f"differ by at most {d_rays:.2e}")
        assert d_rays <= 1e-6, d_rays
        t0 = time.perf_counter()
        half = auto_dataset(nerf, downsample=2)
        print(f"  auto_dataset(nerf, downsample=2): {half.n_images} images "
              f"{half.height}x{half.width}, {half.origins.shape[0]} rays, in "
              f"{time.perf_counter() - t0:.2f} s (LANCZOS in numpy)")
        assert (half.height, half.width) == (FILES_SIZE // 2,
                                             FILES_SIZE // 2)
        assert pil_before or "PIL" not in sys.modules, "a PNG load used PIL"

        # 2. the perceptual loss of two 800^2 images on the card
        pred = torch.as_tensor(loaded["nerf"].image(0)[2], device="cuda")
        tgt = torch.as_tensor(loaded["nsvf"].image(1)[2], device="cuda")
        del half, loaded
        perceptual_parity(
            "random conv features", "random", pred, tgt,
            nnfm_loss.random_conv_features_fn(device="cuda"),
            nnfm_loss.random_conv_features_fn(device="cpu"), (0, 1, 2), smi)
        rng = np.random.default_rng(10)
        weights, c_in, i = {}, 3, 0
        for widths in nnfm_loss._VGG16_CFG:
            for w in widths:
                weights[f"conv{i}_w"] = (rng.standard_normal(
                    (w, c_in, 3, 3)) * np.sqrt(2.0 / (9 * c_in))).astype(
                        np.float32)
                weights[f"conv{i}_b"] = np.zeros(w, np.float32)
                c_in, i = w, i + 1
        vgg_path = os.path.join(tmp, "vgg16_random.npz")
        np.savez(vgg_path, **weights)
        os.environ["LIGHTPLANE_VGG_WEIGHTS"] = vgg_path
        try:
            perceptual_parity(
                "random VGG16 (LIGHTPLANE_VGG_WEIGHTS)", "vgg", pred, tgt,
                metrics._vgg_features_fn(vgg_path, "cuda"),
                metrics._vgg_features_fn(vgg_path, "cpu"), (0, 1, 2), smi)
            ref = metrics.calc_lpips(pred.cpu(), tgt.cpu())
            for prec, tf32 in (("tf32", True), ("f32", False)):
                torch.backends.cudnn.allow_tf32 = tf32
                got = metrics.calc_lpips(pred, tgt)
                torch.backends.cudnn.allow_tf32 = False
                rel = abs(got - ref) / abs(ref)
                print(f"  calc_lpips through LIGHTPLANE_VGG_WEIGHTS (random "
                      f"VGG16, five blocks), cuDNN in {prec}: {got:.6f} "
                      f"(CPU f32 {ref:.6f}, rel {rel:.2e})")
                assert rel <= PERCEPTUAL_TOL[prec][0], (prec, rel)
        finally:
            os.environ.pop("LIGHTPLANE_VGG_WEIGHTS")
        del pred, tgt

        # 3. the port's trainer on the NeRF-synthetic directory, with cuDNN
        # at PyTorch's default (TF32), as a user's process runs it
        argv = ["--dataset_path", nerf] + FILES_ARGV
        print(f"  argv: {' '.join(argv[2:])} (the dataset in a temporary "
              f"directory); convolutions in TF32 (PyTorch's default)")
        torch.backends.cudnn.allow_tf32 = True
        try:
            rfw.LAUNCHES = rbw.LAUNCHES = 0
            rfw.SCAFFOLD_LAUNCHES = rbw.SCAFFOLD_LAUNCHES = 0
            t0 = time.perf_counter()
            fit = app.main(argv)
            torch.cuda.synchronize()
            launches = {"renderer_fw": rfw.LAUNCHES,
                        "renderer_bw": rbw.LAUNCHES,
                        "scaffold": (rfw.SCAFFOLD_LAUNCHES,
                                     rbw.SCAFFOLD_LAUNCHES)}
            print(f"  the fit took {time.perf_counter() - t0:.1f} s, the "
                  f"dataset's load included")
            h = fit.history
            print(f"  kernel launches over the fit: {launches} (scaffold: "
                  f"R1's and R2's launches passed a scaffold, R3)")
            assert launches == {"renderer_fw": FILES_STEPS + len(h["evals"]),
                                "renderer_bw": FILES_STEPS,
                                "scaffold": scaffold_schedule(FILES_STEPS, h)
                                }, (launches, h["scaffolds"])
            for a, b, ms in h["segments"]:
                print(f"  steps {a}-{b}: {ms:.3f} ms per step  [{smi}]")
            print(f"  scaffold occupancy: {h['scaffolds']}; evals (step, "
                  f"PSNR, SSIM): {h['evals']}")
            first, last = h["evals"][0], h["evals"][-1]
            assert np.isfinite(last[1]) and last[1] > first[1], (first, last)

            # a step's device time by part, the host's share, peak memory
            device_ms = device_breakdown(fit.step, smi, top=14, runs=3,
                                         groups=FIT_PARTS)
            wall = timed_steps(fit, 5, 13) / 5
            share = (f"host share {100 * (1 - device_ms / wall):.1f}%"
                     if device_ms else "host share not measured")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fit.step()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            print(f"  a step at the fitted state: {wall:.3f} ms (5 steps, "
                  f"host clock), {share}; peak allocated {peak} bytes, "
                  f"{peak - base} above the {base} held before it  [{smi}]")
        finally:
            torch.backends.cudnn.allow_tf32 = False   # phase 1's setting
    del fit
    return launches


# csrc/march_common.cuh's LIGHTPLANE_ABLATE bits of each kernel's variants:
# R1's grid sampling or decoder MLP switched off; R2's grid-gradient atomics
# scalar or switched off, its MLP weight-gradient pass switched off; S1's
# plan alone (no splat pass), or plan and tile sums without the flush; S2
# without the input grid's gradient, without the MLP's weight gradient, or
# the gather of the output gradient alone
ABLATIONS = {
    "R1": {"no_sampling": 8, "no_mlp": 16, "neither": 24},
    "R2": {"scalar_atomics": 1, "no_atomics": 2, "no_wgrad": 4,
           "neither": 6},
    # the wide builds (csrc/renderer_wide.cuh) at W = 128
    "R1w": {"no_sampling": 8, "no_mlp": 16, "neither": 24},
    "R2w": {"no_atomics": 2, "no_wgrad": 4, "neither": 6},
    "S1": {"plan_alone": 32, "no_flush": 64},
    "S2": {"no_scatter": 128, "no_wgrad": 256, "gather_only": 512},
    # S1 and S2 with the MLP at W = 128, at phase 12c's MLP splat
    "S1w": {"plan_alone": 32, "no_flush": 64},
    "S2w": {"no_scatter": 128, "no_wgrad": 256, "gather_only": 512},
}
# the parts of S1's and S2's wide MLP builds by kernel name
# (device_breakdown's groups)
S1W_PARTS = (("pass F", ("splat_mlp_wide",)), ("pre-pass", ("pack_wide",)),
             ("plans", ("splat_plan_kernel",)),
             ("splat passes", ("splat_fw_kernel",)))
S2W_PARTS = (("gather", ("splat_bw_enc_kernel",)),
             ("pass A", ("splat_bw_mlp",)), ("pre-pass", ("pack_wide",)),
             ("plans", ("splat_plan_kernel",)),
             ("pass B", ("splat_fw_kernel",)),
             ("weight-gradient sum", ("reduce_partial",)))


def time_variants(variants, fn, smi, reps=5):
    """Time ``fn(arg)`` for each variant's ``arg`` (its defines, or warps
    per block), twice in turn, by CUDA events (the median of ``reps``
    runs), and print the times."""
    times = {name: [] for name in variants}
    with torch.no_grad():
        for _ in range(2):
            for name, defines in variants.items():
                times[name].append(cuda_ms(lambda: fn(defines), warmup=1,
                                           reps=reps))
    for name, ms in times.items():
        print(f"  {name:14s} {' '.join(f'{t:.3f}' for t in ms)} ms "
              f"(median {statistics.median(ms):.3f})  [{smi}]")


def trainer_march(lp, rmod, gen):
    """``(cfg, geom, diff)`` at phase 9's shape after the upsample, without
    the 600-step fit: 4096 rays of the synthetic scene in 8 x 8 patches (the
    trainer's sampling past 8192 cells per plane), a 3 x 128^2 x 32ch
    triplane and the trainer's decoder from its initialiser, 256 samples,
    and the fitted run's scaffold, a 1 x 64^3 one of occupancy 1.000 (PERF.md
    section 5), so that every sample outside the [-1, 1] cube is gated."""
    from lightplane_tpu_torch.examples.datasets import make_synthetic_scene
    from lightplane_tpu_torch.utils import grid_utils

    dev = "cuda"
    ds = make_synthetic_scene()
    patch, n = 8, 4096
    rng = np.random.default_rng(0)
    k = n // patch ** 2
    img = rng.integers(0, ds.n_images, k)
    py = rng.integers(0, ds.height // patch, k) * patch
    px = rng.integers(0, ds.width // patch, k) * patch
    r = np.arange(patch)
    idx = (img[:, None, None] * ds.height * ds.width
           + (py[:, None, None] + r[None, :, None]) * ds.width
           + px[:, None, None] + r[None, None, :]).reshape(-1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    module = lp.LightplaneRenderer(
        num_samples=256, color_chn=3, grid_chn=32, mlp_hidden_chn=32,
        opacity_init_bias=-5.0, bg_color=1.0, generator=gen, device=dev)
    grid = grid_utils.init_3d_representation(gen, "triplane", 128, 32,
                                             device=dev)
    directions = t(ds.directions[idx])
    with torch.no_grad():
        enc = module._get_ray_embedding(directions)
    rays = lp.Rays(directions, t(ds.origins[idx]),
                   torch.zeros(n, dtype=torch.int64, device=dev),
                   torch.full((n,), ds.near, device=dev),
                   torch.full((n,), ds.far, device=dev), enc)
    return unsplit_march(
        lp, rmod, rays, grid, module.get_decoder_params(), num_samples=256,
        gain=module.gain, scaffold=torch.ones((1, 64, 64, 64), device=dev))


def ablate(lp, smi, kernels):
    """``kernels`` (of R1, R2, S1, S2) as built and with parts switched off:
    R1 at the render headline and at phase 9's trainer shape, R2 at the
    headline, S1 at the splatter headline, S2 there and at the MLP
    splatter step; each variant built with its own
    -D, all builds started together, each timed twice in turn by CUDA
    events."""
    from concurrent.futures import ThreadPoolExecutor

    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw
    from lightplane_tpu_torch.utils import grid_utils

    variants = {k: dict(shipped=(), **{
        name: (f"LIGHTPLANE_ABLATE={bits}",)
        for name, bits in ABLATIONS[k].items()}) for k in kernels}
    builds = {d for v in variants.values() for d in v.values()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(_build.library, builds))
    print(f"  built {len(builds)} variants in {time.perf_counter() - t0:.1f} s")

    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    module = lp.LightplaneRenderer(generator=gen, device=dev, **SLICE)
    grid = grid_utils.init_3d_representation(gen, "triplane", 32,
                                             SLICE["grid_chn"], device=dev)
    rays = orbit_rays(lp, 0.0, dev)
    cfg, geom, diff = slice_march(lp, rmod, module, grid, rays)
    if "R1" in variants:
        print("== ablation: R1 with parts switched off, at the render "
              "headline")
        time_variants(variants["R1"],
                      lambda d: rfw.render_fwd_cuda(cfg, geom, diff, d), smi)
        print("== ablation: R1 with parts switched off, at the trainer's "
              "shape (4096 rays, 3 x 128^2 x 32ch, 256 samples, scaffold)")
        tr = trainer_march(lp, rmod, gen)
        time_variants(variants["R1"],
                      lambda d: rfw.render_fwd_cuda(*tr, d), smi)
        print("== R1 as built by warps (rays) per block, at both shapes")
        for label, args in (("headline", (cfg, geom, diff)),
                            ("trainer", tr)):
            time_variants(
                {f"{label} {w} warps": w for w in rfw.WARPS_PER_BLOCK},
                lambda w: rfw.render_fwd_cuda(*args, warps_per_block=w),
                smi)
    if "R2" in variants:
        print("== ablation: R2 with parts switched off, at the slice shape")
        n = len(rays)
        g_out = tuple(torch.randn(s, generator=gen).to(dev)
                      for s in [(n,), (n,), (n, 3)])
        with torch.no_grad():
            nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
        time_variants(variants["R2"], lambda d: rbw.render_bwd_cuda(
            cfg, geom, diff, nlt, g_out, d), smi)
    if "R1w" in variants or "R2w" in variants:
        _, _, r0, (cfg_w, geom_w, diff_w), g_out_w = wide_headline_inputs(
            lp, 128)
        if "R1w" in variants:
            print("== ablation: R1's wide build with parts switched off, at "
                  "the render headline with its 2/2/2 decoder at hidden 128")
            time_variants(variants["R1w"], lambda d: rfw.render_fwd_cuda(
                cfg_w, geom_w, diff_w, d), smi)
            print("== R1's wide build as built by warps (rays) per block")
            time_variants({f"{w} warps": w for w in (8, 4, 2)},
                          lambda w: rfw.render_fwd_cuda(
                              cfg_w, geom_w, diff_w, warps_per_block=w), smi)
        if "R2w" in variants:
            print("== ablation: R2's wide build with parts switched off, at "
                  "the render headline with its 2/2/2 decoder at hidden 128")
            with torch.no_grad():
                nlt_w = rfw.render_fwd_cuda(cfg_w, geom_w, diff_w)[1]
            time_variants(variants["R2w"], lambda d: rbw.render_bwd_cuda(
                cfg_w, geom_w, diff_w, nlt_w, g_out_w, d), smi, reps=2)
        del r0, cfg_w, geom_w, diff_w, g_out_w
    if "S1" in variants:
        print("== ablation: S1 with parts switched off, at the splatter "
              "headline")
        n = SPLAT_VIEWS * SPLAT_VIEW_RES ** 2
        enc = (torch.randn((n, SPLAT_VOXEL[-1]), generator=gen) * 0.1).cuda()
        rays = view_rays(lp, SPLAT_VIEWS, SPLAT_VIEW_RES, enc)
        cfg = smod._SplatCfg(SPLAT_SAMPLES, 0, False, False, 1e-5,
                             (SPLAT_VOXEL,), None, ())
        geom = (rays.directions, rays.origins, rays.near, rays.far,
                rays.grid_idx.to(torch.int32))
        time_variants(variants["S1"], lambda d: sfw.splat_fwd_cuda(
            cfg, geom, (enc, None, None), d), smi)
        print("== S1 with parts switched off, at lift-then-render's splat "
              "(4 x 512^2 rays, 96 samples, 3 x 128^2 x 32ch)")
        n4 = 4 * 512 * 512
        enc4 = (torch.randn((n4, 32), generator=gen) * 0.1).cuda()
        rays4 = view_rays(lp, 4, 512, enc4)
        cfg4, geom4, diff4 = splat_march(smod, rays4, tri_sizes(128, 32),
                                         dict(num_samples=96), None, None,
                                         None)
        time_variants(variants["S1"], lambda d: sfw.splat_fwd_cuda(
            cfg4, geom4, diff4, d), smi)
        for label, args in (("the splatter headline",
                             (cfg, geom, (enc, None, None))),
                            ("lift-then-render's splat",
                             (cfg4, geom4, diff4))):
            print(f"== S1 as built by brick, the largest that lets 1, 2, 3 "
                  f"or 4 blocks share an SM, at {label}")
            sweep = {}
            for k in range(1, 5):
                bricks = sfw.pick_bricks(args[0],
                                         budget=228 * 1024 // k - 1024)
                sweep.setdefault(f"{bricks[0]}", bricks)
            time_variants(sweep, lambda b: sfw.splat_fwd_cuda(
                *args, bricks=b), smi)
        del rays4, enc4, geom4, diff4
    if "S2" in variants:
        print("== ablation: S2 with parts switched off, at the splatter "
              "headline (no MLP: the variants build the same gather)")
        n = SPLAT_VIEWS * SPLAT_VIEW_RES ** 2
        enc = (torch.randn((n, SPLAT_VOXEL[-1]), generator=gen) * 0.1).cuda()
        rays = view_rays(lp, SPLAT_VIEWS, SPLAT_VIEW_RES, enc)
        cfg, geom, diff = splat_march(smod, rays, [SPLAT_VOXEL],
                                      dict(num_samples=SPLAT_SAMPLES), None,
                                      None, None)
        g_out = (torch.randn((cfg.v_total, cfg.out_chn), generator=gen)
                 * 0.01).cuda()
        time_variants(variants["S2"], lambda d: sbw.splat_bwd_cuda(
            cfg, geom, diff, g_out, d), smi)
        print("== ablation: S2 with parts switched off, at the MLP splatter "
              "step (MLP 32 -> 32 -> 64, 3 x 128^2 x 32ch input triplane)")
        cfg, geom, diff = mlp_splat_march(lp, smod, rays, gen)
        time_variants(variants["S2"], lambda d: sbw.splat_bwd_cuda(
            cfg, geom, diff, g_out, d), smi)
        del rays, enc, geom, diff, g_out
    if "S1w" in variants or "S2w" in variants:
        cfg, geom, diff, g_out = wide_splat_march(
            lp, smod, *wide_splat_inputs(lp, 128))
        for key, label, parts, fn in (
                ("S1w", "S1", S1W_PARTS,
                 lambda d: sfw.splat_fwd_cuda(cfg, geom, diff, d)),
                ("S2w", "S2", S2W_PARTS,
                 lambda d: sbw.splat_bwd_cuda(cfg, geom, diff, g_out, d))):
            if key not in variants:
                continue
            print(f"== ablation: {label} with the MLP at W = 128 with parts "
                  f"switched off, at phase 12c's MLP splat (32 -> 128 -> "
                  f"128 into 3 x 128^2 x 128ch)")
            time_variants(variants[key], fn, smi, reps=2)
            print(f"== {label} with the MLP at W = 128 as built, by part:")
            with torch.no_grad():
                fn(())
                device_breakdown(lambda: fn(()), smi, top=8, groups=parts)
        if "S1w" in variants:
            print("== S1 with the MLP at W = 128 as built by pass S's brick, "
                  "the largest that lets 1, 2, 3 or 4 blocks share an SM")
            sweep = {}
            for k in range(1, 5):
                bricks = sfw.pick_bricks(cfg, budget=228 * 1024 // k - 1024)
                sweep.setdefault(f"{bricks[0]}", bricks)
            time_variants(sweep, lambda b: sfw.splat_fwd_cuda(
                cfg, geom, diff, bricks=b), smi, reps=2)
        del cfg, geom, diff, g_out


def mlp_splat_march(lp, smod, rays, gen):
    """``(cfg, geom, diff)`` of phase 7's MLP splatter over ``rays``: MLP 32
    -> 32 -> 64 from ``gen``, 32-channel encodings and a 3 x 128^2 x 32ch
    input triplane, into the headline's 160^3 x 64ch grid."""
    in_sizes = tri_sizes(128, 32)
    sp = lp.init_splatter_params(gen, 2, 32, 32, SPLAT_VOXEL[-1])
    enc = (torch.randn((len(rays), 32), generator=gen) * 0.1).cuda()
    v_in = sum(int(np.prod(g[:-1])) for g in in_sizes)
    igrid = (torch.randn((v_in, 32), generator=gen) * 0.1).cuda()
    rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx, rays.near,
                   rays.far, enc)
    return splat_march(smod, rays, [SPLAT_VOXEL],
                       dict(num_samples=SPLAT_SAMPLES), sp, igrid, in_sizes)


# ---- data parallel (phase 11) ---------------------------------------------

DP_WORLD = 2
# the phase takes about a minute; a rank that outlives this has hung
DP_JOIN_TIMEOUT_S = 300
# data-parallel vs single-process gradients: the same kernels, so only the
# order of the atomics and of the ranks' sum differ
DP_GRAD_MAX_REL = 1e-3
LIFT_IMAGES, LIFT_SIZE, LIFT_RES, LIFT_CHN = 2, 512, 128, 32
LIFT_SPLAT_SAMPLES = 96
# the NCCL world's timings: rounds in turns, each the median of DP_REPS
DP_ROUNDS, DP_REPS = 2, 3


def dp_kernel_counts():
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    return rfw, rbw, sfw, sbw


def dp_reset_counts():
    for mod in dp_kernel_counts():
        mod.LAUNCHES = 0
    dp_kernel_counts()[3].MLP_LAUNCHES = 0


def dp_read_counts():
    """The launches of R1, R2, S1, S2 without the MLP and S2 with it, as
    their wrappers counted them."""
    rfw, rbw, sfw, sbw = dp_kernel_counts()
    return dict(renderer_fw=rfw.LAUNCHES, renderer_bw=rbw.LAUNCHES,
                splatter_fw=sfw.LAUNCHES,
                splatter_bw=sbw.LAUNCHES - sbw.MLP_LAUNCHES,
                splatter_bw_mlp=sbw.MLP_LAUNCHES)


def dp_rows(mesh, n):
    if mesh is None:
        return slice(0, n)
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def dp_render_workload(lp, mesh):
    """The render headline's fw+bw on this rank's rows of the rays (all of
    them without a mesh: the single-process call): one 256 x 256 orbit
    frame, a 3 x 32^2 x 32ch triplane, 256 samples, MLPs 2/2/2 at width
    32, the loss a fixed random projection of the outputs.  Returns
    ``(step, result)``: ``step()`` runs one fw+bw, ``result(out)`` this
    rank's outputs and the grid-list's and ``mlp_params``' gradients."""
    from lightplane_tpu_torch import parallel

    gen = torch.Generator().manual_seed(21)
    dp = lp.init_decoder_params(
        gen, n_layers_opacity=2, n_layers_trunk=2, n_layers_color=2,
        input_chn=SLICE["grid_chn"], hidden_chn=SLICE["mlp_hidden_chn"],
        color_chn=3, opacity_init_bias=-2.0)
    grid = [(torch.randn(s, generator=gen) * 0.1).cuda().requires_grad_(True)
            for s in _TRI]
    mlp = dp.mlp_params.requires_grad_(True)
    rays = orbit_rays(lp, 0.3, "cuda")
    n = len(rays)
    rows = dp_rows(mesh, n)
    proj = [torch.randn(s, generator=gen).cuda()[rows]
            for s in [(n,), (n,), (n, 3)]]
    kw = dict(num_samples=SLICE["num_samples"], gain=1.0)
    if mesh is None:
        render = lambda: lp.lightplane_renderer(rays, grid, dp, **kw)  # noqa
    else:
        local = parallel.shard_rays(rays, mesh)
        dp_render = parallel.data_parallel_renderer(mesh, **kw)
        render = lambda: dp_render(local, grid, dp)  # noqa: E731

    def step():
        for x in grid + [mlp]:
            x.grad = None
        out = render()
        sum((o * p).sum() for o, p in zip(out, proj)).backward()
        return out

    def result(out):
        return dict(out=[o.detach() for o in out],
                    grid=[g.grad for g in grid], mlp=mlp.grad)

    return step, result


def lift_inputs(lp):
    """``(rays, out_sizes, igrid, sp, dp)`` of phase 11's lift step, made
    from seed 22 on the card: the view rays of 2 images at 512^2 with
    per-pixel 32-channel encodings, the grid-lists' sizes 3 x 128^2 x 32ch,
    the splatter's prior input grid-list, its MLP (32 -> 32 -> 32) and the
    decoder (2/2/2 at width 32)."""
    gen = torch.Generator().manual_seed(22)
    n = LIFT_IMAGES * LIFT_SIZE * LIFT_SIZE
    chn = LIFT_CHN
    enc = (torch.randn((n, chn), generator=gen) * 0.1).cuda()
    out_sizes = tri_sizes(LIFT_RES, chn)
    igrid = [(torch.randn(s, generator=gen) * 0.1).cuda() for s in out_sizes]
    sp = lp.init_splatter_params(gen, 2, chn, chn, chn)
    dp = lp.init_decoder_params(gen, n_layers_opacity=2, n_layers_trunk=2,
                                n_layers_color=2, input_chn=chn,
                                hidden_chn=32, color_chn=3,
                                opacity_init_bias=-2.0)
    rays = view_rays(lp, LIFT_IMAGES, LIFT_SIZE, enc)
    return rays, out_sizes, igrid, sp, dp


def dp_splat_workload(lp, mesh):
    """The lift step's encodings splatted without the MLP into its
    3 x 128^2 x 32ch grid-list at 96 samples, fw+bw, the loss a fixed
    random projection of the splatted grid; this rank's rows of the rays
    (all without a mesh).  Returns ``(step, result)``: ``step()`` runs one
    fw+bw, ``result(out)`` the splatted grid-list (the same on every rank)
    and the gradient of this rank's encodings."""
    from lightplane_tpu_torch import parallel

    rays, out_sizes, _, _, _ = lift_inputs(lp)
    enc = rays.encoding.requires_grad_(True)
    n = len(rays)
    gen = torch.Generator().manual_seed(23)
    proj = [torch.randn(s, generator=gen).cuda() for s in out_sizes]
    kw = dict(num_samples=LIFT_SPLAT_SAMPLES)
    if mesh is None:
        splat = lambda: lp.lightplane_splatter(rays, out_sizes, **kw)  # noqa
    else:
        local = parallel.shard_rays(rays, mesh)
        dp_splat = parallel.data_parallel_splatter(mesh, **kw)
        splat = lambda: dp_splat(local, out_sizes)  # noqa: E731

    def step():
        enc.grad = None
        out = splat()
        sum((o * p).sum() for o, p in zip(out, proj)).backward()
        return out

    def result(out):
        return dict(splat=[o.detach() for o in out],
                    enc=[enc.grad[dp_rows(mesh, n)]])

    return step, result


def dp_lift_workload(lp, mesh):
    """``__graft_entry__.py::dryrun_multichip`` at lift-then-render's width:
    the inputs of ``lift_inputs`` lifted by the MLP splatter into
    3 x 128^2 x 32ch at 96 samples, rendered back at 256 samples, the loss
    the mean of the squared colours plus 1e-4 of the mean squared nlt over
    all the rays, then one Adam step.  This rank's rows of the rays (all
    without a mesh).  Returns ``(step, result)``: ``step()`` runs one
    training step and returns this rank's share of the loss;
    ``result(loss)`` the loss summed over the ranks and the gradients of
    the four groups (the encodings' rows of this rank)."""
    from lightplane_tpu_torch import parallel

    rays, out_sizes, igrid, sp, dp = lift_inputs(lp)
    enc = rays.encoding.requires_grad_(True)
    n = len(rays)
    for x in igrid + [sp.mlp_params, dp.mlp_params]:
        x.requires_grad_(True)
    render_rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx,
                          rays.near, rays.far)
    splat_kw = dict(num_samples=LIFT_SPLAT_SAMPLES)
    render_kw = dict(num_samples=256, gain=1.0)
    if mesh is None:
        splat = lambda: lp.lightplane_mlp_splatter(  # noqa: E731
            rays, out_sizes, sp, igrid, **splat_kw)
        render = lambda g: lp.lightplane_renderer(  # noqa: E731
            render_rays, g, dp, **render_kw)
    else:
        local, local_render = (parallel.shard_rays(r, mesh)
                               for r in (rays, render_rays))
        dp_splat = parallel.data_parallel_splatter(mesh, use_mlp=True,
                                                   **splat_kw)
        dp_render = parallel.data_parallel_renderer(mesh, **render_kw)
        splat = lambda: dp_splat(local, out_sizes, mlp_params=sp,  # noqa
                                 input_grid=igrid)
        render = lambda g: dp_render(local_render, g, dp)  # noqa: E731
    groups = dict(grid=igrid, mlp=[dp.mlp_params], splat_mlp=[sp.mlp_params],
                  enc=[enc])
    opt = torch.optim.Adam([x for xs in groups.values() for x in xs],
                           lr=1e-3)

    def step():
        opt.zero_grad()
        _, nlt, feat = render(splat())
        loss = feat.square().sum() / (3 * n) + 1e-4 * nlt.square().sum() / n
        loss.backward()
        opt.step()
        return loss

    def result(loss):
        total = loss.detach().clone()
        if mesh is not None:
            torch.distributed.all_reduce(total)
        grads = {name: [x.grad for x in xs] for name, xs in groups.items()}
        grads["enc"] = [grads["enc"][0][dp_rows(mesh, n)]]
        for name, gs in grads.items():
            assert all(torch.isfinite(g).all() for g in gs), name
            assert sum(float(g.abs().sum()) for g in gs) > 0, (
                f"{name}: no gradient")
        return dict(loss=total, **grads)

    return step, result


DP_WORKLOADS = (("render", dp_render_workload), ("splat", dp_splat_workload),
                ("lift", dp_lift_workload))


def dp_results(lp, mesh):
    """Every workload once on ``mesh`` (single-process without): their
    results and the launches of R1, R2, S1 and S2 (the counts set to 0
    just before)."""
    dp_reset_counts()
    out = {}
    for name, workload in DP_WORKLOADS:
        step, result = workload(lp, mesh)
        out[name] = result(step())
    torch.cuda.synchronize()
    return out, dp_read_counts()


def dp_splat_parity(lp):
    """Hold the splats of phase 11's path against their plain versions on
    the path's own inputs (``lift_inputs``), every ray: S1 without and with
    the MLP on its raw sums; on a fixed random cotangent, S2 without the
    MLP, and S2 with it under the recording build's relu masks with its
    bounds scaled by the gradients' magnitude (``s2_alone``, as phase 7
    holds it).  All within SPLAT_MAX_REL x max |ref|, and compare_one's
    bounds scaled by the magnitude where the sums are large."""
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.misc_utils import flatten_grid

    rays, out_sizes, igrid, sp, _ = lift_inputs(lp)
    igrid = flatten_grid(igrid)[0]
    kw = dict(num_samples=LIFT_SPLAT_SAMPLES)
    gen = torch.Generator().manual_seed(24)
    for label, mlp in (("without the MLP", None), ("with the MLP", sp)):
        args = ((lp, rays, out_sizes, kw, None, None, None) if mlp is None
                else (lp, rays, out_sizes, kw, sp, igrid, out_sizes))
        print(f"  S1 {label} vs its plain version on the lift step's "
              f"{len(rays)} rays:")
        with torch.no_grad():
            feat_k, w_k = splat_call(*args, "cuda", raw=True)
            feat_p, w_p = splat_call(*args, "torch", raw=True)
            # raw sums of 5e7 samples over 3 x 128^2 cells: a cell's weight
            # reaches thousands, so compare_one's absolute bounds scale with
            # the magnitude (as s2_alone's); the relative bound holds as is
            for name, a, b in (("feat", feat_k, feat_p), ("w", w_k, w_p)):
                mx, _ = compare(name, a, b, max_rel=SPLAT_MAX_REL,
                                magnitude_scaled=True)
                print(f"    {name}: max |d| / max |ref| "
                      f"{mx / float(b.abs().max()):.3e}")
            g_feat = (torch.randn(feat_k.shape, generator=gen) * 0.01).cuda()
        del feat_k, w_k, feat_p, w_p
        cfg, geom, diff = splat_march(smod, *args[1:])
        if mlp is None:
            print(f"  S2 {label} vs its plain version:")
            with torch.no_grad():
                g_k = sbw.splat_bwd_cuda(cfg, geom, diff, g_feat)[0]
                g_p = sbw.splat_bwd_torch(cfg, geom, diff, g_feat)[0]
            compare("g_enc", g_k, g_p, max_rel=SPLAT_MAX_REL)
            del g_k, g_p
        else:
            s2_alone(cfg, geom, diff, g_feat, scaled=True)
        del g_feat
        gc.collect()
        torch.cuda.empty_cache()


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_cpu(v) for v in x]
    return x


def dp_rank(rank, store, out_path):
    """One rank of phase 11's gloo world, on ``cuda:0`` with the other:
    every workload on this rank's half of the rays, with the kernels that
    phase 2 built."""
    import torch.distributed as dist

    import lightplane_tpu_torch as lp
    from lightplane_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=DP_WORLD)
    try:
        mesh = parallel.make_mesh(["cuda:0"] * DP_WORLD)
        results, launches = dp_results(lp, mesh)
    finally:
        dist.destroy_process_group()
    assert all(v > 0 for v in launches.values()), launches
    assert "jax" not in sys.modules, "the port imported jax"
    torch.save(dict(to_cpu(results), launches=launches), out_path)


def dp_compare(label, got, ref, mesh_rows):
    """A data-parallel run's results against the single-process ones:
    outputs (this rank's rows), the splatted grid-list (every rank's) and
    the loss within KERNEL_MAX_ABS, gradients within DP_GRAD_MAX_REL x
    max |g|."""
    for name, g in got.items():
        want = ref[name]
        if name == "out":
            for k, (a, b) in enumerate(zip(g, want)):
                compare(f"{label} out{k}", a.cuda(), b[mesh_rows])
        elif name == "splat":
            for k, (a, b) in enumerate(zip(g, want)):
                compare(f"{label} grid{k}", a.cuda(), b)
        elif name == "loss":
            compare(f"{label} loss", g.cuda().reshape(1), want.reshape(1))
        elif name == "enc":
            compare(f"{label} g_enc", g[0].cuda(), want[0][mesh_rows],
                    max_rel=DP_GRAD_MAX_REL)
        else:
            for k, (a, b) in enumerate(zip(g if isinstance(g, list) else [g],
                                           want if isinstance(want, list)
                                           else [want])):
                compare(f"{label} g_{name}{k}", a.cuda(), b,
                        max_rel=DP_GRAD_MAX_REL)


def _build_dir():
    """The kernels' build directory (phase 11's stores and results go
    there, in temporary directories)."""
    from lightplane_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _build.BUILD_DIR


def phase_data_parallel(lp, smi):
    print("== phase 11: data parallel, the render headline, a splat and a "
          "lift-then-render training step over a 2-rank gloo world on one "
          "card, then a 1-rank NCCL world")
    import tempfile

    import torch.distributed as dist

    from lightplane_tpu_torch import parallel

    with tempfile.TemporaryDirectory(dir=_build_dir()) as tmp:
        ctx = torch.multiprocessing.get_context("spawn")
        paths = [os.path.join(tmp, f"rank{r}.pt") for r in range(DP_WORLD)]
        procs = [ctx.Process(target=dp_rank,
                             args=(r, os.path.join(tmp, "store"), paths[r]))
                 for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            # the single-process references, while the ranks start
            ref, ref_launches = dp_results(lp, None)
            deadline = time.monotonic() + DP_JOIN_TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        assert not hung, f"ranks {hung} hung past {DP_JOIN_TIMEOUT_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * DP_WORLD, f"ranks exited with {codes}"
        ranks = [torch.load(path, weights_only=False) for path in paths]
    print(f"  gloo world of {DP_WORLD} on cuda:0: "
          f"{time.perf_counter() - t0:.1f} s from spawn to join; "
          f"single-process launches {ref_launches}")
    sizes = dict(render=IMAGE * IMAGE,
                 splat=LIFT_IMAGES * LIFT_SIZE * LIFT_SIZE,
                 lift=LIFT_IMAGES * LIFT_SIZE * LIFT_SIZE)
    for r, res in enumerate(ranks):
        print(f"  rank {r}: launches {res['launches']}")
        for name, n in sizes.items():
            rows = slice(r * n // DP_WORLD, (r + 1) * n // DP_WORLD)
            dp_compare(f"rank {r} {name}", res[name], ref[name], rows)
    print(f"  loss of the lift step: {float(ref['lift']['loss']):.6f}")
    # the single-process path's splats against their plain versions, so
    # that the path is not held only against itself
    dp_splat_parity(lp)

    # a 1-rank NCCL world in this process: the same path, timed
    with tempfile.TemporaryDirectory(dir=_build_dir()) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh()
            assert mesh.device == torch.device("cuda", 0), mesh.device
            got, launches = dp_results(lp, mesh)
            assert all(v > 0 for v in launches.values()), launches
            print(f"  NCCL world of 1: launches {launches}")
            for name, n in sizes.items():
                dp_compare(f"nccl {name}", got[name], ref[name], slice(0, n))
            del got, ref
            times = {}
            for name, workload in DP_WORKLOADS:
                steps = dict(plain=workload(lp, None)[0],
                             data_parallel=workload(lp, mesh)[0])
                times[name] = {k: [] for k in steps}
                # in turns: plain, data-parallel, data-parallel, plain, ...
                for rnd in range(DP_ROUNDS):
                    order = list(steps) if rnd % 2 == 0 else list(steps)[::-1]
                    for k in order:
                        times[name][k].append(cuda_ms(steps[k], warmup=1,
                                                      reps=DP_REPS))
                del steps
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    for name, label in (("render", "render headline fw+bw"),
                        ("splat", "splat fw+bw (no MLP)"),
                        ("lift", "lift-then-render step (MLP splat, "
                                 "render, Adam)")):
        t = times[name]
        plain_ms, dp_ms = (statistics.median(t[k])
                           for k in ("plain", "data_parallel"))
        rounds = {k: " ".join(f"{x:.3f}" for x in v) for k, v in t.items()}
        print(f"  {label}: data-parallel {dp_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, the wrapper's overhead "
              f"{dp_ms - plain_ms:.3f} ms (NCCL world of 1; the median of "
              f"{DP_ROUNDS} rounds in turns, each the median of {DP_REPS}: "
              f"data-parallel {rounds['data_parallel']}, plain "
              f"{rounds['plain']} ms)  [{smi}]")
    return dict(launches=launches, times=times)


# ---- widths up to 256 (phase 12) -------------------------------------------

# The render headline (phases 4 and 5: 256^2 rays, triplane 3 x 32^2 x 32ch,
# 256 samples, MLPs 2/2/2, 3 colours) with a decoder 256, 192, 128 and 96
# wide: the kernels' wide builds; held against their plain versions at
# WIDE_CHECKED (parity at 192 and 96 is the sweep's, part d)
WIDE_HIDDEN = (256, 192, 128, 96)
WIDE_CHECKED = (256, 128)
# R1 and R2 held against their plain versions on this many of the frame's
# rays, every (n / WIDE_SUBSET)-th (phase 13: FEATURE_SUBSET)
WIDE_SUBSET = FEATURE_SUBSET = 4096
# Phase 9's trainer at the JAX app's default width but a wider decoder:
# hidden 128 cut to 200 steps (a scaffold update after step 50, so that the
# scaffold gates (R3) the last 150 steps; evals after steps 100 and 200),
# and hidden 256 cut to 120 steps (a scaffold after step 30, evals after 60
# and 120); the evals with the scaffold (in_cube_psnr says why a scaffold
# lowers the PSNR).  Each: (hidden, steps, scaffold step, eval rate)
WIDE_FITS = ((128, 200, 50, 100), (256, 120, 30, 60))
# A fit step's kernels at hidden 128 and 256, by part (device_breakdown)
WIDE_FIT_PARTS = (("R1", ("render_fw_wide_kernel",)),
                  ("R2", ("render_bw_wide_kernel", "reduce_wide_sums_kernel")),
                  ("the layers' pre-pass", ("pack_wide_kernel",)))


def wide_fit_argv(hidden, steps, scaffold_at, eval_rate):
    """The trainer's argv of one of WIDE_FITS."""
    return ["--mlp_hidden_chn", str(hidden), "--n_iter", str(steps),
            "--update_scaffold_steps", str(scaffold_at), "--eval_rate",
            str(eval_rate), "--output_dir", f"build/fit_wide_{hidden}",
            "--seed", "0"]


# The MLP splat into a W-channel grid: MLP 32 -> W -> W from a 3 x 128^2 x
# 32ch prior into 3 x 128^2 x Wch (25.2 MB at 128, 50.3 MB at 256), over
# phase 7's rays (16 views x 128^2, 96 samples), at each of WIDE_HIDDEN
WIDE_SPLAT_IN = 32
# The widths in between, on phase 3's shapes (4096 rays, 48 samples):
# (name, random_case kwargs, renderer kwargs); then the MLP splat
WIDE_SWEEP = [
    ("hidden72", dict(grid_shapes=_TRI, hidden=72), {}),
    ("hidden96", dict(grid_shapes=_TRI, hidden=96), {}),
    ("grid96_hidden32", dict(grid_shapes=[(1, 16, 16, 16, 96)]), {}),
    ("hidden128_relu_field_scaffold",
     dict(grid_shapes=_TRI, hidden=128, layers=(0, 2, 2), relu_field=True),
     dict(mask_out_of_bounds_samples=True)),
    ("hidden160_layers_1_1_1",
     dict(grid_shapes=_TRI, hidden=160, layers=(1, 1, 1)), {}),
    ("grid160_hidden32", dict(grid_shapes=[(1, 16, 16, 16, 160)]), {}),
    ("hidden256_layers_3_3_3",
     dict(grid_shapes=_TRI, hidden=256, layers=(3, 3, 3)), {}),
]
WIDE_SWEEP_SPLAT = [("mlp_32_72_16", (32, 72, 16), tri_sizes(32, 16)),
                    ("mlp_32_32_100", (32, 32, 100), [(1, 24, 24, 24, 100)]),
                    ("mlp_32_160_160", (32, 160, 160), tri_sizes(24, 160))]


def ray_subset(geom, diff, idx):
    """The march inputs of the rays ``idx`` (geom's per-ray tensors and the
    encoding; the grids, the MLP and the scaffold as they are)."""
    geom = tuple(x[idx] for x in geom[:5]) + tuple(geom[5:])
    return geom, diff[:3] + (diff[3][idx],)


def wide_headline_inputs(lp, hidden):
    """The render headline's module (its 2/2/2 decoder ``hidden`` wide),
    grid, rays, march inputs ``(cfg, geom, diff)`` and a cotangent, from
    seeds."""
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    dev = "cuda"
    gen = torch.Generator().manual_seed(0)
    module = lp.LightplaneRenderer(generator=gen, device=dev,
                                   **dict(SLICE, mlp_hidden_chn=hidden))
    res, chn = 32, SLICE["grid_chn"]
    grid = [(torch.randn(s, generator=gen) * 0.1).to(dev)
            for s in [(1, 1, res, res, chn), (1, res, 1, res, chn),
                      (1, res, res, 1, chn)]]
    r0 = orbit_rays(lp, 0.0, dev)
    cfg, geom, diff = slice_march(lp, rmod, module, grid, r0)
    assert rfw._kernel_width(cfg, chn) == hidden
    n = len(r0)
    gen = torch.Generator().manual_seed(5)
    g_out = tuple(torch.randn(s, generator=gen).to(dev)
                  for s in [(n,), (n,), (n, 3)])
    return module, grid, r0, (cfg, geom, diff), g_out


def wide_headline(lp, smi, hidden=128):
    """(a): R1 and R2 at the render headline with a ``hidden``-wide decoder;
    held against their plain versions at WIDE_CHECKED, the fw+bw step timed
    at 128; their launches (the timed runs, the counts set to 0 just
    before)."""
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    module, grid, r0, (cfg, geom, diff), g_out = wide_headline_inputs(
        lp, hidden)
    check = hidden in WIDE_CHECKED
    n = len(r0)
    dp = module.get_decoder_params()
    rays_enc = lp.Rays(r0.directions, r0.origins, r0.grid_idx, r0.near,
                       r0.far, diff[3])
    proj = [g.clone() for g in g_out]
    # (warm-up, reps): at 128 (1, 5) for R1 and (1, 3) for R2; elsewhere
    # (0, 2) and (0, 1), within the script's time
    warm, reps = ((1, (5, 3)) if hidden == 128 else (0, (2, 1)))
    with torch.no_grad():
        rfw.LAUNCHES = rbw.LAUNCHES = 0
        fw_ms = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff),
                        warmup=warm, reps=reps[0])
        nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
        bw_ms = cuda_ms(lambda: rbw.render_bwd_cuda(cfg, geom, diff, nlt,
                                                    g_out), warmup=warm,
                        reps=reps[1])
        launches = {"renderer_fw": rfw.LAUNCHES, "renderer_bw": rbw.LAUNCHES}
        assert (rfw.LAUNCHES, rbw.LAUNCHES) == (
            reps[0] + warm + 1, reps[1] + warm), (rfw.LAUNCHES, rbw.LAUNCHES)
        # the plain versions timed at WIDE_CHECKED, within the script's time
        fw_plain_ms = bw_plain_ms = None
        if check:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rfw.render_fwd_torch(cfg, geom, diff)
            torch.cuda.synchronize()
            fw_plain_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
            torch.cuda.synchronize()
            bw_plain_ms = 1e3 * (time.perf_counter() - t0)
    step = ""
    if hidden == 128:
        step_ms = cuda_ms(lambda: projected_grads(
            lp, rays_enc, grid, dp, "cuda", proj,
            num_samples=cfg.num_samples, gain=module.gain), warmup=1, reps=2)
        step = f"; fw+bw step through R1 + R2 {step_ms:.3f} ms"
    plain = ((f"{fw_plain_ms:.1f} ms (one run)", f"{bw_plain_ms:.1f} ms (one "
              f"run)") if check else ("not timed", "not timed"))
    print(f"  (a) render headline, decoder 2/2/2 at hidden {hidden} (W = "
          f"{hidden}): R1 median {fw_ms:.3f} ms, plain {plain[0]}; R2 median "
          f"{bw_ms:.3f} ms, plain {plain[1]}{step}  [{smi}]")
    fw_err = bw_err = None
    if check:
        fw_err, bw_err = wide_headline_parity(rmod, rfw, rbw, cfg, geom,
                                              diff, g_out)
        wide_pack_parity(module.get_decoder_params().mlp_params.detach(),
                         wide_head(hidden))
    (fl_fw, by_fw), (fl_bw, by_bw), fl_wg, fl_tc = kernel_work(
        rmod, cfg, geom, diff)
    b_fw, by_fw_kind = bound(fl_fw, by_fw)
    b_bw, by_bw_kind = bound(fl_bw, by_bw)
    b_fw_tc = tf32_bound(fl_fw, fl_tc, by_fw)
    # the wide R2 runs all three decoder passes on the tensor cores: the
    # forward's dense layers, and every layer's input and weight gradients
    b_bw_tc = tf32_bound(fl_bw, fl_tc + 2 * fl_wg, by_bw)
    print(f"    work: R1 {fl_fw / 1e9:.1f} GFLOP ({fl_tc / 1e9:.1f} of dense "
          f"layers) -> bound {b_fw:.3f} ms ({by_fw_kind}), {b_fw_tc:.3f} ms "
          f"with the dense layers in 3xTF32; R2 {fl_bw / 1e9:.1f} GFLOP -> "
          f"bound {b_bw:.3f} ms ({by_bw_kind}), {b_bw_tc:.3f} ms with its "
          f"{(fl_tc + 2 * fl_wg) / 1e9:.1f} GFLOP of products in 3xTF32  "
          f"[{smi}]")
    return dict(
        fw=dict(ms=fw_ms, plain_ms=fw_plain_ms, err=fw_err,
                bound=(b_fw, by_fw_kind), bound_tf32=b_fw_tc),
        bw=dict(ms=bw_ms, plain_ms=bw_plain_ms, err=bw_err,
                bound=(b_bw, by_bw_kind), bound_tf32=b_bw_tc),
        launches=launches)


def wide_headline_parity(rmod, rfw, rbw, cfg, geom, diff, g_out):
    """R1 and R2 (under its relu masks) against their plain versions on
    WIDE_SUBSET of the frame's rays, evenly spread; their worst max |d|."""
    n = geom[0].shape[0]
    idx = torch.arange(0, n, n // WIDE_SUBSET,
                       device=geom[0].device)[:WIDE_SUBSET]
    geom_s, diff_s = ray_subset(geom, diff, idx)
    with torch.no_grad():
        out_k = rfw.render_fwd_cuda(cfg, geom_s, diff_s)
        out_p = rfw.render_fwd_torch(cfg, geom_s, diff_s)
    print(f"    R1 vs its plain version on {WIDE_SUBSET} of the frame's rays:")
    fw_err = max(compare(label, a, b)[0]
                 for label, a, b in zip(("depth", "nlt", "feat"), out_k, out_p))
    bw_err = masked_r2_parity(rmod, rfw, rbw, cfg, geom_s, diff_s,
                              tuple(g[idx].contiguous() for g in g_out))
    return fw_err, bw_err


def wide_pack_parity(mlp, head):
    """The wide kernels' pre-pass (R1's products and R2's) against its
    plain version (``pack_wide_torch``), bit for bit, at a 2/2/2 decoder of
    n_hidden tuples ``head``."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    lib = _build.library()
    widths = (ctypes.c_int * len(head))(*head)
    layers = rfw.wide_layers(2, 2, 2, head)
    for backward in (False, True):
        want = rfw.pack_wide_torch(mlp.cpu(), layers,
                                   rfw.wide_products(layers, 2, 2, backward))
        ws = torch.full((want.numel(),), -1, dtype=torch.int32, device="cuda")
        assert lib.lightplane_render_wide_pack(
            mlp.data_ptr(), 2, 2, 2, widths, int(backward), ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(ws.cpu().reshape(-1, 4), want), backward
    print(f"    the layers' pre-pass equals its plain version bit for bit "
          f"(R1's and R2's products, {want.numel() * 4} bytes)")


def wide_fit(lp, smi, hidden, steps, scaffold_at, eval_rate):
    """(b): the port's trainer with ``--mlp_hidden_chn hidden`` (one of
    WIDE_FITS); returns the launches of R1, R2 and R3 (those passed a
    scaffold) over the fit."""
    from lightplane_tpu_torch.examples import fit_single_scene as app
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    argv = wide_fit_argv(hidden, steps, scaffold_at, eval_rate)
    print(f"  (b) argv: {' '.join(argv)}")
    # the loss of a fixed batch of rays at the seed's initial state and
    # after the fit (forward only; outside the launch count)
    fit0 = app.SceneFit(app.parse_args(argv))
    gen = torch.Generator().manual_seed(11)
    idx = torch.randint(0, fit0.origins.shape[0], (4096,),
                        generator=gen).cuda()
    with torch.no_grad():
        loss0 = float(fit0.loss(idx)[0])
    del fit0
    rfw.LAUNCHES = rbw.LAUNCHES = 0
    rfw.SCAFFOLD_LAUNCHES = rbw.SCAFFOLD_LAUNCHES = 0
    t0 = time.perf_counter()
    fit = app.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"renderer_fw": rfw.LAUNCHES, "renderer_bw": rbw.LAUNCHES,
                "scaffold": (rfw.SCAFFOLD_LAUNCHES, rbw.SCAFFOLD_LAUNCHES)}
    h = fit.history
    with torch.no_grad():
        loss1 = float(fit.loss(idx)[0])
    for a, b, ms in h["segments"]:
        print(f"    steps {a}-{b}: {ms:.3f} ms per step  [{smi}]")
    print(f"    {wall:.1f} s for the fit; launches {launches}; scaffold "
          f"occupancy {h['scaffolds']}; evals (step, PSNR, SSIM) "
          f"{h['evals']}; loss of a fixed batch of 4096 rays {loss0:.6f} "
          f"at the start, {loss1:.6f} at the end")
    assert launches["renderer_fw"] == steps + len(h["evals"])
    assert launches["renderer_bw"] == steps
    assert min(launches["scaffold"]) > 0, launches
    assert [e[0] for e in h["evals"]] == list(
        range(eval_rate, steps + 1, eval_rate))
    first, last = h["evals"][0][1], h["evals"][-1][1]
    assert np.isfinite(last) and last > first, (first, last)
    assert loss1 < loss0, (loss0, loss1)
    # a step's device time by kernel at the fitted state (after the counts)
    parts = {}
    device_ms = device_breakdown(fit.step, smi, top=8, runs=3,
                                 groups=WIDE_FIT_PARTS, parts=parts)
    if device_ms:
        print(f"    R2's share of a step's device time: "
              f"{100 * parts['R2'] / device_ms:.1f}%")
    return launches


def splat_mlp_fw_work(cfg, geom):
    """(FLOPs, bytes) S1 with the MLP must do on these inputs: per sampled
    step with an output corner the MLP once (2 d_in d_out FLOPs a layer)
    and its input sample (2 C_in a corner), per in-bounds output corner
    2C + 1 (the channels and the weight).  Bytes: every input read once
    (rays, encodings, the input grid-list, the MLP) and every output written
    once (the feature and weight grids)."""
    R, C, C_in = geom[0].shape[0], cfg.out_chn, cfg.n_hidden[0]
    v_in = sum(int(np.prod(gs[:-1])) for gs in cfg.input_grid_sizes)
    n_params = sum(a * b + b for a, b in zip(cfg.n_hidden, cfg.n_hidden[1:]))
    out_corners, steps = grid_corners_needed(cfg, geom,
                                             cfg.output_grid_sizes)
    in_corners, _ = grid_corners_needed(cfg, geom, cfg.input_grid_sizes)
    macs = sum(a * b for a, b in zip(cfg.n_hidden, cfg.n_hidden[1:]))
    flops = steps * 2.0 * macs + in_corners * 2 * C_in + out_corners * (
        2 * C + 1)
    nbytes = 4 * (R * 9 + R * C_in + v_in * C_in + n_params
                  + cfg.v_total * (C + 1))
    return flops, nbytes


def wide_splat_inputs(lp, width):
    """(c)'s inputs at ``width``: the module (MLP 32 -> width -> width), its
    rays over phase 7's views with their encodings, the prior's sub-grids,
    the output sizes and the generator they were drawn from."""
    gen = torch.Generator().manual_seed(12)
    n = SPLAT_VIEWS * SPLAT_VIEW_RES ** 2
    c_in, hidden, c_out = WIDE_SPLAT_IN, width, width
    enc = (torch.randn((n, c_in), generator=gen) * 0.1).cuda()
    rays = view_rays(lp, SPLAT_VIEWS, SPLAT_VIEW_RES, enc)
    in_sizes, out_sizes = tri_sizes(128, c_in), tri_sizes(128, c_out)
    module = lp.LightplaneMLPSplatter(
        num_samples=SPLAT_SAMPLES, grid_chn=c_out, input_grid_chn=c_in,
        mlp_hidden_chn=hidden, mlp_n_layers=2, generator=gen)
    igrid = [(torch.randn(s, generator=gen) * 0.1).cuda().requires_grad_(True)
             for s in in_sizes]
    return module, rays, enc, igrid, in_sizes, out_sizes, gen


def wide_splat_march(lp, smod, module, rays, enc, igrid, in_sizes,
                     out_sizes, gen):
    """``(cfg, geom, diff, g_out)`` of S1 and S2 with (c)'s MLP on its
    inputs (``wide_splat_inputs``), ``g_out`` a random output gradient."""
    c_in = in_sizes[0][-1]
    sp = lp.SplatterParams(module.mlp_params.detach(), module._n_hidden)
    igrid_flat = torch.cat([g.detach().reshape(-1, c_in) for g in igrid])
    cfg, geom, diff = splat_march(smod, lp.Rays(
        rays.directions, rays.origins, rays.grid_idx, rays.near, rays.far,
        enc.detach()), out_sizes, dict(num_samples=SPLAT_SAMPLES), sp,
        igrid_flat, in_sizes)
    g_out = (torch.randn((cfg.v_total, cfg.out_chn), generator=gen)
             * 0.01).cuda()
    return cfg, geom, diff, g_out


def wide_splat(lp, smi, width=128):
    """(c): S1 and S2 with the MLP 32 -> width -> width into a grid of
    ``width`` channels over phase 7's rays: one fw+bw step of the module
    (its launches), S1 and S2 timed and by part; at WIDE_CHECKED both held
    against their plain versions on every ray, at 128 also S1's own peak
    memory and pass A's yardstick."""
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    check = width in WIDE_CHECKED
    inputs = wide_splat_inputs(lp, width)
    module, rays, enc, igrid, in_sizes, out_sizes, gen = inputs
    n, c_out = len(rays), width
    enc.requires_grad_(True)
    sfw.LAUNCHES = sbw.LAUNCHES = sbw.MLP_LAUNCHES = 0
    out = module(rays, out_sizes, igrid, return_list=False)
    out.square().sum().backward()
    torch.cuda.synchronize()
    launches = (sfw.LAUNCHES, sbw.MLP_LAUNCHES)
    assert launches == (1, 1), launches
    for x in [enc, module.mlp_params] + igrid:
        assert torch.isfinite(x.grad).all() and float(x.grad.abs().sum()) > 0
    del out
    print(f"  (c) LightplaneMLPSplatter, MLP 32 -> {width} -> {width} (W = "
          f"{width}), 3 x 128^2 x 32ch prior into 3 x 128^2 x {width}ch, {n} "
          f"rays x {SPLAT_SAMPLES} samples: one fw+bw step, launches (S1, "
          f"S2 with the MLP) {launches}")
    cfg, geom, diff, g_out = wide_splat_march(lp, smod, *inputs)
    assert sfw._mlp_width(cfg) == width
    reps = 3 if check else 1
    fw_err = bw_err = None
    with torch.no_grad():
        fw_ms = cuda_ms(lambda: sfw.splat_fwd_cuda(cfg, geom, diff),
                        warmup=1, reps=reps)
        bw_ms = cuda_ms(lambda: sbw.splat_bwd_cuda(cfg, geom, diff, g_out),
                        warmup=1, reps=reps)
        wide_splat_parts(cfg, geom, diff, g_out, smi)
        # the plain versions run (and are timed) where they are held
        fw_plain_ms = bw_plain_ms = None
        if check:
            feat_k, w_k = sfw.splat_fwd_cuda(cfg, geom, diff)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            feat_p, w_p = sfw.splat_fwd_torch(cfg, geom, diff)
            torch.cuda.synchronize()
            fw_plain_ms = 1e3 * (time.perf_counter() - t0)
            # sums of up to ~1e3 weights a cell (25M steps into 3 x 128^2
            # cells): compare_one's absolute bounds scaled by the
            # magnitude, as s2_alone's; the 1e-3 x max |ref| bound as it is
            print("    S1 with the MLP vs its plain version, every ray:")
            fw_err = max(compare("feat", feat_k, feat_p,
                                 max_rel=SPLAT_MAX_REL,
                                 magnitude_scaled=True)[0],
                         compare("w", w_k, w_p, max_rel=SPLAT_MAX_REL,
                                 magnitude_scaled=True)[0])
            del feat_k, w_k, feat_p, w_p
        masks = got = shipped = want = None
        if check:
            got, masks = sbw.splat_bwd_cuda_relu_masks(cfg, geom, diff,
                                                       g_out)
            shipped = sbw.splat_bwd_cuda(cfg, geom, diff, g_out)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = sbw.splat_bwd_torch(cfg, geom, diff, g_out,
                                       relu_masks=masks)
            torch.cuda.synchronize()
            bw_plain_ms = 1e3 * (time.perf_counter() - t0)
    if check:
        print("    S2 with the MLP vs its plain version under the recording "
              "build's relu masks, every ray:")
        bw_err = 0.0
        # sums over 2.5e7 steps: bounds scaled as s2_alone's
        for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), got, want):
            bw_err = max(bw_err, compare(label, a, b, max_rel=SPLAT_MAX_REL,
                                         magnitude_scaled=True)[0])
        print("    the shipped build vs the recording build:")
        for label, a, b in zip(("g_enc", "g_igrid", "g_mlp"), shipped, got):
            compare(label, a, b, max_rel=SPLAT_MAX_REL,
                    magnitude_scaled=True)
    del got, masks, shipped, want
    if check:
        plan_parity(cfg, geom, diff)
        wide_splat_pack_parity(diff[2], cfg.n_hidden)
    if width == 128:
        wide_splat_memory(cfg, geom, diff, smi)
        pass_a_yardstick(cfg, geom, diff, g_out, smi)
    fl_fw, by_fw = splat_mlp_fw_work(cfg, geom)
    b_fw = bound(fl_fw, by_fw)
    fl_bw, fl_tc, by_bw = splat_mlp_work(cfg, geom)
    b_bw = bound(fl_bw, by_bw)
    b_bw_tc = tf32_bound(fl_bw, fl_tc, by_bw)
    masked = ", under the masks" if check else ""
    plain = ((f"{fw_plain_ms:.1f} ms (one run)",
              f"{bw_plain_ms:.1f} ms (one run{masked})") if check
             else ("not timed", "not timed"))
    print(f"    S1 with the MLP: median {fw_ms:.3f} ms, plain {plain[0]}; "
          f"work {fl_fw / 1e9:.1f} GFLOP, {by_fw / 1e6:.1f} MB -> bound "
          f"{b_fw[0]:.3f} ms ({b_fw[1]})  [{smi}]")
    print(f"    S2 with the MLP: median {bw_ms:.3f} ms, plain {plain[1]}; "
          f"work {fl_bw / 1e9:.1f} GFLOP "
          f"({fl_tc / 1e9:.1f} on the tensor cores), {by_bw / 1e6:.1f} MB -> "
          f"bound {b_bw[0]:.3f} ms ({b_bw[1]}), {b_bw_tc:.3f} ms with the "
          f"MLP in 3xTF32  [{smi}]")
    return dict(fw=dict(ms=fw_ms, plain_ms=fw_plain_ms, err=fw_err,
                        bound=b_fw, launches=launches[0]),
                bw=dict(ms=bw_ms, plain_ms=bw_plain_ms, err=bw_err,
                        bound=b_bw, bound_tf32=b_bw_tc,
                        launches=launches[1]))


def wide_splat_parts(cfg, geom, diff, g_out, smi):
    """S1's and S2's wide MLP builds by part (``device_breakdown``: S1's
    pass F, pre-pass, plans and splat passes; S2's gathers, pass A,
    pre-pass, plans, pass B and weight-gradient sum), with their slices of
    the rays and the plans and splat passes those make."""
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    n = geom[0].shape[0]
    bricks = sfw.pick_bricks(cfg)
    fw_slices = len(sfw.mlp_slices(cfg, bricks, n))
    planes = len(cfg.output_grid_sizes)
    print(f"    S1 with the MLP: {fw_slices} slices of the rays, {fw_slices}"
          f" pass F launches, {fw_slices * planes} plans and pass S "
          f"launches (bricks {bricks}), by part:")
    device_breakdown(lambda: sfw.splat_fwd_cuda(cfg, geom, diff), smi,
                     top=6, groups=S1W_PARTS)
    in_bricks = sfw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    a_slices = sbw.adjoint_slices(cfg, in_bricks, n)
    g_slices = sum(len(sbw.gvec_slices(cfg, lo, hi)) for lo, hi in a_slices)
    print(f"    S2 with the MLP: {len(a_slices)} slices of the rays, "
          f"{g_slices} gather and pass A launches, "
          f"{len(a_slices) * len(cfg.input_grid_sizes)} plans and pass B "
          f"launches (bricks {in_bricks}), by part:")
    device_breakdown(lambda: sbw.splat_bwd_cuda(cfg, geom, diff, g_out), smi,
                     top=6, groups=S2W_PARTS)


def wide_splat_pack_parity(mlp, n_hidden):
    """The layers' pre-pass with the splatter's schedules (S1's pass F, S2's
    pass A) against its plain version, bit for bit."""
    import ctypes

    from lightplane_tpu_torch.ops.kernels import _build
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    lib = _build.library()
    L = len(n_hidden) - 1
    widths = (ctypes.c_int * len(n_hidden))(*n_hidden)
    layers = rfw.wide_layers(L, 0, 0, n_hidden)
    for schedule, backward in ((2, False), (3, True)):
        want = rfw.pack_wide_torch(mlp.cpu(), layers,
                                   sfw.splat_products(layers, backward))
        ws = torch.full((want.numel(),), -1, dtype=torch.int32, device="cuda")
        assert lib.lightplane_render_wide_pack(
            mlp.data_ptr(), L, 0, 0, widths, schedule, ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(ws.cpu().reshape(-1, 4), want), schedule
    print("    the layers' pre-pass with the splatter's schedules equals its "
          "plain version bit for bit (pass F's and pass A's products)")


def wide_splat_memory(cfg, geom, diff, smi):
    """S1's own peak memory with the MLP at 48, 96 and 192 samples: the
    staging and the run lists of a slice stay within PLAN_MAX_RUNS' bytes,
    so it stops growing with the samples."""
    import dataclasses

    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    n = geom[0].shape[0]
    peaks = {}
    for ns in (48, 96, 192):
        cfg_n = dataclasses.replace(cfg, num_samples=ns)
        slices = len(sfw.mlp_slices(cfg_n, sfw.pick_bricks(cfg_n), n))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            out = sfw.splat_fwd_cuda(cfg_n, geom, diff)
        torch.cuda.synchronize()
        peaks[ns] = torch.cuda.max_memory_allocated() - base
        del out
        print(f"    peak allocated by S1 with the MLP alone at {ns} samples: "
              f"{peaks[ns]} bytes above the {base} held before it, the rays "
              f"in {slices} slice(s)  [{smi}]")
    assert abs(peaks[192] - peaks[96]) <= 0.05 * peaks[96], peaks


def pass_a_yardstick(cfg, geom, diff, g_out, smi):
    """A yardstick on no path: S2's pass A over the first slice of its
    rays (``gvec_slices``) as f32 ``torch.matmul`` calls (TF32 off): the
    forward's relu layers, then per layer last first the weight and bias
    gradients and the input gradient through the relu mask, and the
    encoding's gradient; its input the slice's staged rows (g_vec and
    sample + encoding at every step, zero where a step is masked), timed
    beside the kernel's pass A over the same rays (device time by part)."""
    from lightplane_tpu_torch.ops import grid_sample as tgs
    from lightplane_tpu_torch.ops import splatter as smod
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw
    from lightplane_tpu_torch.ops.mlp_utils import (
        _flattened_one_mlp_params_to_list)

    assert not torch.backends.cuda.matmul.allow_tf32
    in_bricks = sfw.pick_bricks(cfg, grid_sizes=cfg.input_grid_sizes)
    lo, hi = sbw.gvec_slices(cfg, *sbw.adjoint_slices(
        cfg, in_bricks, geom[0].shape[0])[0])[0]
    geom_s = tuple(t[lo:hi] for t in geom)
    enc, igrid, mlp = diff
    steps, mask = cfg.tot_num_samples, cfg.mask_out_of_bounds_samples
    with torch.no_grad():
        gv, x0 = [], []
        for s in range(steps):
            pts = smod._march_points(cfg, geom_s, s)
            gv.append(tgs.sample_grid_rep(g_out, cfg.output_grid_sizes, pts,
                                          geom_s[4], mask))
            x0.append(tgs.sample_grid_rep(igrid, cfg.input_grid_sizes, pts,
                                          geom_s[4], mask) + enc[lo:hi])
        G0 = torch.stack(gv, 1).reshape(-1, cfg.out_chn)
        X0 = torch.stack(x0, 1).reshape(-1, cfg.n_hidden[0])
        del gv, x0
        weights, biases = _flattened_one_mlp_params_to_list(mlp,
                                                            cfg.n_hidden)

        def pass_a():
            xs = [X0]
            for w, b in zip(weights[:-1], biases[:-1]):
                xs.append(torch.relu(xs[-1] @ w + b))
            g, grads = G0, []
            for l in reversed(range(len(weights))):
                grads.append((xs[l].t() @ g, g.sum(0)))
                g = g @ weights[l].t()
                if l > 0:
                    g = g * (xs[l] > 0)
            return g.reshape(hi - lo, steps, -1).sum(1), grads

        ms = cuda_ms(pass_a, warmup=1, reps=5)
        del X0, G0
        kernel = kernel_mean_ms(lambda: sbw.splat_bwd_cuda(
            cfg, geom_s, (enc[lo:hi],) + diff[1:], g_out), "splat_bw_mlp")
    print(f"    yardstick (on no path): S2's pass A over one slice ({hi - lo}"
          f" rays x {steps} steps) as f32 torch.matmul calls (TF32 off): "
          f"median {ms:.3f} ms; the kernel's pass A over the same rays "
          f"{'not measured' if kernel is None else f'{kernel:.3f} ms'}  "
          f"[{smi}]")


def kernel_mean_ms(fn, fragment, runs=3):
    """The mean device time, in ms, of one launch of the kernels whose
    lower-cased names hold ``fragment``, over ``runs`` runs of ``fn`` under
    ``torch.profiler`` (a launch the profiler missed counts in neither the
    sum nor the launches); None where it saw none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages()
            if e.device_type == cuda and fragment in e.key.lower()]
    launches = sum(e.count for e in rows)
    if not launches:
        return None
    return sum(e.self_device_time_total for e in rows) / launches / 1e3


def wide_sweep(lp):
    """(d): R1 and R2, then S1 and S2 with the MLP, at the widths between,
    on phase 3's shapes; returns the worst errors by kernel."""
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    rng = np.random.default_rng(12)
    errs = dict(fw=0.0, bw=0.0, splat=0.0)
    for name, case_kw, render_kw in WIDE_SWEEP:
        rays, grid, dp = random_case(lp, rng, 4096, **case_kw)
        kw = dict(num_samples=48, gain=1.5, **render_kw)
        if case_kw.get("relu_field"):
            kw["color_grid"] = [torch.as_tensor(
                rng.standard_normal(s) * 0.5, dtype=torch.float32,
                device="cuda") for s in case_kw["grid_shapes"]]
            kw["scaffold"] = (torch.rand((1, 32, 32, 32), generator=torch
                                         .Generator().manual_seed(5)) > 0.3
                              ).float().cuda()
        cfg, geom, diff = unsplit_march(lp, rmod, rays, grid, dp, **kw)
        width = rfw._kernel_width(cfg, grid[0].shape[-1])
        print(f"  (d) {name}: W = {width}")
        assert width in rfw.WIDTHS[2:]
        with torch.no_grad():
            fw0 = rfw.LAUNCHES
            out_k = rfw.render_fwd_cuda(cfg, geom, diff)
            torch.cuda.synchronize()
            assert rfw.LAUNCHES == fw0 + 1
            out_p = rfw.render_fwd_torch(cfg, geom, diff)
        for label, a, b in zip(("depth", "nlt", "feat"), out_k, out_p):
            errs["fw"] = max(errs["fw"], compare(label, a, b)[0])
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        n = len(rays)
        g_out = tuple(torch.randn(s, generator=gen).cuda()
                      for s in [(n,), (n,), (n, 3)])
        errs["bw"] = max(errs["bw"], masked_r2_parity(
            rmod, rfw, rbw, cfg, geom, diff, g_out))
    for name, mlp, out_sizes in WIDE_SWEEP_SPLAT:
        in_sizes = tri_sizes(32, mlp[0])
        rays, sp, igrid = splat_case(lp, rng, 4096, out_sizes, mlp=mlp,
                                     in_sizes=in_sizes)
        errs["splat"] = max(errs["splat"], splat_parity(
            lp, f"(d) {name}", rays, out_sizes, dict(num_samples=48), sp,
            igrid, in_sizes))
    return errs


def phase_wide(lp, smi):
    print("== phase 12: the kernels' wide builds (W = 96, 128, 192, 256): "
          "decoder and grid widths past 64")
    headline = {w: wide_headline(lp, smi, w) for w in WIDE_HIDDEN}
    fit = {args[0]: wide_fit(lp, smi, *args) for args in WIDE_FITS}
    splat = {w: wide_splat(lp, smi, w) for w in WIDE_HIDDEN}
    sweep = wide_sweep(lp)
    print(f"  worst max|d| in the sweep: {sweep}")
    return dict(headline=headline, fit=fit, splat=splat, sweep=sweep)


# ---- feature fields: widths 384 and 512 (phase 13) -------------------------

# The feature-field lift-then-render at the features' own width
# (``bench.py:403-526``'s lift-then-render, with the image features that
# Distilled Feature Fields and LERF lift: 384 channels for DINO ViT-S/14,
# 512 for CLIP ViT-B/16, each pixel's feature L2-normalised as theirs are):
# FEATURE_VIEWS views of FEATURE_SIZE^2 rays with seeded features (unit
# vectors), splatted (96 samples) into a 3 x 128^2 x C triplane and
# rendered back (FEATURE_RENDER_SAMPLES) through a 2/2/2 decoder C wide with
# C colours, an L2 loss against the features.  Cut from bench's 512^2
# images and 256 render samples to 128^2 and 128, for the run's time; the
# widths are not cut.  At 512 FEATURE_STEPS Adam steps (the loss must
# fall), at 384 one; the last step of each by kernel (torch.profiler) gives
# R1's and R2's times on the path.
FEATURE_CHN = (512, 384)
FEATURE_VIEWS, FEATURE_SIZE, FEATURE_RES = 2, 128, 128
FEATURE_SPLAT_SAMPLES, FEATURE_RENDER_SAMPLES = 96, 128
FEATURE_STEPS = 5


def feature_model(lp, chn):
    """The feature path at ``chn`` channels: its rays (the features as their
    encodings), its decoder and an Adam step over the lifted encodings, a
    residual added to the lifted triplane (the grid) and the decoder;
    ``step()`` returns the loss."""
    gen = torch.Generator().manual_seed(chn)
    n = FEATURE_VIEWS * FEATURE_SIZE ** 2
    target = torch.randn((n, chn), generator=gen)
    target = (target / target.norm(dim=1, keepdim=True)).cuda()
    rays = view_rays(lp, FEATURE_VIEWS, FEATURE_SIZE, target)
    dp = lp.init_decoder_params(gen, n_layers_opacity=2, n_layers_trunk=2,
                                n_layers_color=2, input_chn=chn,
                                hidden_chn=chn, color_chn=chn,
                                opacity_init_bias=-2.0)
    enc = target.clone().requires_grad_(True)
    mlp = dp.mlp_params.detach().clone().requires_grad_(True)
    dp = lp.DecoderParams(mlp, dp.n_hidden_trunk, dp.n_hidden_opacity,
                          dp.n_hidden_color, dp.color_chn)
    sizes = tri_sizes(FEATURE_RES, chn)
    residual = [torch.zeros(s, device="cuda", requires_grad=True)
                for s in sizes]
    lift_rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx,
                        rays.near, rays.far, enc)
    render_rays = lp.Rays(rays.directions, rays.origins, rays.grid_idx,
                          rays.near, rays.far,
                          torch.zeros((n, chn), device="cuda"))
    opt = torch.optim.Adam([enc, mlp] + residual, lr=1e-3)

    def grid():
        lifted = lp.lightplane_splatter(lift_rays, sizes,
                                        num_samples=FEATURE_SPLAT_SAMPLES)
        return [g + r for g, r in zip(lifted, residual)]

    def step():
        opt.zero_grad(set_to_none=True)
        _, _, feat = lp.lightplane_renderer(
            render_rays, grid(), dp, num_samples=FEATURE_RENDER_SAMPLES,
            gain=1.0)
        loss = (feat - target).square().mean()
        loss.backward()
        opt.step()
        return loss.detach()

    return dict(step=step, grid=grid, dp=dp, render_rays=render_rays,
                sizes=sizes)


def feature_counts(reset=False):
    """The launches of R1, R2, S1 and S2 (set to 0 first with ``reset``)."""
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw
    from lightplane_tpu_torch.ops.kernels import splatter_bw as sbw
    from lightplane_tpu_torch.ops.kernels import splatter_fw as sfw

    if reset:
        rfw.LAUNCHES = rbw.LAUNCHES = sfw.LAUNCHES = sbw.LAUNCHES = 0
    return dict(renderer_fw=rfw.LAUNCHES, renderer_bw=rbw.LAUNCHES,
                splatter_fw=sfw.LAUNCHES, splatter_bw=sbw.LAUNCHES)


# The feature path's kernels by part (device_breakdown)
FEATURE_PARTS = (("R1", ("render_fw_wide_kernel",)),
                 ("R2", ("render_bw_wide_kernel", "reduce_wide_sums_kernel")),
                 ("the layers' pre-pass", ("pack_wide_kernel",)),
                 ("the splat and its adjoint", ("splat",)))


def feature_kernels(lp, smi, chn, model, parts):
    """R1 and R2 on the feature path's march (the lifted grid after its
    steps): their times in its last step (``parts``, device_breakdown's;
    timed alone by CUDA events where the profiler saw nothing), their plain
    versions timed, their bounds, then held on FEATURE_SUBSET of its rays
    against their plain versions (R2 under its masks), R1 against R2's
    recomputed forward to the bit, at 512 the layers' pre-pass bit for
    bit."""
    from lightplane_tpu_torch.ops import renderer as rmod
    from lightplane_tpu_torch.ops.kernels import renderer_bw as rbw
    from lightplane_tpu_torch.ops.kernels import renderer_fw as rfw

    with torch.no_grad():
        grid = [g.detach() for g in model["grid"]()]
        dp = model["dp"]
        dp = lp.DecoderParams(dp.mlp_params.detach(), dp.n_hidden_trunk,
                              dp.n_hidden_opacity, dp.n_hidden_color,
                              dp.color_chn)
        cfg, geom, diff = unsplit_march(
            lp, rmod, model["render_rays"], grid, dp,
            num_samples=FEATURE_RENDER_SAMPLES, gain=1.0)
        assert rfw._kernel_width(cfg, chn) == chn
        n = geom[0].shape[0]
        gen = torch.Generator().manual_seed(chn + 1)
        g_out = tuple(torch.randn(s, generator=gen).cuda()
                      for s in [(n,), (n,), (n, chn)])
        nlt = rfw.render_fwd_cuda(cfg, geom, diff)[1]
        if parts:
            fw_ms, bw_ms = parts["R1"], parts["R2"]
        else:
            fw_ms = cuda_ms(lambda: rfw.render_fwd_cuda(cfg, geom, diff),
                            warmup=0, reps=1)
            bw_ms = cuda_ms(lambda: rbw.render_bwd_cuda(
                cfg, geom, diff, nlt, g_out), warmup=0, reps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rfw.render_fwd_torch(cfg, geom, diff)
        torch.cuda.synchronize()
        fw_plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        rbw.render_bwd_torch(cfg, geom, diff, nlt, g_out)
        torch.cuda.synchronize()
        bw_plain_ms = 1e3 * (time.perf_counter() - t0)
    print(f"  R1 (W = {chn}) on the path's march ({n} rays, "
          f"{FEATURE_RENDER_SAMPLES} samples): {fw_ms:.3f} ms in its last "
          f"step, plain {fw_plain_ms:.1f} ms (one run); R2 {bw_ms:.3f} ms "
          f"(with its row sums), plain {bw_plain_ms:.1f} ms (one run)  "
          f"[{smi}]")
    (fl_fw, by_fw), (fl_bw, by_bw), fl_wg, fl_tc = kernel_work(
        rmod, cfg, geom, diff)
    b_fw, b_bw = bound(fl_fw, by_fw), bound(fl_bw, by_bw)
    b_fw_tc = tf32_bound(fl_fw, fl_tc, by_fw)
    b_bw_tc = tf32_bound(fl_bw, fl_tc + 2 * fl_wg, by_bw)
    print(f"    work: R1 {fl_fw / 1e9:.1f} GFLOP -> bound {b_fw[0]:.3f} ms "
          f"({b_fw[1]}), {b_fw_tc:.3f} ms with its products in 3xTF32; R2 "
          f"{fl_bw / 1e9:.1f} GFLOP -> bound {b_bw[0]:.3f} ms ({b_bw[1]}), "
          f"{b_bw_tc:.3f} ms  [{smi}]")
    idx = torch.arange(0, n, n // FEATURE_SUBSET,
                       device="cuda")[:FEATURE_SUBSET]
    geom_s, diff_s = ray_subset(geom, diff, idx)
    g_s = tuple(g[idx].contiguous() for g in g_out)
    with torch.no_grad():
        out_k = rfw.render_fwd_cuda(cfg, geom_s, diff_s)
        out_p = rfw.render_fwd_torch(cfg, geom_s, diff_s)
    print(f"    R1 vs its plain version on {FEATURE_SUBSET} of the path's "
          f"rays:")
    fw_err = max(compare(label, a, b)[0]
                 for label, a, b in zip(("depth", "nlt", "feat"), out_k, out_p))
    bw_err = masked_r2_parity(rmod, rfw, rbw, cfg, geom_s, diff_s, g_s)
    with torch.no_grad():
        r1, r2 = rbw.forward_probes(cfg, geom_s, diff_s, g_s)
    torch.cuda.synchronize()
    opened = int((r1[..., 0] != 0).sum())
    assert opened > 0 and torch.equal(r1, r2), opened
    print(f"    R1's forward equals R2's recomputed forward to the bit (raw "
          f"opacity and the sum of the raw colours at {opened} open steps)")
    if chn == 512:
        wide_pack_parity(dp.mlp_params, feature_head(chn))
    return dict(fw=dict(ms=fw_ms, plain_ms=fw_plain_ms, err=fw_err,
                        bound=b_fw, bound_tf32=b_fw_tc),
                bw=dict(ms=bw_ms, plain_ms=bw_plain_ms, err=bw_err,
                        bound=b_bw, bound_tf32=b_bw_tc))


def feature_head(chn):
    """The n_hidden tuples of the feature path's decoder at ``chn``."""
    return (chn,) * 5 + (1,) + (chn,) * 3


def phase_feature(lp, smi):
    """Phase 13's steps (the shipped build only): at each width the feature
    path's Adam steps, the last by kernel; returns each width's model,
    parts, launches and step times for ``phase_feature_checks``."""
    print("== phase 13: feature fields, widths 384 and 512: "
          f"{FEATURE_VIEWS} views of {FEATURE_SIZE}^2 rays with C-channel "
          f"features lifted into 3 x {FEATURE_RES}^2 x Cch and rendered back "
          f"through a 2/2/2 decoder C wide with C colours")
    runs = {}
    for chn in FEATURE_CHN:
        gc.collect()
        torch.cuda.empty_cache()
        model = feature_model(lp, chn)
        steps = FEATURE_STEPS if chn == 512 else 1
        torch.cuda.synchronize()
        feature_counts(reset=True)
        losses, times, parts = [], [], {}
        for i in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if i < steps - 1:
                loss = model["step"]()
            else:
                # the last step by kernel (its time includes the profiler's)
                device_breakdown(lambda: losses.append(float(model["step"]())),
                                 smi, top=6, groups=FEATURE_PARTS,
                                 parts=parts)
            end.record()
            end.synchronize()
            if i < steps - 1:
                losses.append(float(loss))
            times.append(start.elapsed_time(end))
        launches = feature_counts()
        assert set(launches.values()) == {steps}, launches
        assert all(np.isfinite(losses)), losses
        print(f"  C = {chn}: {steps} Adam step(s) of the lift-then-render, "
              f"ms {[round(t, 3) for t in times]}, loss "
              f"{[round(x, 6) for x in losses]}; launches {launches}  "
              f"[{smi}]")
        if chn == 512:
            assert losses[-1] < losses[0], losses
        runs[chn] = (model, parts, launches, times)
    return runs


def phase_feature_checks(lp, smi, runs):
    """Phase 13's kernels on each width's march (``feature_kernels``: they
    need the recording build)."""
    print("== phase 13 (cont.): R1 and R2 on the feature path's march")
    out = {}
    for chn in FEATURE_CHN:
        model, parts, launches, times = runs.pop(chn)
        out[chn] = dict(feature_kernels(lp, smi, chn, model, parts),
                        launches=launches, step_ms=times)
        del model
    return out


PHASES = ("1", "2", "3", "3b", "3c", "4", "5", "6", "7", "8", "9", "10",
          "11", "12", "13")


def parse_only(argv):
    """The phases that ``--only A,B,...`` names (1 and 2 always run), or
    every phase without the switch."""
    if not argv:
        return set(PHASES)
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit("usage: chip_smoke.py [--ablate | --only PHASES]")
    only = set(argv[1].split(",")) | {"1", "2"}
    unknown = only - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; phases are "
                         f"{', '.join(PHASES)}")
    return only


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import lightplane_tpu_torch as lp

    ablation = sys.argv[1:2] == ["--ablate"]
    if ablation:
        kernels = sys.argv[2].split(",") if len(sys.argv) > 2 else ABLATIONS
        unknown = set(kernels) - set(ABLATIONS)
        if unknown or len(sys.argv) > 3:
            raise SystemExit(f"usage: chip_smoke.py --ablate [KERNELS], "
                             f"KERNELS of {', '.join(ABLATIONS)}")
    only = set() if ablation else parse_only(sys.argv[1:])
    t0 = time.perf_counter()

    def timed(fn, *args):
        """Run one phase, print its time and check that no JAX came in."""
        t = time.perf_counter()
        out = fn(*args)
        print(f"   ({fn.__name__}: {time.perf_counter() - t:.1f} s)")
        assert "jax" not in sys.modules, "the port imported jax"
        return out

    smi, name = timed(phase_device)
    recording = timed(phase_build)
    if ablation:
        timed(finish_build, *recording)
        ablate(lp, smi, [k for k in ABLATIONS if k in kernels])
        return 0
    # phase 13's steps and phases 4, 8 and 10 need only the shipped build:
    # they run while the recording build compiles; phase 13's checks and
    # the other phases after it
    feature = timed(phase_feature, lp, smi) if "13" in only else None
    out = {}
    early = (("4", phase_slice), ("8", phase_lift_render),
             ("10", phase_fit_files))
    for phase, fn in early:
        if phase not in only:
            continue
        if phase == "4":
            held_memory()
        out[phase] = timed(fn, lp, smi)
        gc.collect()
        torch.cuda.empty_cache()
    out["2"] = timed(finish_build, *recording)
    if feature is not None:
        out["13"] = timed(phase_feature_checks, lp, smi, feature)
        gc.collect()
        torch.cuda.empty_cache()
    for phase, fn, args in (
        ("3", phase_parity, (lp,)),
        ("3b", phase_backward_parity, (lp,)),
        ("3c", phase_branch_parity, (lp,)),
        ("5", phase_training, (lp, smi)),
        ("6", phase_splat_parity, (lp,)),
        ("7", phase_splat, (lp, smi)),
        ("9", phase_fit, (lp, smi)),
        ("11", phase_data_parallel, (lp, smi)),
        ("12", phase_wide, (lp, smi)),
    ):
        if phase not in only:
            continue
        out[phase] = timed(fn, *args)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"== done in {time.perf_counter() - t0:.1f} s")
    print(smi)
    if only == set(PHASES):
        print(json.dumps({"kernels": kernel_lines(out)}))
    else:
        print(f"(phases {', '.join(p for p in PHASES if p in only)} only: "
              f"no kernels line)")
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }))
    return 0


def kernel_lines(out):
    """The ``kernels`` line from the phases' results."""
    branch_errs, fw = out["3c"], out["4"]
    _, train = out["5"]
    splat_launches, splat = out["7"]
    fit_launches, scaffold_row, rf_row = out["9"]
    files_launches = out["10"]
    # phase 11's launches (the NCCL world's drive of its three workloads),
    # S2's without and with the MLP counted apart
    dp_launches = out["11"]["launches"]
    # phase 12's wide builds (W = 256, 192, 128 and 96): times and bounds at
    # the render headline and the MLP splat into W channels, errors there at
    # WIDE_CHECKED; launches of R1 and R2 on the scene fit at hidden 128 and
    # 256 (at 192 and 96 on the headline's timed runs), of S1 and S2 with
    # the MLP on the MLP splatter's step at each width; the worst errors of
    # the sweep over the widths in between
    wide = out["12"]
    fit_by_w = {w: wide["fit"][w] if w in wide["fit"]
                else wide["headline"][w]["launches"] for w in WIDE_HIDDEN}

    def wide_keys(part, key, launches, sweep_err=None):
        keys = {}
        for w in WIDE_HIDDEN:
            k = wide[part][w][key]
            keys.update({f"wide_{w}_ms": k["ms"],
                         f"wide_{w}_plain_ms": k["plain_ms"],
                         f"wide_{w}_bound_ms": k["bound"][0],
                         f"wide_{w}_bound_by": k["bound"][1],
                         f"wide_{w}_bound_tf32_ms": k.get("bound_tf32"),
                         f"wide_{w}_launches": launches[w]})
            if w in WIDE_CHECKED:
                keys[f"wide_{w}_max_abs_err"] = k["err"]
        if sweep_err is not None:
            keys["wide_sweep_max_abs_err"] = sweep_err
        return keys

    wide_rows = {
        "renderer_fw": wide_keys(
            "headline", "fw",
            {w: fit_by_w[w]["renderer_fw"] for w in WIDE_HIDDEN},
            wide["sweep"]["fw"]),
        "renderer_bw": wide_keys(
            "headline", "bw",
            {w: fit_by_w[w]["renderer_bw"] for w in WIDE_HIDDEN},
            wide["sweep"]["bw"]),
        "splatter_fw": wide_keys(
            "splat", "fw",
            {w: wide["splat"][w]["fw"]["launches"] for w in WIDE_HIDDEN}),
        "splatter_bw_mlp": dict(
            wide_keys("splat", "bw", {w: wide["splat"][w]["bw"]["launches"]
                                      for w in WIDE_HIDDEN}),
            wide_sweep_max_rel_err=wide["sweep"]["splat"]),
    }
    for i, key in enumerate(("renderer_fw", "renderer_bw")):
        for w, launches in wide["fit"].items():
            wide_rows[key][f"wide_{w}_launches_scaffold"] = (
                launches["scaffold"][i])
        for w in WIDE_HIDDEN + FEATURE_CHN:
            wide_rows[key][f"wide_{w}_warps_per_sm"] = out["2"][w][i]
        # phase 13's builds past 256: launches on its feature path (5 steps
        # at 512, one at 384), times, errors and bounds on its march
        for w, k in out["13"].items():
            part = k["fw" if i == 0 else "bw"]
            wide_rows[key].update({
                f"wide_{w}_ms": part["ms"],
                f"wide_{w}_plain_ms": part["plain_ms"],
                f"wide_{w}_bound_ms": part["bound"][0],
                f"wide_{w}_bound_by": part["bound"][1],
                f"wide_{w}_bound_tf32_ms": part["bound_tf32"],
                f"wide_{w}_max_abs_err": part["err"],
                f"wide_{w}_launches": k["launches"][key]})
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
                                  ("bound_ms", row[key]["bound"][0]),
                                  ("bound_tf32_ms", row[key]["bound_tf32"]))})
        for i, key in enumerate(("fw", "bw"))}
    kernels = [
        dict(fw, launches=fit_launches["renderer_fw"],
             launches_fit_files=files_launches["renderer_fw"],
             launches_fit_files_scaffold=files_launches["scaffold"][0],
             launches_data_parallel=dp_launches["renderer_fw"],
             bound_ms=b_fw,
             bound_by=b_fw_kind, library_ms=None,
             bound_tf32_ms=train["fw_bound_tf32"], **branches["fw"],
             **wide_rows["renderer_fw"]),
        dict(name="renderer_bw", route="cuda",
             source="lightplane_tpu_torch/csrc/renderer_bw.cu",
             replaces="lightplane_tpu/ops/kernels/renderer_pallas.py:2798",
             launches=fit_launches["renderer_bw"],
             launches_fit_files=files_launches["renderer_bw"],
             launches_fit_files_scaffold=files_launches["scaffold"][1],
             launches_data_parallel=dp_launches["renderer_bw"],
             max_abs_err=train["bw"]["err"], ms=train["bw"]["ms"],
             plain_ms=train["bw"]["plain_ms"], bound_ms=b_bw,
             bound_by=b_bw_kind, library_ms=None,
             bound_tf32_ms=train["bw"]["bound_tf32"],
             **branches["bw"], **wide_rows["renderer_bw"]),
    ]
    for key, line in (("fw", 57), ("bw", 183)):
        k = splat[key]
        kernels.append(dict(
            name=f"splatter_{key}", route="cuda",
            source=f"lightplane_tpu_torch/csrc/splatter_{key}.cu",
            replaces=f"lightplane_tpu/ops/kernels/splatter_pallas.py:{line}",
            launches=splat_launches[f"splatter_{key}"],
            launches_data_parallel=dp_launches[f"splatter_{key}"],
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound"][0], bound_by=k["bound"][1],
            library_ms=None,
            **{f"launches_feature_{w}": out["13"][w]["launches"][
                f"splatter_{key}"] for w in FEATURE_CHN},
            **({"plan_ms": k["plan_ms"], "runs": k["runs"],
                **wide_rows["splatter_fw"]} if key == "fw" else {})))
    # S1 with the MLP at W = 64: launches on the MLP splatter's six timed
    # steps, the rest at its shapes alone (phase 7)
    k = splat["fw_mlp"]
    kernels.append(dict(
        name="splatter_fw_mlp", route="cuda",
        source="lightplane_tpu_torch/csrc/splatter_fw.cu",
        replaces="lightplane_tpu/ops/kernels/splatter_pallas.py:57",
        launches=k["launches"], max_abs_err=k["err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound"][0],
        bound_by=k["bound"][1], library_ms=None))
    # S2 with the MLP: launches on the MLP splatter's six timed steps, the
    # rest at its shapes alone (phase 7)
    k = splat["bw_mlp"]
    kernels.append(dict(
        name="splatter_bw_mlp", route="cuda",
        source="lightplane_tpu_torch/csrc/splatter_bw.cu",
        replaces="lightplane_tpu/ops/kernels/splatter_pallas.py:183",
        launches=k["launches"],
        launches_data_parallel=dp_launches["splatter_bw_mlp"],
        max_abs_err=k["err"], ms=k["ms"],
        plain_ms=k["plain_ms"], bound_ms=k["bound"][0],
        bound_by=k["bound"][1], bound_tf32_ms=k["bound_tf32"],
        library_ms=None, **wide_rows["splatter_bw_mlp"]))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
