"""Single-scene fitting with the PyTorch port of the Lightplane renderer
(counterpart of the JAX package's ``examples/fit_single_scene.py``).

Fits a triplane or voxel grid and the decoder MLPs to posed images with MSE
+ TV + L1 losses: Adam over two learning-rate groups with exponential
decay, coarse-to-fine grid up-sampling, scaffold updates
(``LightplaneRenderer.calculate_scaffold``), evaluation renders with PSNR
and SSIM, and ``torch.save`` checkpoints.  ``--dataset_path`` names a
NeRF-synthetic, LLFF, NSVF or CO3D directory (``examples/datasets.py``);
without it the trainer fits a procedural synthetic scene (no download).
``--ray_sampling image`` trains on one whole image a step, and
``--perceptual_weight`` adds the perceptual loss of that image
(``utils/metrics.py::perceptual_loss``, on the fixed random conv features
of ``utils/nnfm_loss.py::random_conv_features_fn``).  On a GPU every step
runs the CUDA march kernels; ``--device cpu`` runs their plain PyTorch
versions.

As in the JAX app, ``--downsample`` is parsed and not passed to the
loader: images load at their full size.

Usage::

    python -m lightplane_tpu_torch.examples.fit_single_scene --n_iter 2000
    python -m lightplane_tpu_torch.examples.fit_single_scene --device cpu \\
        --n_iter 100 --grid_resolution 8 --grid_channels 16 \\
        --mlp_hidden_chn 16 --num_samples 16 --rays_per_batch 256
    python -m lightplane_tpu_torch.examples.fit_single_scene \\
        --dataset_path path/to/nerf_synthetic/lego --ray_sampling image \\
        --perceptual_weight 0.05
    python -m lightplane_tpu_torch.examples.fit_single_scene \\
        --config examples/config/synthetic_overfit.json

The flags and the JSON ``--config`` are the JAX app's; ``--impl`` takes
``auto``, ``cuda`` and ``torch``, and the JAX spellings ``scan`` (the plain
version) and ``pallas`` (the kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..models.renderer_module import LightplaneRenderer
from ..ops.rays import Rays
from ..ops.renderer import MAX_CELLS_PER_GRID
from ..utils.grid_utils import (
    grid_l1_loss,
    grid_tv_loss,
    grid_up_sample,
    init_3d_representation,
)
from ..utils.io_utils import colorize_depth, save_image
from ..utils.metrics import calc_psnr, calc_ssim, perceptual_loss
from ..utils.nnfm_loss import random_conv_features_fn
from .datasets import auto_dataset

# --impl values: the port's, and the JAX app's spellings of the same paths
IMPLS = {"auto": "auto", "cuda": "cuda", "torch": "torch", "scan": "torch",
         "pallas": "cuda"}

# The JAX app's ray samplers: a 'span' is 512 contiguous raster pixels of
# one image, a 'patch' 8 x 8 pixels.  'auto' draws spans while every
# sub-grid has at most MAX_CELLS_PER_GRID cells (the JAX renderer's
# per-sub-grid budget, renderer_pallas.py, copied into ops/renderer.py) and
# patches beyond, as the JAX app does, so both draw the same kind of batch.
SPAN = 512
PATCH = 8


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default=None,
                   help="JSON config file; CLI flags override it")
    # data
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--dataset_type", type=str, default="auto",
                   choices=["auto", "nerf", "llff", "nsvf", "co3d",
                            "synthetic"])
    p.add_argument("--downsample", type=int, default=1)
    # model
    p.add_argument("--representation", type=str, default="triplane",
                   choices=["triplane", "voxel_grid"])
    p.add_argument("--grid_resolution", type=int, default=64)
    p.add_argument("--grid_channels", type=int, default=32)
    p.add_argument("--mlp_hidden_chn", type=int, default=32)
    p.add_argument("--mlp_n_layers", type=int, default=2)
    p.add_argument("--num_samples", type=int, default=128)
    p.add_argument("--num_samples_inf", type=int, default=0)
    p.add_argument("--contract_coords", action="store_true")
    p.add_argument("--mask_out_of_bounds_samples", action="store_true")
    p.add_argument("--bg_color", type=float, default=1.0)
    p.add_argument("--gain", type=float, default=1.0)
    p.add_argument("--opacity_init_bias", type=float, default=-5.0)
    p.add_argument("--inject_noise_sigma", type=float, default=0.0)
    p.add_argument("--impl", type=str, default="auto", choices=list(IMPLS))
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model and the data live: 'cuda' (the "
                        "CUDA kernels) or 'cpu' (their plain versions)")
    # optimization
    p.add_argument("--n_iter", type=int, default=3000)
    p.add_argument("--rays_per_batch", type=int, default=4096)
    p.add_argument("--ray_sampling", type=str, default="auto",
                   choices=["auto", "span", "patch", "random", "image"],
                   help="'span': random 512-pixel raster spans; 'patch': "
                        "random 8x8 pixel patches; 'auto': span while every "
                        "sub-grid has at most 8192 cells, patch beyond; "
                        "'random': i.i.d. pixels; 'image': one whole image "
                        "per step")
    p.add_argument("--perceptual_weight", type=float, default=0.0,
                   help="weight of the perceptual loss of each whole image "
                        "(with --ray_sampling image)")
    p.add_argument("--lr_grid", type=float, default=5e-2)
    p.add_argument("--lr_mlp", type=float, default=5e-3)
    p.add_argument("--lr_decay_iters", type=int, default=3000)
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--tv_weight", type=float, default=1e-3)
    p.add_argument("--l1_weight", type=float, default=0.0)
    # schedule
    p.add_argument("--upsample_steps", type=int, nargs="*", default=[])
    p.add_argument("--update_scaffold_steps", type=int, nargs="*",
                   default=[])
    p.add_argument("--scaffold_resolution", type=int, default=64)
    # logging / eval / checkpoints
    p.add_argument("--eval_rate", type=int, default=1000)
    p.add_argument("--output_dir", type=str, default="outputs/fit")
    p.add_argument("--init_ckpt", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.config is not None:
        with open(args.config) as f:
            cfg = json.load(f)
        valid = {a.dest for a in p._actions}
        bad = set(cfg) - valid
        if bad:
            raise ValueError(f"invalid config keys: {sorted(bad)}")
        p.set_defaults(**cfg)
        args = p.parse_args(argv)
    if args.impl not in IMPLS:
        raise ValueError(f"--impl must be one of {sorted(IMPLS)}")
    return args


def build_renderer(args, generator=None) -> LightplaneRenderer:
    return LightplaneRenderer(
        num_samples=args.num_samples,
        color_chn=3,
        grid_chn=args.grid_channels,
        mlp_hidden_chn=args.mlp_hidden_chn,
        mlp_n_layers_opacity=args.mlp_n_layers,
        mlp_n_layers_trunk=args.mlp_n_layers,
        mlp_n_layers_color=args.mlp_n_layers,
        opacity_init_bias=args.opacity_init_bias,
        gain=args.gain,
        bg_color=args.bg_color,
        num_samples_inf=args.num_samples_inf,
        mask_out_of_bounds_samples=args.mask_out_of_bounds_samples,
        contract_coords=args.contract_coords,
        inject_noise_sigma=args.inject_noise_sigma,
        inject_noise_seed=0,
        generator=generator,
        device=args.device,
    )


def make_optimizer(args, grid, renderer, n_iter_done=0):
    """Adam (optax's defaults: betas (0.9, 0.999), eps 1e-8) over the grid
    (``--lr_grid``) and the module (``--lr_mlp``), each rate times
    ``lr_decay_rate ** ((i + n_iter_done) / lr_decay_iters)`` at update i:
    ``optax.exponential_decay(1.0, lr_decay_iters, lr_decay_rate)`` without
    staircase.  Call the scheduler's ``step`` after each update."""
    opt = torch.optim.Adam(
        [{"params": list(grid), "lr": args.lr_grid},
         {"params": list(renderer.parameters()), "lr": args.lr_mlp}],
        betas=(0.9, 0.999), eps=1e-8,
    )
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: args.lr_decay_rate ** ((i + n_iter_done)
                                              / args.lr_decay_iters))
    return opt, sched


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class SceneFit:
    """The fitting state: the data on the device, the module and the grid
    (``nn.Parameter``s), the optimiser, the scaffold and the sample count,
    with one method per part of the schedule."""

    def __init__(self, args):
        self.args = args
        self.device = torch.device(args.device)
        self.impl = IMPLS[args.impl]
        print(f"[fit] loading dataset ({args.dataset_type})")
        # the span, patch and image batches need one raster size, so a CO3D
        # load resizes every frame to the first one's, as the JAX app's does
        ds = auto_dataset(args.dataset_path, args.dataset_type,
                          keep_frame_sizes=False)
        self.ds = ds
        print(f"[fit] {ds.n_images} images {ds.height}x{ds.width},"
              f" near={ds.near:.2f} far={ds.far:.2f}")
        self.origins, self.directions, self.gt = (
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (ds.origins, ds.directions, ds.gt))
        # one generator for the initialisation, one for the ray batches
        gen = torch.Generator().manual_seed(args.seed)
        self.batch_gen = torch.Generator().manual_seed(args.seed + 1)
        self.renderer = build_renderer(args, gen)
        self.grid = [torch.nn.Parameter(g) for g in init_3d_representation(
            gen, args.representation, args.grid_resolution,
            args.grid_channels, device=self.device)]
        self.num_samples = args.num_samples
        if args.init_ckpt:
            self.load(args.init_ckpt)
        self.opt, self.sched = make_optimizer(args, self.grid, self.renderer)
        self.scaffold = None
        # the perceptual term's feature extractor, built once on the device
        self.features_fn = (random_conv_features_fn(device=self.device)
                            if args.perceptual_weight > 0 else None)

    # ---- ray batches ----

    def sampling_mode(self) -> str:
        mode = self.args.ray_sampling
        if mode != "auto":
            return mode
        big = any(int(np.prod(g.shape[1:4])) > MAX_CELLS_PER_GRID
                  for g in self.grid)
        return "patch" if big else "span"

    def _randint(self, high, n):
        return torch.randint(0, high, (n,), generator=self.batch_gen)

    def sample_ray_idx(self, mode: str) -> torch.Tensor:
        """Indices of one batch of rays (into the flattened images)."""
        ds, n = self.ds, self.args.rays_per_batch
        img_rays = ds.height * ds.width
        py_max, px_max = ds.height // PATCH, ds.width // PATCH
        spans_per_img = img_rays // SPAN
        if mode == "patch" and py_max and px_max:
            n_patches = max(1, n // (PATCH * PATCH))
            img = self._randint(ds.n_images, n_patches)
            py = self._randint(py_max, n_patches)
            px = self._randint(px_max, n_patches)
            r = torch.arange(PATCH)
            rows = py[:, None] * PATCH + r[None, :]
            cols = px[:, None] * PATCH + r[None, :]
            idx = (img[:, None, None] * img_rays + rows[:, :, None] * ds.width
                   + cols[:, None, :])
        elif mode == "random" or spans_per_img == 0:
            idx = self._randint(ds.origins.shape[0], n)
        else:
            n_spans = max(1, n // SPAN)
            img = self._randint(ds.n_images, n_spans)
            sp = self._randint(spans_per_img, n_spans)
            idx = (img * img_rays + sp * SPAN)[:, None] + torch.arange(SPAN)
        return idx.reshape(-1).to(self.device)

    def rays(self, idx: torch.Tensor) -> Rays:
        n = idx.shape[0]
        return Rays(
            directions=self.directions[idx], origins=self.origins[idx],
            grid_idx=torch.zeros((n,), dtype=torch.int64, device=self.device),
            near=torch.full((n,), self.ds.near, device=self.device),
            far=torch.full((n,), self.ds.far, device=self.device),
        )

    # ---- the schedule ----

    def loss(self, idx: torch.Tensor, image_size=None):
        """The training loss of the rays ``idx`` and its MSE: MSE, plus
        ``--perceptual_weight`` times the perceptual loss where ``idx`` is a
        whole raster-order image of ``image_size``, plus the TV and L1
        terms of the grid."""
        args = self.args
        _, _, rgb = self.renderer(
            self.rays(idx), self.grid, scaffold=self.scaffold,
            num_samples=self.num_samples, image_size=image_size,
            impl=self.impl)
        mse = torch.mean((rgb - self.gt[idx]) ** 2)
        loss = mse
        if image_size is not None and self.features_fn is not None:
            pred = rgb.reshape(*image_size, 3)
            tgt = self.gt[idx].reshape(*image_size, 3)
            loss = loss + args.perceptual_weight * perceptual_loss(
                pred, tgt, self.features_fn)
        if args.tv_weight > 0:
            loss = loss + args.tv_weight * grid_tv_loss(self.grid)
        if args.l1_weight > 0:
            loss = loss + args.l1_weight * grid_l1_loss(self.grid)
        return loss, mse

    def train_step(self, idx: torch.Tensor, image_size=None):
        """One Adam step on the rays ``idx`` (a whole raster-order image
        with ``image_size``); returns the loss and the MSE, on the device."""
        self.opt.zero_grad(set_to_none=True)
        loss, mse = self.loss(idx, image_size)
        loss.backward()
        self.opt.step()
        self.sched.step()
        return loss.detach(), mse.detach()

    def step(self):
        """One training step with a batch drawn as ``--ray_sampling``
        says."""
        ds = self.ds
        if self.args.ray_sampling == "image":
            img = int(self._randint(ds.n_images, 1))
            img_rays = ds.height * ds.width
            idx = img * img_rays + torch.arange(img_rays, device=self.device)
            return self.train_step(idx, image_size=(ds.height, ds.width))
        return self.train_step(self.sample_ray_idx(self.sampling_mode()))

    def upsample(self, step: int):
        """Coarse-to-fine: the grid twice as fine, twice the samples, a new
        optimiser whose decay continues from ``step``."""
        with torch.no_grad():
            fine = grid_up_sample([g.detach() for g in self.grid], 2)
        self.grid = [torch.nn.Parameter(g) for g in fine]
        self.num_samples *= 2
        self.opt, self.sched = make_optimizer(self.args, self.grid,
                                              self.renderer, n_iter_done=step)
        print(f"[fit] step {step}: upsampled grid -> "
              f"{[tuple(g.shape) for g in self.grid]},"
              f" num_samples={self.num_samples}")

    def update_scaffold(self, step: int) -> float:
        r = self.args.scaffold_resolution
        self.scaffold = self.renderer.calculate_scaffold(self.grid,
                                                         (1, r, r, r))
        occ = float(self.scaffold.mean())
        print(f"[fit] step {step}: scaffold updated (occupancy {occ:.3f})")
        return occ

    def render_image(self, i: int = 0):
        """``(rgb [H, W, 3] in [0, 1], depth [H, W])`` of image ``i``,
        rendered in raster order without autograd."""
        ds = self.ds
        hw = ds.height * ds.width
        idx = torch.arange(i * hw, (i + 1) * hw, device=self.device)
        with torch.no_grad():
            depth, _, rgb = self.renderer(
                self.rays(idx), self.grid, scaffold=self.scaffold,
                num_samples=self.num_samples, image_size=(ds.height, ds.width),
                impl=self.impl)
        return (rgb.reshape(ds.height, ds.width, 3).clamp(0.0, 1.0),
                depth.reshape(ds.height, ds.width))

    def evaluate(self, step: int):
        """Render image 0, print its PSNR and SSIM, save the render, the
        depth map and a checkpoint; returns (PSNR, SSIM)."""
        out = self.args.output_dir
        rgb, depth = self.render_image(0)
        gt = self.gt[: rgb.shape[0] * rgb.shape[1]].reshape(rgb.shape)
        psnr = float(calc_psnr(rgb, gt))
        ssim = float(calc_ssim(rgb, gt))
        save_image(os.path.join(out, f"render_{step:06d}.png"),
                   rgb.cpu().numpy())
        save_image(os.path.join(out, f"depth_{step:06d}.png"),
                   colorize_depth(depth.cpu().numpy()))
        path = self.save(step)
        print(f"[fit] step {step}: eval PSNR {psnr:.2f} SSIM {ssim:.3f}"
              f" -> {path}")
        return psnr, ssim

    # ---- checkpoints ----

    def save(self, step: int) -> str:
        path = os.path.abspath(os.path.join(self.args.output_dir,
                                            f"ckpt_{step:06d}.pt"))
        torch.save({"grid": [g.detach().cpu() for g in self.grid],
                    "renderer": self.renderer.state_dict(),
                    "num_samples": self.num_samples}, path)
        return path

    def load(self, path: str):
        ckpt = torch.load(path, map_location=self.device)
        self.grid = [torch.nn.Parameter(g.to(self.device))
                     for g in ckpt["grid"]]
        self.renderer.load_state_dict(ckpt["renderer"])
        self.num_samples = int(ckpt["num_samples"])
        print(f"[fit] restored {path}")


def main(argv=None) -> SceneFit:
    """Run the fit; returns its final state, with ``history``: the mean
    milliseconds per step of each stretch of steps between two events
    (``segments``: first step, last step + 1, ms per step), the evals
    (step, PSNR, SSIM), the scaffold updates (step, occupancy) and the
    upsamples (step)."""
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    fit = SceneFit(args)
    history = dict(segments=[], evals=[], scaffolds=[], upsamples=[])
    fit.history = history

    seg_start = 0
    _sync(fit.device)
    t_seg = t0 = time.perf_counter()
    for step in range(args.n_iter):
        loss, mse = fit.step()
        upsample = step in args.upsample_steps
        scaffold = step in args.update_scaffold_steps
        log = (step + 1) % 100 == 0
        evaluate = (step + 1) % args.eval_rate == 0 or step + 1 == args.n_iter
        if not (upsample or scaffold or log or evaluate):
            continue
        _sync(fit.device)
        t = time.perf_counter()
        if upsample or scaffold or evaluate:
            ms = 1e3 * (t - t_seg) / (step + 1 - seg_start)
            history["segments"].append((seg_start, step + 1, ms))
        if upsample:
            fit.upsample(step)
            history["upsamples"].append(step)
        if scaffold:
            history["scaffolds"].append((step, fit.update_scaffold(step)))
        if log:
            psnr_b = -10 * np.log10(max(float(mse), 1e-10))
            print(f"[fit] step {step + 1}/{args.n_iter}"
                  f" loss {float(loss):.5f} batchPSNR {psnr_b:.2f}"
                  f" ({1e3 * (t - t0) / (step + 1):.1f} ms/it)")
        if evaluate:
            history["evals"].append((step + 1, *fit.evaluate(step + 1)))
        if upsample or scaffold or evaluate:
            _sync(fit.device)
            seg_start = step + 1
            t_seg = time.perf_counter()
    for a, b, ms in history["segments"]:
        print(f"[fit] steps {a}-{b}: {ms:.2f} ms/it")
    return fit


if __name__ == "__main__":
    main()
