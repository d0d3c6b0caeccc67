"""Image quality metrics (counterpart of ``lightplane_tpu/utils/metrics.py``):
PSNR and SSIM (the same formulas, Gaussian window and clamped moments), the
differentiable LPIPS-structured ``perceptual_loss`` and ``calc_lpips``."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch


def calc_psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio of images in [0, 1]."""
    mse = torch.mean((pred - target) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / torch.sum(g)


def _blur_valid(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable filter of ``[H, W, C]`` over H and W with "valid" windows,
    as a sum of shifted slices: f32 throughout (a convolution on the GPU
    could run in TF32)."""
    k = kern.shape[0]
    h, w = img.shape[0] - k + 1, img.shape[1] - k + 1
    rows = sum(kern[i] * img[:, i:i + w] for i in range(k))
    return sum(kern[i] * rows[i:i + h] for i in range(k))


def calc_ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    max_val: float = 1.0,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Structural similarity of ``[H, W, C]`` (or ``[H, W]``) images, with
    a Gaussian window (Wang et al.)."""
    if pred.dim() == 2:
        pred, target = pred[..., None], target[..., None]
    kern = _gaussian_kernel(filter_size, filter_sigma, pred.device)

    def blur(img):
        return _blur_valid(img, kern)

    mu_p = blur(pred)
    mu_t = blur(target)
    mu_pp = blur(pred * pred)
    mu_tt = blur(target * target)
    mu_pt = blur(pred * target)
    # on near-constant windows cancellation can make a variance slightly
    # negative, which would push SSIM above 1: clamp the moments
    var_p = torch.clamp(mu_pp - mu_p ** 2, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t ** 2, min=0.0)
    cov = mu_pt - mu_p * mu_t
    cov_bound = torch.sqrt(var_p * var_t)
    cov = torch.maximum(torch.minimum(cov, cov_bound), -cov_bound)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2)
    )
    return torch.mean(ssim_map)


def _as_image(x, device) -> torch.Tensor:
    """A float32 tensor of ``x``: a tensor stays where it is, anything else
    goes to ``device`` (the GPU unless given)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=device or "cuda")


def calc_lpips(pred, target, net: str = "vgg", device=None) -> float:
    """LPIPS distance of two ``[H, W, 3]`` images in [0, 1], without
    gradients.

    As the JAX package resolves it: the ``lpips`` package where it is
    installed (the reference's metric); else a local VGG16 weights file
    named by the ``LIGHTPLANE_VGG_WEIGHTS`` environment variable, through
    :func:`perceptual_loss` over VGG's five blocks; else ImportError.
    Tensors are scored on their device, arrays on ``device``."""
    p = _as_image(pred, device)
    t = _as_image(target, device).to(p.device)
    try:
        import lpips
    except ImportError:
        path = os.environ.get("LIGHTPLANE_VGG_WEIGHTS")
        if path and os.path.exists(path):
            fn = _vgg_features_fn(path, str(p.device))
            with torch.no_grad():
                return float(perceptual_loss(p, t, features_fn=fn,
                                             blocks=(0, 1, 2, 3, 4)))
        raise ImportError(
            "LPIPS requires the `lpips` pip package, or a local "
            "pretrained VGG16 checkpoint via LIGHTPLANE_VGG_WEIGHTS "
            "(neither available). Use calc_psnr/calc_ssim instead."
        ) from None
    loss_fn = lpips.LPIPS(net=net).to(p.device)

    def to_nchw(x):
        return x.permute(2, 0, 1)[None] * 2 - 1

    with torch.no_grad():
        return float(loss_fn(to_nchw(p), to_nchw(t)))


@functools.lru_cache(maxsize=2)
def _vgg_features_fn(path: str, device: str):
    from .nnfm_loss import vgg16_jax_features_fn

    return vgg16_jax_features_fn(path, device=device)


@functools.lru_cache(maxsize=2)
def _default_features_fn(device: str):
    """The default feature extractor on ``device``, built once: the VGG16
    weights that ``LIGHTPLANE_VGG_WEIGHTS`` names, where it names a file,
    else the fixed random conv pyramid."""
    path = os.environ.get("LIGHTPLANE_VGG_WEIGHTS")
    if path and os.path.exists(path):
        return _vgg_features_fn(path, device)
    from .nnfm_loss import random_conv_features_fn

    return random_conv_features_fn(device=device)


def perceptual_loss(pred_hwc: torch.Tensor, target_hwc: torch.Tensor,
                    features_fn=None, blocks=(0, 1, 2)) -> torch.Tensor:
    """Differentiable LPIPS-structured distance of two ``[H, W, 3]`` images
    (LPIPS, Zhang et al. 2018, without its learned channel weights): the
    multi-scale feature maps of both images, each normalised to unit length
    per pixel over its channels, the mean over pixels of the squared
    difference, averaged over the blocks.  ``features_fn(img_chw, blocks)
    -> [per-block [C, H, W]]`` is by default :func:`_default_features_fn`
    on the images' device."""
    from .nnfm_loss import _normalize_chn

    if not blocks:
        raise ValueError("perceptual_loss needs at least one block")
    if features_fn is None:
        features_fn = _default_features_fn(str(pred_hwc.device))
    fa = features_fn(pred_hwc.permute(2, 0, 1), blocks)
    fb = features_fn(target_hwc.permute(2, 0, 1), blocks)
    total = 0.0
    for xa, xb in zip(fa, fb):
        na = _normalize_chn(xa.reshape(xa.shape[0], -1))
        nb = _normalize_chn(xb.reshape(xb.shape[0], -1))
        total = total + torch.mean(torch.sum((na - nb) ** 2, dim=0))
    return total / len(fa)
