"""Image quality metrics, PSNR and SSIM (counterpart of
``lightplane_tpu/utils/metrics.py``: the same formulas, Gaussian window and
clamped moments).  LPIPS and the perceptual loss are not ported yet."""

from __future__ import annotations

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
