"""ARF-style style losses over deep feature maps (counterpart of
``lightplane_tpu/utils/nnfm_loss.py``): nearest-neighbour feature matching
(NNFM), Gram-matrix matching, content matching, and the linear colour
transfer ``match_colors_for_image_set``.

The losses work on any per-block ``[C, H, W]`` feature maps.  Feature
extractors are ``nn.Module``s whose ``forward(img_chw, blocks)`` returns
those maps, with their weights as buffers on an explicit device:

* :func:`random_conv_features_fn`: a fixed random multi-scale 3x3 conv
  pyramid, which needs no weights file;
* :func:`vgg16_jax_features_fn`: VGG-16 from local weights (``.npz``, a
  torchvision ``state_dict`` file or a list of ``(w, b)``);
* :func:`vgg16_features_fn`: torchvision's pretrained VGG-16, where
  torchvision is installed.

The convolutions are ``torch.nn.functional.conv2d``: on a GPU they run in
cuDNN at the precision that ``torch.backends.cudnn.allow_tf32`` sets (TF32
by default), which this module leaves to the caller.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG-16 ``features`` indices of the relu outputs of each conv block
VGG_BLOCK_INDEXES = [[1, 3], [6, 8], [11, 13, 15], [18, 20, 22], [25, 27, 29]]


def _moments(pixels: torch.Tensor):
    """Mean ``[1, 3]`` and covariance ``[3, 3]`` of a ``[M, 3]`` pixel set."""
    mean = pixels.mean(0, keepdim=True)
    centered = pixels - mean
    return mean, centered.T @ centered / pixels.shape[0]


def _psd_power(mat: torch.Tensor, exponent: float) -> torch.Tensor:
    """``mat ** exponent`` of a symmetric PSD matrix, by its eigensystem
    (eigenvalues clipped to [1e-8, 1e8])."""
    eigval, eigvec = torch.linalg.eigh(mat)
    powed = torch.clamp(eigval, 1e-8, 1e8) ** exponent
    return (eigvec * powed[None, :]) @ eigvec.T


def match_colors_for_image_set(image_set: torch.Tensor,
                               style_img: torch.Tensor):
    """Linear colour transfer of ``image_set [N, H, W, 3]``'s colour
    statistics onto ``style_img [Hs, Ws, 3]``'s: whiten with
    ``cov_content ** -1/2``, recolour with ``cov_style ** 1/2``, re-centre.
    Returns the recoloured set clipped to [0, 1] and the ``[4, 4]`` affine
    colour transform (the 3x3 matrix, the translation in the last
    column)."""
    shape = image_set.shape
    content = image_set.reshape(-1, 3)
    mean_c, cov_c = _moments(content)
    mean_s, cov_s = _moments(style_img.reshape(-1, 3))

    linear = _psd_power(cov_s, 0.5) @ _psd_power(cov_c, -0.5)
    offset = mean_s - mean_c @ linear.T

    recolored = torch.clamp(content @ linear.T + offset, 0.0, 1.0)

    affine = torch.eye(4, dtype=image_set.dtype, device=image_set.device)
    affine[:3, :3] = linear
    affine[:3, 3] = offset[0]
    return recolored.reshape(shape), affine


def _normalize_chn(a: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """L2-normalise ``[C, M]`` over the channel (first) axis."""
    n = torch.sqrt(torch.sum(a * a, dim=0, keepdim=True) + eps)
    return a / (n + eps)


def nn_feat_replace(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each column (pixel) of ``a [C, M]``, the cosine-nearest column
    of ``b [C, M2]``."""
    an = _normalize_chn(a)
    bn = _normalize_chn(b)
    d = 1.0 - an.T @ bn
    idx = torch.argmin(d, dim=1)
    return b[:, idx]


def cos_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean of ``1 - cos`` over the pixels of ``[C, M]`` maps."""
    an = _normalize_chn(a)
    bn = _normalize_chn(b)
    return torch.mean(1.0 - torch.sum(an * bn, dim=0))


def gram_matrix(feats: torch.Tensor, center: bool = False) -> torch.Tensor:
    """``[C, C]`` Gram matrix of a ``[C, M]`` feature map."""
    if center:
        feats = feats - feats.mean(dim=1, keepdim=True)
    return feats @ feats.T


def nnfm_losses(
    x_feats: Sequence[torch.Tensor],
    s_feats: Sequence[torch.Tensor],
    loss_names: Sequence[str] = ("nnfm_loss",),
    content_feats: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The named losses summed over per-block ``[C, H, W]`` feature maps;
    the style and content maps, and the NNFM targets, are constants (no
    gradient reaches them)."""
    for nm in loss_names:
        assert nm in ("nnfm_loss", "content_loss", "gram_loss"), nm
    dev = x_feats[0].device
    out = {nm: torch.zeros((), device=dev) for nm in loss_names}
    for bi, (xf, sf) in enumerate(zip(x_feats, s_feats)):
        x2 = xf.reshape(xf.shape[0], -1)
        s2 = sf.reshape(sf.shape[0], -1).detach()
        if "nnfm_loss" in out:
            target = nn_feat_replace(x2, s2).detach()
            out["nnfm_loss"] = out["nnfm_loss"] + cos_loss(x2, target)
        if "gram_loss" in out:
            n_x = x2.shape[1]
            n_s = s2.shape[1]
            out["gram_loss"] = out["gram_loss"] + torch.mean(
                (gram_matrix(x2) / n_x - gram_matrix(s2) / n_s) ** 2)
        if "content_loss" in out:
            cf = content_feats[bi].reshape(x2.shape[0], -1).detach()
            out["content_loss"] = out["content_loss"] + torch.mean(
                (cf - x2) ** 2)
    return out


# ---- feature extractors -----------------------------------------------------

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class _ImageNetInput(nn.Module):
    """Holds the ImageNet normalisation that every extractor applies to its
    ``[3, H, W]`` input in [0, 1]."""

    def __init__(self, device):
        super().__init__()
        self.register_buffer(
            "mean", torch.tensor(_IMAGENET_MEAN, device=device)[:, None, None])
        self.register_buffer(
            "std", torch.tensor(_IMAGENET_STD, device=device)[:, None, None])

    def normalize(self, img_chw: torch.Tensor) -> torch.Tensor:
        return ((img_chw - self.mean) / self.std)[None]


class RandomConvFeatures(_ImageNetInput):
    """Per block: a fixed 3x3 conv (no bias, "same" padding), relu (the
    block's map), then a 2x2 average pool."""

    def __init__(self, kernels: Sequence[torch.Tensor], device):
        super().__init__(device)
        self.n_blocks = len(kernels)
        for i, k in enumerate(kernels):
            self.register_buffer(f"kernel{i}", k.to(device=device,
                                                    dtype=torch.float32))

    def forward(self, img_chw: torch.Tensor,
                blocks: Sequence[int]) -> List[torch.Tensor]:
        x = self.normalize(img_chw)
        feats = []
        for bi in range(min(self.n_blocks, max(blocks) + 1)):
            x = F.relu(F.conv2d(x, getattr(self, f"kernel{bi}"), padding=1))
            if bi in blocks:
                feats.append(x[0])
            x = F.avg_pool2d(x, 2)
        return feats


def random_conv_features_fn(
    generator: Optional[torch.Generator] = None,
    widths: Sequence[int] = (64, 128, 256),
    kernels: Optional[Sequence[np.ndarray]] = None,
    device="cuda",
) -> RandomConvFeatures:
    """A multi-scale feature extractor that needs no weights file: fixed
    random 3x3 convs + relu + 2x2 average pool, one block per width.

    The kernels are ``kernels`` (``[O, I, 3, 3]`` arrays, used as given)
    or, by default, drawn N(0, 2 / (9 I)) from ``generator`` (a CPU
    ``torch.Generator`` seeded with 17 unless given).  The JAX package draws
    them from ``jax.random.PRNGKey(17)``, which this package cannot
    reproduce: the default features differ from JAX's, the function does
    not; pass JAX's kernels through ``kernels`` for the same features."""
    if kernels is None:
        if generator is None:
            generator = torch.Generator().manual_seed(17)
        kernels, c_in = [], 3
        for w in widths:
            kernels.append(torch.randn((w, c_in, 3, 3), generator=generator)
                           * math.sqrt(2.0 / (9 * c_in)))
            c_in = w
    else:
        kernels = [torch.tensor(np.asarray(k, np.float32)) for k in kernels]
    return RandomConvFeatures(kernels, device)


# VGG-16: the 3x3 conv widths of each block, a 2x2 max pool after each
# block; a block's map is its last relu (the LPIPS taps)
_VGG16_CFG = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
    (512, 512, 512),
)


class VGG16Features(_ImageNetInput):
    """VGG-16's conv blocks from given weights: per block its convs (with
    bias, "same" padding) and relus, the block's map, then a 2x2 max
    pool."""

    def __init__(self, pairs, device):
        super().__init__(device)
        assert len(pairs) == 13, f"VGG16 has 13 conv layers, got {len(pairs)}"
        for i, (w, b) in enumerate(pairs):
            self.register_buffer(f"w{i}", w.to(device=device,
                                               dtype=torch.float32))
            self.register_buffer(f"b{i}", b.to(device=device,
                                               dtype=torch.float32))

    def forward(self, img_chw: torch.Tensor,
                blocks: Sequence[int]) -> List[torch.Tensor]:
        x = self.normalize(img_chw)
        feats = []
        li = 0
        for bi in range(min(len(_VGG16_CFG), max(blocks) + 1)):
            for _ in _VGG16_CFG[bi]:
                x = F.relu(F.conv2d(x, getattr(self, f"w{li}"),
                                    getattr(self, f"b{li}"), padding=1))
                li += 1
            if bi in blocks:
                feats.append(x[0])
            x = F.max_pool2d(x, 2)
        return feats


def vgg16_jax_features_fn(weights, device="cuda") -> VGG16Features:
    """VGG-16 block features from local weights, differentiable (the
    port's counterpart of the JAX package's function of this name, which
    runs in JAX; here it runs in PyTorch).

    ``weights``: a path to a ``.npz`` of arrays ``conv{i}_w`` / ``conv{i}_b``
    (i = 0..12, OIHW kernels), or to a torch file of a torchvision VGG16
    ``state_dict`` (keys ``features.N.weight``), or a list of ``(w, b)``
    pairs.  Block b's map is the last relu of VGG block b (the LPIPS
    taps)."""
    if isinstance(weights, (list, tuple)):
        pairs = [(torch.tensor(np.asarray(w)), torch.tensor(np.asarray(b)))
                 for w, b in weights]
    elif str(weights).endswith(".npz"):
        z = np.load(weights)
        pairs = [(torch.as_tensor(z[f"conv{i}_w"]),
                  torch.as_tensor(z[f"conv{i}_b"])) for i in range(13)]
    else:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        conv_keys = sorted(
            (k for k in sd if k.endswith(".weight") and sd[k].dim() == 4),
            key=lambda k: int(k.split(".")[1]))
        pairs = [(sd[k], sd[k.replace(".weight", ".bias")])
                 for k in conv_keys]
    return VGG16Features(pairs, device)


class _TorchvisionVGG16Features(nn.Module):
    def __init__(self, vgg, device):
        super().__init__()
        self.features = vgg.features.to(device).eval()
        self.inp = _ImageNetInput(device)

    def forward(self, img_chw: torch.Tensor,
                blocks: Sequence[int]) -> List[torch.Tensor]:
        layer_ids = [i for b in sorted(blocks) for i in VGG_BLOCK_INDEXES[b]]
        x = self.inp.normalize(img_chw)
        outputs = {}
        with torch.no_grad():
            for ix, layer in enumerate(self.features):
                x = layer(x)
                if ix in layer_ids:
                    outputs[ix] = x[0]
                if ix == max(layer_ids):
                    break
        # each block's relu maps concatenated along the channels
        return [torch.cat([outputs[i] for i in VGG_BLOCK_INDEXES[b]], 0)
                for b in sorted(blocks)]


def vgg16_features_fn(device="cuda") -> nn.Module:
    """torchvision's pretrained VGG-16 relu maps of each block, concatenated
    along the channels, without gradients; raises ImportError where
    torchvision is not installed (use :func:`vgg16_jax_features_fn` with
    local weights, or :func:`random_conv_features_fn`)."""
    try:
        import torchvision
    except ImportError as e:
        raise ImportError(
            "vgg16_features_fn requires torchvision (not installed in this"
            " environment); use random_conv_features_fn instead.") from e
    vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1")
    return _TorchvisionVGG16Features(vgg, device)


class NNFMLoss(nn.Module):
    """The style losses of a rendered image against a style image (and a
    content image), from ``features_fn`` (by default
    :func:`random_conv_features_fn` on ``device``)."""

    def __init__(self, features_fn: Optional[nn.Module] = None,
                 device="cuda"):
        super().__init__()
        self.features_fn = (random_conv_features_fn(device=device)
                            if features_fn is None else features_fn)

    def forward(
        self,
        outputs: torch.Tensor,            # [3, H, W] rendered image
        styles: torch.Tensor,             # [3, Hs, Ws] style image
        blocks: Sequence[int] = (2,),
        loss_names: Sequence[str] = ("nnfm_loss",),
        contents: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        blocks = sorted(blocks)
        x_feats = self.features_fn(outputs, blocks)
        s_feats = self.features_fn(styles, blocks)
        content_feats = (self.features_fn(contents, blocks)
                         if contents is not None else None)
        return nnfm_losses(x_feats, s_feats, loss_names, content_feats)
