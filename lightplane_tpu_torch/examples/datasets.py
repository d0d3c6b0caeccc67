"""Posed-image datasets as per-pixel rays (counterpart of the JAX package's
``examples/utils/datasets.py``), in numpy on the port's
``utils/cameras.py``.

The procedural synthetic scene needs no download and is what the fitting
example trains on by default.  The file loaders read NeRF-synthetic
(Blender), LLFF, NSVF and CO3D directories; :func:`auto_dataset` detects
which.  PNG files are read by ``utils/io_utils.py::read_png`` and need no
image library; any other file (LLFF's and CO3D's JPEGs) is opened with PIL,
as the JAX loader opens every file.  The JAX loader's resamplers are
rewritten in numpy: PIL's LANCZOS downsample (``_resize_lanczos``, PIL's
two-pass fixed-point resampler, equal to PIL's output on 8-bit images) and
OpenCV's ``INTER_AREA`` resize of CO3D's float images (``_resize_area``,
OpenCV's area weights, and its linear rule where an axis grows).
"""

from __future__ import annotations

import dataclasses
import gzip
import inspect
import json
import math
import os
from typing import Optional

import numpy as np

from ..utils.cameras import camera_rays, sphere_cameras
from ..utils.io_utils import is_png, read_png


@dataclasses.dataclass
class RayDataset:
    """Flattened per-pixel rays of ``n_images`` images, with their
    ground-truth colours.

    ``frame_hw`` (``[n_images, 2]`` int) holds each image's size where the
    images differ in size (CO3D with ``keep_frame_sizes``); then ``height``
    and ``width`` are the first image's.  ``None`` means every image is
    ``height x width``."""

    origins: np.ndarray     # [N, 3]
    directions: np.ndarray  # [N, 3]
    gt: np.ndarray          # [N, 3]
    near: float
    far: float
    height: int
    width: int
    n_images: int
    frame_hw: Optional[np.ndarray] = None   # [n_images, 2] int, or None

    def frame_offsets(self) -> np.ndarray:
        """Index of each image's first ray, and the number of rays
        (``n_images + 1`` entries)."""
        if self.frame_hw is None:
            hw = self.height * self.width
            return np.arange(self.n_images + 1, dtype=np.int64) * hw
        return np.concatenate(
            [[0], np.cumsum(self.frame_hw.prod(axis=1).astype(np.int64))])

    def image(self, i: int):
        """``(origins, directions, gt [H, W, 3])`` of image ``i``."""
        off = self.frame_offsets()
        sl = slice(int(off[i]), int(off[i + 1]))
        if self.frame_hw is None:
            h, w = self.height, self.width
        else:
            h, w = (int(x) for x in self.frame_hw[i])
        return self.origins[sl], self.directions[sl], self.gt[sl].reshape(
            h, w, 3)


# ---- image files ------------------------------------------------------------

# PIL's resampler keeps its filter taps as fixed-point integers with this
# many fraction bits, and rounds each pass to 8 bits
_PRECISION_BITS = 32 - 8 - 2


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """PIL's LANCZOS filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    def sinc(v):
        pv = np.pi * np.where(v == 0.0, 1.0, v)
        return np.where(v == 0.0, 1.0, np.sin(pv) / pv)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _lanczos_taps(in_size: int, out_size: int):
    """PIL's taps (``precompute_coeffs`` and ``normalize_coeffs_8bpc``) for
    resizing ``in_size`` samples to ``out_size``: ``(first [out], weights
    [out, K])``, where output ``i`` sums inputs ``first[i] + k`` (clamped
    to the input, where the weight is 0) times ``weights[i, k]``, integers
    scaled by ``2 ** _PRECISION_BITS``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward 0; a negative start clamps to 0 anyway
    first = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    last = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64)
    k = np.arange(ksize)
    x = first[:, None] + k[None, :]
    taps = _lanczos3((x - center[:, None] + 0.5) / filterscale)
    taps = np.where(x < last[:, None], taps, 0.0)
    total = taps.sum(axis=1, keepdims=True)
    taps = taps / np.where(total == 0.0, 1.0, total)
    taps = taps * (1 << _PRECISION_BITS)
    # rounded half away from zero, as the C code's (int)(v +- 0.5)
    weights = np.trunc(np.where(taps < 0, taps - 0.5, taps + 0.5))
    return first, weights.astype(np.int64)


def _lanczos_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    first, weights = _lanczos_taps(img.shape[axis], out_size)
    n = img.shape[axis]
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    shape = [1] * img.ndim
    shape[axis] = out_size
    for k in range(weights.shape[1]):
        src = np.take(img, np.minimum(first + k, n - 1), axis=axis)
        acc += src * weights[:, k].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def _resize_lanczos(arr: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``PIL.Image.fromarray(arr).resize((out_w, out_h), Image.LANCZOS)`` of
    an 8-bit image (``[H, W]`` or ``[H, W, C]``) in numpy: a horizontal then
    a vertical pass of PIL's taps, each rounded to 8 bits.  With an alpha
    channel (2 or 4 channels) the colours are premultiplied by it first
    and divided by it after, as PIL resizes "LA" and "RGBA" images."""
    a = np.asarray(arr).astype(np.int64)
    alpha = a.ndim == 3 and a.shape[-1] in (2, 4)
    if alpha:
        t = a[..., :-1] * a[..., -1:] + 128
        a = np.concatenate([((t >> 8) + t) >> 8, a[..., -1:]], axis=-1)
    h, w = a.shape[:2]
    if out_w != w:
        a = _lanczos_pass(a, out_w, 1)
    if out_h != h:
        a = _lanczos_pass(a, out_h, 0)
    if alpha:
        al = a[..., -1:]
        rgb = np.where((al == 0) | (al == 255), a[..., :-1],
                       np.clip(255 * a[..., :-1] // np.maximum(al, 1), 0, 255))
        a = np.concatenate([rgb, al], axis=-1)
    return a.astype(np.uint8)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """OpenCV's ``INTER_AREA`` weights of one axis, ``[dst, src]``: each
    output the mean of the input cells it covers, part-covered cells by
    their covered share (``computeResizeAreaTab``), where no axis grows;
    else OpenCV's linear rule of that mode (``resizeGeneric`` with
    ``area_mode``)."""
    inv = dst / src
    scale = 1.0 / inv
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += np.float32((s1 - f1) / cell)
        w[d, s1:s2] += np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] += np.float32(min(f2 - s2, 1.0, cell) / cell)
    return w


def _linear_area_weights(src: int, dst: int) -> np.ndarray:
    inv = dst / src
    scale = 1.0 / inv
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.floor(f)
        if s >= src - 1:
            w[d, src - 1] = 1.0
        else:
            w[d, s] = np.float32(1.0) - f
            w[d, s + 1] = f
    return w


def _resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` of
    a float32 ``[H, W, C]`` image, in numpy (f64 sums)."""
    h, w, c = img.shape
    if (out_h, out_w) == (h, w):
        return img.copy()
    weights = (_area_weights if w >= out_w and h >= out_h
               else _linear_area_weights)
    wy, wx = weights(h, out_h), weights(w, out_w)
    out = (wy @ img.astype(np.float64).reshape(h, w * c)).reshape(out_h, w, c)
    out = np.einsum("xs,ysc->yxc", wx, out, optimize=True)
    return out.astype(np.float32)


def _load_image(path: str, downsample: int = 1) -> np.ndarray:
    """An image file as float32 in [0, 1], ``downsample`` times smaller
    (PIL's LANCZOS), an alpha channel composited over white."""
    if is_png(path):
        arr = read_png(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs PIL (Pillow): only PNG files are read "
                "without it") from e
        arr = np.asarray(Image.open(path))
    if downsample > 1:
        arr = _resize_lanczos(arr, arr.shape[1] // downsample,
                              arr.shape[0] // downsample)
    arr = arr.astype(np.float32) / 255.0
    if arr.shape[-1] == 4:  # composite alpha over white
        arr = arr[..., :3] * arr[..., 3:] + (1.0 - arr[..., 3:])
    return arr


# ---- datasets ---------------------------------------------------------------


def _synthetic_blobs(seed: int):
    rng = np.random.RandomState(seed)
    n_blobs = 6
    centers = rng.uniform(-0.5, 0.5, (n_blobs, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (n_blobs, 3)).astype(np.float32)
    radii = rng.uniform(0.15, 0.3, (n_blobs,)).astype(np.float32)
    return centers, colors, radii


# rays of a synthetic view marched at a time, to bound the host memory
_VIEW_CHUNK = 16384


def synthetic_view(c2w, image_size: int, near: float = 1.0, far: float = 5.0,
                   seed: int = 0):
    """One view of the synthetic scene of ``seed`` from camera ``c2w``
    (focal length 1.2 x ``image_size``): ``(img [S, S, 3]`` over a white
    background, ``alpha [S, S])``, the opacity ``1 - T`` that the march
    leaves, in rays of ``_VIEW_CHUNK`` at a time."""
    chunk = _VIEW_CHUNK
    centers, colors, radii = _synthetic_blobs(seed)
    o, d = camera_rays(c2w, image_size, image_size, image_size * 1.2, near,
                       far)
    ts = np.linspace(near, far, 64, dtype=np.float32)
    delta = ts[1] - ts[0]
    img = np.empty((o.shape[0], 3), np.float32)
    alpha = np.empty((o.shape[0],), np.float32)
    for a in range(0, o.shape[0], chunk):
        pts = o[a:a + chunk, None, :] + ts[None, :, None] * d[a:a + chunk,
                                                              None, :]
        sigma = np.zeros(pts.shape[:2], np.float32)
        rgb = np.zeros(pts.shape[:2] + (3,), np.float32)
        wsum = np.zeros(pts.shape[:2], np.float32)
        for c, col, r in zip(centers, colors, radii):
            d2 = np.sum((pts - c) ** 2, -1)
            blob = np.exp(-d2 / (2 * r ** 2)).astype(np.float32)
            sigma += 25.0 * blob
            rgb += blob[..., None] * col
            wsum += blob
        rgb = rgb / np.maximum(wsum[..., None], 1e-6)
        nlt = np.cumsum(sigma * delta, -1)
        T = np.exp(-np.concatenate(
            [np.zeros_like(nlt[:, :1]), nlt], axis=-1))
        w = T[:, :-1] - T[:, 1:]
        img[a:a + chunk] = (w[..., None] * rgb).sum(1) + T[:, -1:]
        alpha[a:a + chunk] = 1.0 - T[:, -1]
    return (img.reshape(image_size, image_size, 3),
            alpha.reshape(image_size, image_size))


def make_synthetic_scene(
    n_views: int = 24,
    image_size: int = 64,
    near: float = 1.0,
    far: float = 5.0,
    seed: int = 0,
) -> RayDataset:
    """A procedurally rendered scene: six soft coloured blobs rendered by
    an analytic Emission-Absorption march over a white background, from
    ``n_views`` cameras on a circle of radius 3 (:func:`synthetic_view`)."""
    c2ws = sphere_cameras(n_views, radius=3.0)
    imgs = [synthetic_view(c2w, image_size, near, far, seed)[0]
            for c2w in c2ws]
    return _build_dataset(imgs, list(c2ws), image_size * 1.2, near, far)


def _build_dataset(imgs, c2ws, focal, near, far) -> RayDataset:
    H, W = imgs[0].shape[:2]
    all_o, all_d, all_gt = [], [], []
    for img, c2w in zip(imgs, c2ws):
        o, d = camera_rays(c2w, H, W, focal, near, far)
        all_o.append(o)
        all_d.append(d)
        all_gt.append(img.reshape(-1, 3).astype(np.float32))
    return RayDataset(
        origins=np.concatenate(all_o),
        directions=np.concatenate(all_d),
        gt=np.concatenate(all_gt),
        near=near,
        far=far,
        height=H,
        width=W,
        n_images=len(imgs),
    )


def load_nerf_synthetic(
    root: str,
    split: str = "train",
    downsample: int = 1,
    near: float = 2.0,
    far: float = 6.0,
) -> RayDataset:
    """Blender NeRF-synthetic layout: ``transforms_{split}.json`` (with
    ``camera_angle_x`` and each frame's ``file_path``, with or without
    ``.png``, and ``transform_matrix``) and the images it names."""
    with open(os.path.join(root, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    imgs, c2ws = [], []
    for fr in meta["frames"]:
        fp = os.path.join(root, fr["file_path"] + ".png")
        if not os.path.exists(fp):
            fp = os.path.join(root, fr["file_path"])
        imgs.append(_load_image(fp, downsample))
        c2ws.append(np.asarray(fr["transform_matrix"], np.float32))
    W = imgs[0].shape[1]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    return _build_dataset(imgs, c2ws, focal, near, far)


def load_llff(
    root: str,
    downsample: int = 4,
    holdout_every: int = 8,
    split: str = "train",
) -> RayDataset:
    """LLFF layout: ``poses_bounds.npy`` and ``images_{downsample}/`` (or
    ``images/``, then downsampled here).  Poses go from LLFF's [down,
    right, back] to OpenGL's [right, up, back] and are scaled so that the
    nearest bound is 4/3; every ``holdout_every``-th image is held out of
    the train split."""
    poses_bounds = np.load(os.path.join(root, "poses_bounds.npy"))
    poses = poses_bounds[:, :-2].reshape(-1, 3, 5)
    bounds = poses_bounds[:, -2:]

    img_dir = None
    for cand in (f"images_{downsample}", "images"):
        d = os.path.join(root, cand)
        if os.path.isdir(d):
            img_dir = d
            break
    assert img_dir is not None, f"no images dir under {root}"
    files = sorted(f for f in os.listdir(img_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    ds = 1 if img_dir.endswith(f"_{downsample}") else downsample
    imgs = [_load_image(os.path.join(img_dir, f), ds) for f in files]

    c2ws = []
    for p in poses:
        m = np.eye(4, dtype=np.float32)
        m[:3, :4] = np.concatenate(
            [p[:, 1:2], -p[:, 0:1], p[:, 2:3], p[:, 3:4]], axis=1)
        c2ws.append(m)
    scale = 1.0 / (float(bounds.min()) * 0.75)
    for m in c2ws:
        m[:3, 3] *= scale
    near = float(bounds.min()) * scale * 0.9
    far = float(bounds.max()) * scale * 1.1
    focal = float(poses[0, 2, 4]) / ds

    sel = [i for i in range(len(imgs))
           if (i % holdout_every != 0) == (split == "train")]
    return _build_dataset([imgs[i] for i in sel], [c2ws[i] for i in sel],
                          focal, near, far)


def load_nsvf(
    root: str,
    split: str = "train",
    downsample: int = 1,
    near: float = 0.5,
    far: float = 6.0,
) -> RayDataset:
    """NSVF layout: ``intrinsics.txt`` (focal length first), ``pose/*.txt``
    (camera-to-world matrices) and ``rgb/*.png`` (or ``.jpg``), the split
    in the file name's prefix (``0_`` train, ``1_`` val, ``2_`` test)."""
    with open(os.path.join(root, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0]) / downsample
    prefix = {"train": "0_", "val": "1_", "test": "2_"}[split]
    pose_dir = os.path.join(root, "pose")
    rgb_dir = os.path.join(root, "rgb")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(pose_dir)
                   if f.startswith(prefix))
    imgs, c2ws = [], []
    for n in names:
        c2ws.append(np.loadtxt(os.path.join(pose_dir, n + ".txt")).astype(
            np.float32))
        for ext in (".png", ".jpg"):
            fp = os.path.join(rgb_dir, n + ext)
            if os.path.exists(fp):
                imgs.append(_load_image(fp, downsample))
                break
    return _build_dataset(imgs, c2ws, focal, near, far)


def similarity_from_cameras(c2w: np.ndarray):
    """The similarity that normalises a set of OpenCV-convention cameras:
    the mean camera up turned to world +z, the centre moved to the median
    closest point of the cameras' centre rays, and the median camera
    distance scaled to 1.  Returns ``(transform [4, 4], scale)``."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    up_camspace = np.array([0.0, -1.0, 0.0])
    world_up = np.mean(np.sum(R * up_camspace, axis=-1), axis=0)
    world_up /= np.linalg.norm(world_up)

    c = float((up_camspace * world_up).sum())
    cross = np.cross(world_up, up_camspace)
    skew = np.array([
        [0.0, -cross[2], cross[1]],
        [cross[2], 0.0, -cross[0]],
        [-cross[1], cross[0], 0.0],
    ])
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        R_align = np.diag([-1.0, 1.0, 1.0])

    R = R_align @ R
    fwds = np.sum(R * np.array([0.0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]

    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)

    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align
    scale = 1.0 / np.median(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


def load_co3d(
    root: str,
    split: str = "train",
    seq_id: int = 0,
    max_image_dim: int = 800,
    max_pose_dist: float = 5.0,
    cam_scale_factor: float = 0.95,
    hold_every: int = 8,
    near: float = 0.1,
    far: float = 6.0,
    downsample: int = 1,
    keep_frame_sizes: bool = True,
) -> RayDataset:
    """CO3D layout: per-category ``frame_annotations.jgz`` with PyTorch3D
    viewpoints (R, T, NDC focal length and principal point), turned into
    OpenCV-convention cameras with pixel intrinsics and normalised by
    :func:`similarity_from_cameras`.  ``seq_id`` picks the sequence (sorted
    by category, then name); every ``hold_every``-th frame is held out of
    the train split; cameras farther than ``max_pose_dist`` times the
    median distance from the median centre are dropped.

    With ``keep_frame_sizes`` each frame keeps its size, scaled down with
    its aspect where its longer side passes ``max_image_dim``, and its
    intrinsics scaled with it (``RayDataset.frame_hw``); without, every
    frame is resized to the first kept frame's (bounded) size, for
    consumers of one raster size (the fitting example)."""
    if max_image_dim and downsample > 1:
        max_image_dim = max_image_dim // downsample

    cats = sorted(x for x in os.listdir(root)
                  if os.path.isdir(os.path.join(root, x)))
    assert cats, f"no category directories under {root}"

    cam_trans = np.diag(np.array([-1, -1, 1, 1], np.float64))
    seqs: dict = {}
    for cat in cats:
        ann = os.path.join(root, cat, "frame_annotations.jgz")
        if not os.path.exists(ann):
            continue
        with gzip.open(ann, "r") as f:
            frames = json.load(f)
        for fr in frames:
            key = (cat, fr["sequence_name"])
            H, W = fr["image"]["size"]
            half_wh = np.array([W * 0.5, H * 0.5], np.float64)
            R = np.asarray(fr["viewpoint"]["R"], np.float64)
            T = np.asarray(fr["viewpoint"]["T"], np.float64)
            pose = np.eye(4)
            pose[:3, :3] = R
            pose[:3, 3] = -R @ T
            pose = pose @ cam_trans
            seqs.setdefault(key, []).append(dict(
                frame_number=fr["frame_number"],
                image_path=fr["image"]["path"],
                pose=pose,
                # NDC -> pixel intrinsics
                fxy=np.asarray(fr["viewpoint"]["focal_length"]) * half_wh,
                cxy=-(np.asarray(fr["viewpoint"]["principal_point"]) - 1.0)
                * half_wh,
            ))
    keys = sorted(seqs.keys())
    assert 0 <= seq_id < len(keys), (
        f"seq_id {seq_id} out of range ({len(keys)} sequences)")
    fd = sorted(seqs[keys[seq_id]], key=lambda x: x["frame_number"])

    ref_c2ws = np.stack([x["pose"] for x in fd])
    keep = [i for i in range(len(fd))
            if (i % hold_every != 0) == (split.endswith("train"))]

    imgs, c2ws, intrins = [], [], []
    target_hw = None
    for i in keep:
        img = _load_image(os.path.join(root, fd[i]["image_path"]))
        h, w = img.shape[:2]
        scale0 = min(1.0, max_image_dim / max(h, w))
        if keep_frame_sizes:
            out_hw = (max(1, round(h * scale0)), max(1, round(w * scale0)))
        else:
            if target_hw is None:
                target_hw = (int(h * scale0), int(w * scale0))
            out_hw = target_hw
        sc = np.array([out_hw[1] / w, out_hw[0] / h], np.float32)
        if out_hw != (h, w):
            img = _resize_area(img, *out_hw)
        imgs.append(img)
        c2ws.append(fd[i]["pose"])
        intrins.append((fd[i]["fxy"] * sc, fd[i]["cxy"] * sc))
    c2w = np.stack(c2ws)

    # drop outlier poses
    dists = np.linalg.norm(
        c2w[:, :3, 3] - np.median(c2w[:, :3, 3], axis=0), axis=-1)
    good = dists < np.median(dists) * max_pose_dist
    imgs = [im for im, g in zip(imgs, good) if g]
    intrins = [x for x, g in zip(intrins, good) if g]
    c2w = c2w[good]

    T_sim, sscale = similarity_from_cameras(ref_c2ws)
    c2w = T_sim @ c2w
    c2w[:, :3, 3] *= cam_scale_factor * sscale

    all_o, all_d, all_gt, frame_hw = [], [], [], []
    for img, pose, (fxy, cxy) in zip(imgs, c2w, intrins):
        H, W = img.shape[:2]
        frame_hw.append((H, W))
        i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32), indexing="xy")
        # OpenCV convention: +z forward, +y down
        dirs_cam = np.stack(
            [(i - cxy[0]) / fxy[0], (j - cxy[1]) / fxy[1], np.ones_like(i)],
            axis=-1).reshape(-1, 3)
        dirs = dirs_cam @ pose[:3, :3].T.astype(np.float32)
        all_o.append(np.broadcast_to(pose[:3, 3].astype(np.float32),
                                     dirs.shape).copy())
        all_d.append(dirs.astype(np.float32))
        all_gt.append(img.reshape(-1, 3).astype(np.float32))
    frame_hw = np.asarray(frame_hw, np.int64)
    uniform = bool((frame_hw == frame_hw[0]).all())
    return RayDataset(
        origins=np.concatenate(all_o),
        directions=np.concatenate(all_d),
        gt=np.concatenate(all_gt),
        near=near,
        far=far,
        height=int(frame_hw[0, 0]),
        width=int(frame_hw[0, 1]),
        n_images=len(imgs),
        frame_hw=None if uniform else frame_hw,
    )


_ALL_LOADERS = (make_synthetic_scene, load_nerf_synthetic, load_llff,
                load_nsvf, load_co3d)


def auto_dataset(root: Optional[str], dataset_type: str = "auto",
                 **kwargs) -> RayDataset:
    """The dataset under ``root``, its format detected from the directory
    (``transforms_train.json``: NeRF-synthetic, ``poses_bounds.npy``:
    LLFF, ``intrinsics.txt``: NSVF, a sub-directory with
    ``frame_annotations.jgz``: CO3D) unless ``dataset_type`` names it;
    ``root=None`` (or ``dataset_type="synthetic"``) gives the synthetic
    scene.  A keyword that no loader takes raises ``TypeError``; one that
    only other loaders take is dropped."""
    def call(loader, *args):
        known = set().union(*(set(inspect.signature(f).parameters)
                              for f in _ALL_LOADERS))
        unknown = set(kwargs) - known
        if unknown:
            raise TypeError(f"auto_dataset got kwargs unknown to every "
                            f"loader: {sorted(unknown)}")
        accepted = set(inspect.signature(loader).parameters)
        return loader(*args, **{k: v for k, v in kwargs.items()
                                if k in accepted})

    if root is None or dataset_type == "synthetic":
        return call(make_synthetic_scene)
    if dataset_type == "auto":
        if os.path.exists(os.path.join(root, "transforms_train.json")):
            dataset_type = "nerf"
        elif os.path.exists(os.path.join(root, "poses_bounds.npy")):
            dataset_type = "llff"
        elif os.path.exists(os.path.join(root, "intrinsics.txt")):
            dataset_type = "nsvf"
        elif any(
            os.path.exists(os.path.join(root, d, "frame_annotations.jgz"))
            for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        ):
            dataset_type = "co3d"
        else:
            raise ValueError(f"cannot detect dataset type under {root}")
    loaders = {"nerf": load_nerf_synthetic, "llff": load_llff,
               "nsvf": load_nsvf, "co3d": load_co3d}
    if dataset_type not in loaders:
        raise ValueError(f"unknown dataset type {dataset_type!r}")
    return call(loaders[dataset_type], root)
