"""The PyTorch port's data layer against the JAX package's: ``read_png``
against PIL, the numpy resamplers against PIL's LANCZOS and OpenCV's
``INTER_AREA``, and each file loader of ``examples/datasets.py``
(NeRF-synthetic, LLFF, NSVF, CO3D) against ``examples/utils/datasets.py``
on tiny directories written here, with ``auto_dataset``'s detection and
keyword rule.

Tolerances: ``read_png`` equals PIL's decode exactly; the LANCZOS
downsample within 1 of PIL's 8-bit output on every pixel (the share of
pixels that differ is printed; it is 0 on these inputs with Pillow 12);
``INTER_AREA`` within 1e-5 of OpenCV (f64 sums against OpenCV's f32 ones);
loaded pixels equal at ``downsample=1`` and within 1/255 (one 8-bit step)
after a downsample, or within 1e-5 after CO3D's area resize; rays within
1e-6 (the same numpy arithmetic on both sides, camera matrices rounded
through f32).
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it

from lightplane_tpu_torch.examples import datasets as tds  # noqa: E402
from lightplane_tpu_torch.utils import io_utils  # noqa: E402
from lightplane_tpu_torch.utils.cameras import sphere_cameras  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

def _jax_datasets():
    from utils import datasets

    return datasets


def _smooth_image(rng, h, w, ch):
    """uint8 pictures with gradients and noise, so that PNG encoders pick
    varied row filters."""
    yy, xx = np.mgrid[:h, :w]
    base = (yy[..., None] * (3 + np.arange(ch)) + xx[..., None] * 5)
    return ((base + rng.integers(0, 40, (h, w, ch))) % 256).astype(np.uint8)


def _assert_same_dataset(got, want, gt_atol=0.0, gt_exact=True):
    for name in ("origins", "directions"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-6, rtol=0, err_msg=name)
    if gt_exact:
        np.testing.assert_array_equal(got.gt, want.gt)
    else:
        np.testing.assert_allclose(got.gt, want.gt, atol=gt_atol, rtol=0)
    assert (got.near, got.far, got.height, got.width, got.n_images) == (
        want.near, want.far, want.height, want.width, want.n_images)
    if want.frame_hw is None:
        assert got.frame_hw is None
    else:
        np.testing.assert_array_equal(got.frame_hw, want.frame_hw)
    np.testing.assert_array_equal(got.frame_offsets(), want.frame_offsets())


# ---- PNG ----------------------------------------------------------------


def _png(path, arr, color_type, kinds=None, interlace=0, depth=8):
    """A PNG written here, independently of the port: each row filtered
    with ``kinds[y % len(kinds)]`` (0 none, 1 sub, 2 up, 3 average, 4
    Paeth)."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).astype(np.int32)
    bpp = rows.shape[1] // w
    kinds = kinds or [0]
    out, prior = [], np.zeros_like(rows[0])
    for y in range(h):
        x, kind = rows[y], kinds[y % len(kinds)]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b = prior
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][kind]
        out.append(np.concatenate([[kind], (x - pred) % 256]))
        prior = x
    data = np.asarray(out, np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                           color_type, 0, 0, interlace)))
        f.write(chunk(b"IDAT", zlib.compress(data)))
        f.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,ch", [("L", 1), ("LA", 2), ("RGB", 3),
                                     ("RGBA", 4)])
def test_read_png_matches_pil(tmp_path, mode, ch):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(ch)
    arr = _smooth_image(rng, 23, 31, ch)
    arr = arr[..., 0] if ch == 1 else arr
    # PIL's encoder (adaptive filters) and ours with every filter in turn
    Image.fromarray(arr, mode).save(tmp_path / "pil.png")
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    _png(tmp_path / "five.png", arr, color_type, kinds=[0, 1, 2, 3, 4])
    for name in ("pil.png", "five.png"):
        got = io_utils.read_png(str(tmp_path / name))
        np.testing.assert_array_equal(got, np.asarray(Image.open(
            tmp_path / name)), err_msg=name)
        np.testing.assert_array_equal(got, arr, err_msg=name)
    # the port's writer round-trips, alpha included
    io_utils.save_image(str(tmp_path / "own.png"), arr)
    np.testing.assert_array_equal(io_utils.read_png(str(tmp_path / "own.png")),
                                  arr)


def test_read_png_refuses_what_it_lacks(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    deep = np.arange(64, dtype=np.uint16).reshape(8, 8) * 999
    Image.fromarray(deep).save(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="16-bit"):
        io_utils.read_png(str(tmp_path / "deep.png"))
    Image.fromarray(_smooth_image(np.random.default_rng(0), 8, 8, 3)).convert(
        "P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="palette"):
        io_utils.read_png(str(tmp_path / "palette.png"))
    _png(tmp_path / "adam7.png", np.zeros((4, 4, 3), np.uint8), 2,
         interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        io_utils.read_png(str(tmp_path / "adam7.png"))
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="not a PNG"):
        io_utils.read_png(str(tmp_path / "x.jpg"))


# ---- resamplers -----------------------------------------------------------


@pytest.mark.parametrize("shape,mode,ds", [
    ((41, 53, 3), "RGB", 2), ((37, 29, 4), "RGBA", 2),
    ((64, 48, 4), "RGBA", 4), ((33, 35), "L", 3), ((30, 22, 2), "LA", 2),
])
def test_lanczos_matches_pil(shape, mode, ds):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    if mode in ("LA", "RGBA"):   # fully clear, opaque and partial alpha
        u = rng.random(shape[:2])
        arr[..., -1] = np.where(u < 0.3, 0, np.where(u < 0.6, 255,
                                                     arr[..., -1]))
    im = Image.fromarray(arr, mode)
    size = (im.width // ds, im.height // ds)
    want = np.asarray(im.resize(size, Image.LANCZOS)).astype(np.int32)
    got = tds._resize_lanczos(arr, *size).astype(np.int32)
    diff = np.abs(got - want)
    print(f"{mode} {shape} /{ds}: {100 * (diff > 0).mean():.3f}% of the "
          f"pixels differ, by at most {diff.max()}")
    assert diff.max() <= 1


@pytest.mark.parametrize("src,dst", [
    ((16, 8), (12, 6)), ((100, 80), (37, 29)), ((37, 53), (23, 41)),
    ((100, 80), (50, 40)), ((16, 8), (12, 10)), ((20, 20), (30, 30)),
])
def test_area_resize_matches_opencv(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(sum(src)).random(src + (3,)).astype(
        np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = tds._resize_area(img, *dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---- loaders --------------------------------------------------------------


def _write_nerf(root, n=3, hw=(12, 16), ext=True):
    """NeRF-synthetic layout: RGBA PNGs (transparent, opaque and partial
    alpha) and ``transforms_train.json``; ``file_path`` without the
    extension when ``ext`` is False."""
    rng = np.random.default_rng(5)
    frames = []
    for i, c2w in enumerate(sphere_cameras(n, radius=3.0)):
        img = _smooth_image(rng, *hw, 4)
        u = rng.random(hw)
        img[..., 3] = np.where(u < 0.3, 0, np.where(u < 0.6, 255, img[..., 3]))
        rel = f"train/r_{i}"
        io_utils.save_image(os.path.join(root, rel + ".png"), img)
        frames.append({"file_path": "./" + rel + (".png" if ext else ""),
                       "transform_matrix": np.asarray(c2w).tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.69, "frames": frames}, f)


@pytest.mark.parametrize("ds,ext", [(1, True), (1, False), (2, True)])
def test_nerf_synthetic_matches_jax(tmp_path, ds, ext):
    pytest.importorskip("PIL")
    _write_nerf(str(tmp_path), ext=ext)
    want = _jax_datasets().load_nerf_synthetic(str(tmp_path), downsample=ds)
    got = tds.load_nerf_synthetic(str(tmp_path), downsample=ds)
    _assert_same_dataset(got, want, gt_atol=1 / 255, gt_exact=ds == 1)
    assert (got.height, got.width) == (12 // ds, 16 // ds)
    if ds == 1:   # the written pixels, composited over white
        rgba = io_utils.read_png(str(tmp_path / "train/r_0.png"))
        a = rgba.astype(np.float32) / 255.0
        want0 = a[..., :3] * a[..., 3:] + (1.0 - a[..., 3:])
        np.testing.assert_array_equal(got.image(0)[2], want0)
    assert tds.auto_dataset(str(tmp_path), downsample=ds).n_images == 3


def _write_llff(root, n=5, hw=(24, 32), small=True):
    rng = np.random.default_rng(6)
    rows = []
    for c2w in sphere_cameras(n, radius=3.0):
        c2w = np.asarray(c2w)
        # OpenGL [right, up, back] -> LLFF [down, right, back]
        p = np.stack([-c2w[:3, 1], c2w[:3, 0], c2w[:3, 2], c2w[:3, 3],
                      [hw[0], hw[1], 30.0]], axis=1)
        rows.append(np.concatenate([p.ravel(), [1.5 + rng.random(), 6.0]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.asarray(rows))
    for i in range(n):
        img = _smooth_image(rng, *hw, 3)
        io_utils.save_image(os.path.join(root, "images", f"{i:03d}.png"), img)
        if small:
            io_utils.save_image(os.path.join(root, "images_4", f"{i:03d}.png"),
                                img[::4, ::4])


@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_matches_jax(tmp_path, small, split):
    pytest.importorskip("PIL")
    _write_llff(str(tmp_path), small=small)
    want = _jax_datasets().load_llff(str(tmp_path), split=split)
    got = tds.load_llff(str(tmp_path), split=split)
    # images_4 loads as it is; images/ downsamples by 4 (LANCZOS)
    _assert_same_dataset(got, want, gt_atol=1 / 255, gt_exact=small)
    assert (got.height, got.width) == (6, 8)
    assert got.n_images == (4 if split == "train" else 1)
    assert tds.auto_dataset(str(tmp_path), split=split).n_images == \
        got.n_images


def _write_nsvf(root, hw=(10, 14)):
    rng = np.random.default_rng(7)
    os.makedirs(os.path.join(root, "pose"))
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write("17.5 7.0 5.0 0.\n0. 0. 0.\n1.\n")
    for i, c2w in enumerate(sphere_cameras(4, radius=3.0)):
        name = f"{0 if i < 3 else 1}_{i:04d}"
        np.savetxt(os.path.join(root, "pose", name + ".txt"), np.asarray(c2w))
        io_utils.save_image(os.path.join(root, "rgb", name + ".png"),
                            _smooth_image(rng, *hw, 4))


@pytest.mark.parametrize("split,ds", [("train", 1), ("val", 1), ("train", 2)])
def test_nsvf_matches_jax(tmp_path, split, ds):
    pytest.importorskip("PIL")
    _write_nsvf(str(tmp_path))
    want = _jax_datasets().load_nsvf(str(tmp_path), split=split,
                                     downsample=ds)
    got = tds.load_nsvf(str(tmp_path), split=split, downsample=ds)
    _assert_same_dataset(got, want, gt_atol=1 / 255, gt_exact=ds == 1)
    assert got.n_images == (3 if split == "train" else 1)
    assert tds.auto_dataset(str(tmp_path), split=split).n_images == \
        got.n_images


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("sizes,max_dim", [
    (None, 800), ("per_frame", 800), (None, 7)])
def test_co3d_matches_jax(tmp_path, keep, sizes, max_dim):
    """The CO3D directories of ``tests/test_examples_utils.py`` (JPEG
    frames, opened by PIL on both sides): one size, per-frame sizes and
    focal lengths, and frames bounded to 7 pixels (a non-integer area
    resize)."""
    pytest.importorskip("PIL")
    pytest.importorskip("cv2")
    pytest.importorskip("imageio")
    from .test_examples_utils import _write_fake_co3d

    root = str(tmp_path)
    if sizes:
        _write_fake_co3d(root, n_frames=6, hw_list=[(12, 10), (16, 8)],
                         focal_list=[(2.0, 2.0), (3.0, 2.5)])
    else:
        _write_fake_co3d(root)
    kw = dict(split="train", hold_every=3, keep_frame_sizes=keep,
              max_image_dim=max_dim)
    want = _jax_datasets().load_co3d(root, **kw)
    got = tds.load_co3d(root, **kw)
    resized = max_dim < 16 or (sizes and not keep)
    _assert_same_dataset(got, want, gt_atol=1e-5, gt_exact=not resized)
    assert (got.frame_hw is not None) == bool(sizes and keep)
    for i in range(got.n_images):
        np.testing.assert_allclose(got.image(i)[2], want.image(i)[2],
                                   atol=1e-5 if resized else 0.0, rtol=0)
    ds = tds.auto_dataset(root, split="test", hold_every=3,
                          keep_frame_sizes=keep)
    assert ds.n_images == 2


def test_similarity_from_cameras_matches_jax():
    rng = np.random.default_rng(8)
    c2w = np.tile(np.eye(4), (6, 1, 1))
    for m in c2w:
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        m[:3, :3] = q
        m[:3, 3] = rng.standard_normal(3) * 2
    want_t, want_s = _jax_datasets().similarity_from_cameras(c2w)
    got_t, got_s = tds.similarity_from_cameras(c2w)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-12)
    assert got_s == pytest.approx(want_s, rel=1e-12)


def test_auto_dataset_detection_and_kwargs(tmp_path):
    """Detection by marker file, the synthetic scene without a root, and
    the JAX version's keyword rule: a keyword that no loader takes raises
    TypeError, one that only another loader takes is dropped."""
    jds = _jax_datasets()
    nerf = tmp_path / "nerf"
    nerf.mkdir()
    _write_nerf(str(nerf))
    for fn in (jds.auto_dataset, tds.auto_dataset):
        # keep_frame_sizes is CO3D's, hold_every too: dropped for NeRF
        ds = fn(str(nerf), keep_frame_sizes=False, hold_every=2)
        assert ds.n_images == 3
        with pytest.raises(TypeError, match="unknown to every loader"):
            fn(str(nerf), not_an_option=1)
        with pytest.raises(ValueError, match="cannot detect"):
            fn(str(tmp_path))
        syn = fn(None, n_views=2, image_size=8, keep_frame_sizes=False)
        assert (syn.n_images, syn.height) == (2, 8)
    with pytest.raises(ValueError, match="unknown dataset type"):
        tds.auto_dataset(str(nerf), "blender")
    _assert_same_dataset(tds.auto_dataset(str(nerf), "nerf"),
                         jds.auto_dataset(str(nerf), "nerf"))


def test_jpeg_needs_pil(tmp_path, monkeypatch):
    """A JPEG is opened with PIL; without PIL the loader says so and names
    the file, and a PNG still loads."""
    Image = pytest.importorskip("PIL.Image")
    arr = _smooth_image(np.random.default_rng(9), 8, 8, 3)
    Image.fromarray(arr).save(tmp_path / "a.jpg")
    io_utils.save_image(str(tmp_path / "b.png"), arr)
    np.testing.assert_array_equal(
        tds._load_image(str(tmp_path / "a.jpg")),
        np.asarray(Image.open(tmp_path / "a.jpg"), np.float32) / 255.0)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"PIL.*a\.jpg|a\.jpg.*PIL"):
        tds._load_image(str(tmp_path / "a.jpg"))
    np.testing.assert_array_equal(tds._load_image(str(tmp_path / "b.png")),
                                  arr.astype(np.float32) / 255.0)
