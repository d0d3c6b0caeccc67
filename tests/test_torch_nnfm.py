"""The PyTorch port's style and perceptual losses (``utils/nnfm_loss.py``,
``utils/metrics.py::perceptual_loss`` / ``calc_lpips``) against the JAX
package's, on the same numpy-seeded inputs and the same extractor weights:
the random extractor with JAX's ``PRNGKey(17)`` kernels carried across
through ``kernels=``, and random VGG16 weights as a list, an ``.npz`` and a
torchvision-style ``state_dict`` file.  Mirrors
``tests/test_examples_utils.py``'s NNFM tests and
``tests/test_utils_extra.py``'s VGG16 / LPIPS test.

Tolerances (f32 on the CPU on both sides, convolutions and sums in another
order): values within rtol 1e-4 / atol 1e-5 (1e-6 for the losses of
unit-normalised maps); feature maps within rtol 1e-4 / atol 1e-5 x
max(1, max |map|) (VGG's block-4 maps reach ~75 after 13 f32 layers);
gradients within ``compare_one``'s bounds and max |diff| <= 1e-4 x
max |grad|; ``nn_feat_replace``'s indices exactly.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package imports it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lightplane_tpu.utils import metrics as jmetrics  # noqa: E402
from lightplane_tpu.utils import nnfm_loss as jnn  # noqa: E402
from lightplane_tpu_torch.utils import metrics  # noqa: E402
from lightplane_tpu_torch.utils import nnfm_loss as tnn  # noqa: E402

from .utils import compare_one  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, rtol=1e-4, atol=1e-5, name=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=name)


def _maps_close(got, want, name=""):
    want = np.asarray(want)
    _close(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())),
           name=name)


def _grad_close(got, want, name=""):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    compare_one(want, got, name)
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-4 * scale, name


def _jax_kernels(widths):
    """The kernels of the JAX package's ``random_conv_features_fn`` with its
    default key, drawn as it draws them."""
    key, kernels, c_in = jax.random.PRNGKey(17), [], 3
    for w in widths:
        key, k = jax.random.split(key)
        kernels.append(np.asarray(
            jax.random.normal(k, (w, c_in, 3, 3)) * np.sqrt(2.0 / (9 * c_in))))
        c_in = w
    return kernels


def _vgg_pairs(rng):
    pairs, c_in = [], 3
    for widths in jnn._VGG16_CFG:
        for w in widths:
            pairs.append((rng.normal(size=(w, c_in, 3, 3)).astype(np.float32)
                          * 0.05, rng.normal(size=(w,)).astype(np.float32)
                          * 0.01))
            c_in = w
    return pairs


def test_moments_psd_power_and_colour_transfer():
    rng = np.random.default_rng(0)
    px = rng.random((50, 3)).astype(np.float32)
    for got, want in zip(tnn._moments(_t(px)), jnn._moments(jnp.asarray(px))):
        _close(got, want, atol=1e-6)
    cov = np.asarray(jnn._moments(jnp.asarray(px))[1])
    for e in (0.5, -0.5):
        _close(tnn._psd_power(_t(cov), e), jnn._psd_power(jnp.asarray(cov), e),
               rtol=1e-3, atol=1e-4, name=f"power {e}")
    imgs = (rng.random((2, 8, 8, 3)) * 0.5).astype(np.float32)
    style = rng.random((8, 8, 3)).astype(np.float32)
    got, tf = tnn.match_colors_for_image_set(_t(imgs), _t(style))
    want, want_tf = jnn.match_colors_for_image_set(jnp.asarray(imgs),
                                                   jnp.asarray(style))
    assert got.shape == imgs.shape and tf.shape == (4, 4)
    _close(got, want, rtol=1e-3, atol=1e-4, name="recoloured")
    _close(tf, want_tf, rtol=1e-3, atol=1e-4, name="transform")
    # the recoloured set moves toward the style's mean
    assert abs(float(got.mean()) - style.mean()) < abs(
        imgs.mean() - style.mean()) + 0.05


def test_feature_matching_functions():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((8, 20)).astype(np.float32)
    b = rng.standard_normal((8, 30)).astype(np.float32)
    _close(tnn._normalize_chn(_t(a)), jnn._normalize_chn(jnp.asarray(a)))
    got = tnn.nn_feat_replace(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnn.nn_feat_replace(jnp.asarray(a), jnp.asarray(b))))
    # each column is its own nearest neighbour
    np.testing.assert_allclose(tnn.nn_feat_replace(_t(a), _t(a)).numpy(), a)
    assert float(tnn.cos_loss(_t(a), _t(a))) < 1e-6
    for center in (False, True):
        _close(tnn.gram_matrix(_t(a), center),
               jnn.gram_matrix(jnp.asarray(a), center), name="gram")
    ones = torch.ones((4, 10))
    torch.testing.assert_close(tnn.gram_matrix(ones), 10.0 * torch.ones(4, 4))
    torch.testing.assert_close(tnn.gram_matrix(ones, center=True),
                               torch.zeros(4, 4))
    # values and gradients of cos_loss and a Gram term
    ta = _t(a).requires_grad_(True)
    val = tnn.cos_loss(ta, _t(b[:, :20])) + tnn.gram_matrix(ta).square().mean()
    val.backward()

    def jval(x):
        return (jnn.cos_loss(x, jnp.asarray(b[:, :20]))
                + jnp.mean(jnn.gram_matrix(x) ** 2))

    want, g = jax.jit(jax.value_and_grad(jval))(jnp.asarray(a))
    _close(val, want, atol=1e-4)
    _grad_close(ta.grad, g, "cos + gram")


def _nnfm_both(tfn, jfn, img, style, blocks, names):
    x = _t(img).requires_grad_(True)
    got = tnn.NNFMLoss(features_fn=tfn, device="cpu")(
        x, _t(style), blocks=blocks, loss_names=names, contents=_t(style))
    total = sum(got.values())
    total.backward()

    def jtotal(x):
        d = jnn.NNFMLoss(features_fn=jfn)(x, jnp.asarray(style), blocks=blocks,
                                          loss_names=names,
                                          contents=jnp.asarray(style))
        return sum(d.values()), d

    (_, want), g = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(img))
    return got, want, x.grad, g


def test_nnfm_losses_match_jax():
    """The three losses through ``NNFMLoss`` with the random extractor:
    values and the gradient w.r.t. the rendered image; the style image
    against itself scores ~0."""
    rng = np.random.default_rng(2)
    widths = (8, 16)
    kernels = _jax_kernels(widths)
    tfn = tnn.random_conv_features_fn(kernels=kernels, device="cpu")
    jfn = jnn.random_conv_features_fn(widths=widths)
    img = rng.random((3, 16, 16)).astype(np.float32)
    style = rng.random((3, 16, 16)).astype(np.float32)
    names = ("nnfm_loss", "gram_loss", "content_loss")
    got, want, g, jg = _nnfm_both(tfn, jfn, img, style, [0, 1], names)
    for nm in names:
        _close(got[nm], want[nm], name=nm)
    _grad_close(g, jg, "image")
    d_self = tnn.NNFMLoss(tfn)(_t(style), _t(style), blocks=[0],
                               loss_names=["nnfm_loss", "content_loss"],
                               contents=_t(style))
    assert float(d_self["nnfm_loss"]) < 1e-4
    assert float(d_self["content_loss"]) < 1e-10
    # the targets and the style carry no gradient
    s = _t(style).requires_grad_(True)
    tnn.nnfm_losses(tfn(_t(img).requires_grad_(True), [0]), tfn(s, [0]))[
        "nnfm_loss"].backward()
    assert s.grad is None


def test_random_features_and_perceptual_loss_match_jax():
    """The default widths with JAX's kernels: each block's maps, and
    ``perceptual_loss`` with its gradient; the port's own default draw is
    fixed (seed 17) and is not JAX's."""
    rng = np.random.default_rng(3)
    kernels = _jax_kernels((64, 128, 256))
    tfn = tnn.random_conv_features_fn(kernels=kernels, device="cpu")
    jfn = jnn.random_conv_features_fn()
    a = rng.random((24, 20, 3)).astype(np.float32)
    b = rng.random((24, 20, 3)).astype(np.float32)
    jmaps = jax.jit(lambda x: jfn(x.transpose(2, 0, 1), (0, 1, 2)))
    for got, want in zip(tfn(_t(a).permute(2, 0, 1), (0, 1, 2)),
                         jmaps(jnp.asarray(a))):
        assert got.shape == want.shape
        _maps_close(got, want, name="features")
    x = _t(a).requires_grad_(True)
    val = metrics.perceptual_loss(x, _t(b), tfn, blocks=(0, 1, 2))
    val.backward()
    want, g = jax.jit(jax.value_and_grad(lambda p: jmetrics.perceptual_loss(
        p, jnp.asarray(b), jfn, blocks=(0, 1, 2))))(jnp.asarray(a))
    _close(val, want, atol=1e-6)
    _grad_close(x.grad, g, "perceptual")
    assert float(metrics.perceptual_loss(_t(a), _t(a), tfn)) < 1e-6
    with pytest.raises(ValueError, match="at least one block"):
        metrics.perceptual_loss(_t(a), _t(b), tfn, blocks=())
    own = tnn.random_conv_features_fn(device="cpu")
    again = tnn.random_conv_features_fn(
        generator=torch.Generator().manual_seed(17), device="cpu")
    for i, k in enumerate(kernels):
        w = getattr(own, f"kernel{i}")
        torch.testing.assert_close(w, getattr(again, f"kernel{i}"))
        assert w.shape == k.shape and not np.allclose(w.numpy(), k)
        assert abs(float(w.std()) - math.sqrt(2.0 / (9 * k.shape[1]))) < 0.1 \
            * math.sqrt(2.0 / (9 * k.shape[1]))
    assert all(not b.requires_grad for b in own.buffers())


def test_vgg16_features_and_lpips_match_jax(tmp_path, monkeypatch):
    """Random VGG16 weights as a list, an ``.npz`` and a ``state_dict``
    file give JAX's maps (shapes of ``tests/test_utils_extra.py``);
    ``perceptual_loss`` and its gradient over them; ``calc_lpips`` through
    ``LIGHTPLANE_VGG_WEIGHTS`` on both sides."""
    rng = np.random.default_rng(4)
    pairs = _vgg_pairs(rng)
    npz = tmp_path / "vgg.npz"
    np.savez(npz, **{f"conv{i}_{k}": v for i, (w, b) in enumerate(pairs)
                     for k, v in (("w", w), ("b", b))})
    sd_path = tmp_path / "vgg.pt"
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    torch.save({**{f"features.{i}.weight": _t(w) for i, (w, _) in
                   zip(conv_idx, pairs)},
                **{f"features.{i}.bias": _t(b) for i, (_, b) in
                   zip(conv_idx, pairs)},
                "classifier.0.weight": torch.zeros(4, 4)}, sd_path)
    jfn = jnn.vgg16_jax_features_fn(pairs)
    img = rng.random((32, 32, 3)).astype(np.float32)
    tgt = rng.random((32, 32, 3)).astype(np.float32)
    want = jfn(jnp.asarray(img).transpose(2, 0, 1), (0, 2, 4))
    assert [f.shape for f in want] == [(64, 32, 32), (256, 8, 8), (512, 2, 2)]
    for src in (pairs, str(npz), str(sd_path)):
        tfn = tnn.vgg16_jax_features_fn(src, device="cpu")
        got = tfn(_t(img).permute(2, 0, 1), (0, 2, 4))
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _maps_close(g, w, name=str(src)[-6:])
    x = _t(img).requires_grad_(True)
    val = metrics.perceptual_loss(x, _t(tgt), tfn, blocks=(0, 1, 2))
    val.backward()
    jval, jg = jax.jit(jax.value_and_grad(lambda p: jmetrics.perceptual_loss(
        p, jnp.asarray(tgt), jfn, blocks=(0, 1, 2))))(jnp.asarray(img))
    _close(val, jval, atol=1e-6)
    _grad_close(x.grad, jg, "vgg perceptual")
    assert abs(float(metrics.perceptual_loss(_t(tgt), _t(tgt), tfn))) < 1e-6

    monkeypatch.setenv("LIGHTPLANE_VGG_WEIGHTS", str(npz))
    want_d = jmetrics.calc_lpips(img, tgt)
    for p, t in ((_t(img), _t(tgt)), (img, tgt)):
        d = metrics.calc_lpips(p, t, device="cpu")
        assert np.isfinite(d) and d > 0
        assert d == pytest.approx(want_d, rel=1e-4)
    monkeypatch.setenv("LIGHTPLANE_VGG_WEIGHTS", str(tmp_path / "missing"))
    with pytest.raises(ImportError, match="LIGHTPLANE_VGG_WEIGHTS"):
        metrics.calc_lpips(_t(img), _t(tgt))


def test_default_extractor_is_built_once_per_device(monkeypatch, tmp_path):
    monkeypatch.delenv("LIGHTPLANE_VGG_WEIGHTS", raising=False)
    metrics._default_features_fn.cache_clear()
    try:
        fn = metrics._default_features_fn("cpu")
        assert isinstance(fn, tnn.RandomConvFeatures)
        assert metrics._default_features_fn("cpu") is fn
        a = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(0))
        v = metrics.perceptual_loss(a, a.flip(0))
        assert float(v) == float(metrics.perceptual_loss(a, a.flip(0), fn))
    finally:
        metrics._default_features_fn.cache_clear()


def test_vgg16_features_fn_needs_torchvision():
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="torchvision"):
            tnn.vgg16_features_fn(device="cpu")
        with pytest.raises(ImportError, match="torchvision"):
            jnn.vgg16_features_fn()
    else:
        pytest.skip("torchvision is installed; its pretrained weights would "
                    "be downloaded")
