"""FSRCNN model family: forward geometry, training, batching."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libsrcnn_tpu.models import fsrcnn
from libsrcnn_tpu.train import Trainer


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def _butterfly_full():
    """The reference's 256x256 butterfly picture, as committed in the
    goldens archive."""
    return np.load(GOLDENS)["in_butterfly_full"]


@pytest.fixture(scope="module")
def spec():
    return fsrcnn.FSRCNNSpec(scale=2, d=16, s=8, m=2)


@pytest.fixture(scope="module")
def params(spec):
    return fsrcnn.init_params(jax.random.key(0), spec)


def test_forward_geometry(params, spec):
    lr = np.random.default_rng(70).uniform(0, 255, (12, 14)).astype(np.float32)
    out = np.asarray(fsrcnn.forward_lr(params, jnp.asarray(lr), spec))
    assert out.shape == (24, 28)
    assert out.min() >= 0 and out.max() <= 255

    x3 = fsrcnn.FSRCNNSpec(scale=3, d=16, s=8, m=2)
    p3 = fsrcnn.init_params(jax.random.key(1), x3)
    out3 = np.asarray(fsrcnn.forward_lr(p3, jnp.asarray(lr), x3))
    assert out3.shape == (36, 42)


def test_forward_batched(params, spec):
    lrs = np.random.default_rng(71).uniform(0, 255, (3, 8, 8)).astype(np.float32)
    out = np.asarray(fsrcnn.forward_lr(params, jnp.asarray(lrs), spec))
    assert out.shape == (3, 16, 16)
    one = np.asarray(fsrcnn.forward_lr(params, jnp.asarray(lrs[2]), spec))
    np.testing.assert_allclose(out[2], one, atol=1e-5)


def test_training_reduces_loss(spec):
    imgs = []
    for _ in range(2):
        g = np.linspace(0, 255, 64)[:, None] + np.linspace(0, 128, 64)[None, :]
        imgs.append(np.clip(g / 2, 0, 255).astype(np.uint8)[..., None].repeat(3, -1))
    params = fsrcnn.init_params(jax.random.key(2), spec)
    tr = Trainer(params=params, learning_rate=2e-3,
                 forward=fsrcnn.make_loss_forward(spec))
    batches = [fsrcnn.make_lr_patch_batch(imgs, 8, patch=12, spec=spec, seed=s)
               for s in range(25)]
    losses = tr.fit(batches)
    assert losses[-1] < losses[0] * 0.5


def test_patch_batch_shapes(spec):
    imgs = [np.zeros((40, 40, 3), np.uint8)]
    lr, hr = fsrcnn.make_lr_patch_batch(imgs, 4, patch=10, spec=spec)
    assert lr.shape == (4, 10, 10) and hr.shape == (4, 20, 20)
    with pytest.raises(ValueError):
        fsrcnn.make_lr_patch_batch(imgs, 2, patch=32, spec=spec)


# --- shipped weights + public-API integration -----------------------------

def _shipped():
    try:
        return fsrcnn.load_params(scale=2)
    except FileNotFoundError:
        pytest.skip("shipped fsrcnn_x2.npz missing -- run tools/train_fsrcnn.py")


def test_shipped_weights_load():
    params, spec = _shipped()
    assert spec.scale == 2
    assert params["feat_w"].shape == (5, 5, 1, spec.d)
    assert params["deconv_w"].shape == (9, 9, spec.d, 1)


def test_shipped_fsrcnn_beats_bicubic_on_heldout():
    """Golden-style quality gate: on the held-out butterfly image, the
    shipped FSRCNN beats classical bicubic upscaling (the reference's
    default interpolation) in Y-channel PSNR."""
    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.eval.metrics import psnr
    from libsrcnn_tpu.ops import color, resize

    params, spec = _shipped()
    img = _butterfly_full()
    hr_y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
    h, w = hr_y.shape
    lr_y = resize.resize_plane(jnp.asarray(hr_y), h // 2, w // 2,
                               FilterType.BICUBIC)
    sr = np.asarray(fsrcnn.forward_lr(params, lr_y, spec))
    bic = np.clip(np.asarray(resize.resize_plane(lr_y, h, w,
                                                 FilterType.BICUBIC)), 0, 255)
    p_sr, p_bic = psnr(sr, hr_y), psnr(bic, hr_y)
    assert p_sr > p_bic, f"FSRCNN {p_sr:.2f} dB <= bicubic {p_bic:.2f} dB"


def test_fsrcnn_via_public_api():
    from libsrcnn_tpu import SRCNNConfig, upscale

    _shipped()
    img = np.random.default_rng(9).integers(0, 256, (20, 24, 3), np.uint8)
    out, conv = upscale(img, 2.0, SRCNNConfig(model="fsrcnn"),
                        return_conv_map=True)
    assert out.shape == (40, 48, 3) and out.dtype == np.uint8
    assert conv.shape == (40, 48)
    # non-integer factors are rejected with a clear error
    with pytest.raises(ValueError, match="fsrcnn"):
        upscale(img, 2.5, SRCNNConfig(model="fsrcnn"))


def test_fsrcnn_via_cli(tmp_path):
    from libsrcnn_tpu import cli
    from libsrcnn_tpu.io import save_png

    _shipped()
    img = np.random.default_rng(10).integers(0, 256, (16, 16, 3), np.uint8)
    src = str(tmp_path / "in.png")
    save_png(src, img)
    rc = cli.main([src, "--scale=2", "--model=fsrcnn"])
    assert rc == 0
    from PIL import Image

    out = np.asarray(Image.open(str(tmp_path / "in_resized.png")))
    assert out.shape == (32, 32, 3)


@pytest.mark.parametrize("k,r", [(9, 2), (9, 3), (9, 4), (5, 2), (7, 3),
                                 (4, 5)])
def test_subpixel_deconv_equals_conv_transpose(k, r):
    """The dense sub-pixel formulation must compute exactly
    lax.conv_transpose's SAME-padded per-pixel sums for every (kernel,
    stride) shape -- including the k < stride fallback path."""
    import jax.numpy as jnp
    from jax import lax

    from libsrcnn_tpu.models import fsrcnn

    rng = np.random.default_rng(k * 10 + r)
    h = jnp.asarray(rng.normal(size=(2, 7, 6, 5)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(k, k, 5, 1)).astype(np.float32))
    ref = lax.conv_transpose(h, w, (r, r), "SAME",
                             dimension_numbers=("NHWC", "HWIO", "NHWC"),
                             precision=lax.Precision.HIGHEST)
    got = fsrcnn._deconv_subpixel(h, w, r, lax.Precision.HIGHEST)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=0, atol=1e-4)


def test_lane_pack_matches_direct(params, spec):
    """lane_pack=True is the same stack through packed-GEMM convs +
    packed sub-pixel deconv: equal up to f32 summation order."""
    lr = np.random.default_rng(77).uniform(0, 255, (21, 19)).astype(np.float32)
    base = np.asarray(fsrcnn.forward_lr(params, jnp.asarray(lr), spec,
                                        clamp=False))
    packed = np.asarray(fsrcnn.forward_lr(params, jnp.asarray(lr), spec,
                                          clamp=False, lane_pack=True))
    np.testing.assert_allclose(packed, base, rtol=2e-6, atol=2e-3)

    x3 = fsrcnn.FSRCNNSpec(scale=3, d=16, s=8, m=2)
    p3 = fsrcnn.init_params(jax.random.key(1), x3)
    base3 = np.asarray(fsrcnn.forward_lr(p3, jnp.asarray(lr), x3, clamp=False))
    packed3 = np.asarray(fsrcnn.forward_lr(p3, jnp.asarray(lr), x3,
                                           clamp=False, lane_pack=True))
    np.testing.assert_allclose(packed3, base3, rtol=2e-6, atol=2e-3)
