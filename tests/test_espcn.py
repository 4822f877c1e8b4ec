"""ESPCN model family: pixel shuffle, forward geometry, training, API."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libsrcnn_tpu.models import espcn, fsrcnn
from libsrcnn_tpu.train import Trainer


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def _butterfly_full():
    """The reference's 256x256 butterfly picture, as committed in the
    goldens archive."""
    return np.load(GOLDENS)["in_butterfly_full"]


@pytest.fixture(scope="module")
def spec():
    return espcn.ESPCNSpec(scale=2, f1=16, f2=8)


@pytest.fixture(scope="module")
def params(spec):
    return espcn.init_params(jax.random.key(0), spec)


def test_pixel_shuffle_layout():
    """Channel k of the head = sub-pixel (dy=k//r, dx=k%r): pin the layout
    against a hand-built reference so trained weights can never silently
    permute sub-pixels."""
    r, h, w = 2, 3, 4
    x = np.arange(h * w * r * r, dtype=np.float32).reshape(1, h, w, r * r)
    out = np.asarray(espcn.pixel_shuffle(jnp.asarray(x), r))
    assert out.shape == (1, h * r, w * r)
    for y in range(h * r):
        for z in range(w * r):
            k = (y % r) * r + (z % r)
            assert out[0, y, z] == x[0, y // r, z // r, k]


def test_forward_geometry(params, spec):
    lr = np.random.default_rng(70).uniform(0, 255, (12, 14)).astype(np.float32)
    out = np.asarray(espcn.forward_lr(params, jnp.asarray(lr), spec))
    assert out.shape == (24, 28)
    assert out.min() >= 0 and out.max() <= 255

    x3 = espcn.ESPCNSpec(scale=3, f1=16, f2=8)
    p3 = espcn.init_params(jax.random.key(1), x3)
    out3 = np.asarray(espcn.forward_lr(p3, jnp.asarray(lr), x3))
    assert out3.shape == (36, 42)


def test_forward_batched(params, spec):
    lrs = np.random.default_rng(71).uniform(0, 255, (3, 8, 8)).astype(np.float32)
    out = np.asarray(espcn.forward_lr(params, jnp.asarray(lrs), spec))
    assert out.shape == (3, 16, 16)
    one = np.asarray(espcn.forward_lr(params, jnp.asarray(lrs[2]), spec))
    np.testing.assert_allclose(out[2], one, atol=1e-5)


def test_training_reduces_loss(spec):
    imgs = []
    for _ in range(2):
        g = np.linspace(0, 255, 64)[:, None] + np.linspace(0, 128, 64)[None, :]
        imgs.append(np.clip(g / 2, 0, 255).astype(np.uint8)[..., None].repeat(3, -1))
    params = espcn.init_params(jax.random.key(2), spec)
    tr = Trainer(params=params, learning_rate=2e-3,
                 forward=espcn.make_loss_forward(spec))
    # the patch builder is family-agnostic (reads only spec.scale)
    batches = [fsrcnn.make_lr_patch_batch(imgs, 8, patch=12, spec=spec, seed=s)
               for s in range(25)]
    losses = tr.fit(batches)
    assert losses[-1] < losses[0] * 0.5


# --- shipped weights + public-API integration -----------------------------

def _shipped():
    try:
        return espcn.load_params(scale=2)
    except FileNotFoundError:
        pytest.skip("shipped espcn_x2.npz missing -- run tools/train_espcn.py")


def test_shipped_weights_load():
    params, spec = _shipped()
    assert spec.scale == 2
    assert params["c1_w"].shape == (5, 5, 1, spec.f1)
    assert params["c3_w"].shape == (3, 3, spec.f2, spec.scale ** 2)


def test_shipped_espcn_beats_bicubic_on_heldout():
    """Quality gate: on the held-out butterfly image, the shipped ESPCN
    beats classical bicubic upscaling in Y-channel PSNR."""
    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.eval.metrics import psnr
    from libsrcnn_tpu.ops import color, resize

    params, spec = _shipped()
    img = _butterfly_full()
    hr_y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
    h, w = hr_y.shape
    lr_y = resize.resize_plane(jnp.asarray(hr_y), h // 2, w // 2,
                               FilterType.BICUBIC)
    sr = np.asarray(espcn.forward_lr(params, lr_y, spec))
    bic = np.clip(np.asarray(resize.resize_plane(lr_y, h, w,
                                                 FilterType.BICUBIC)), 0, 255)
    p_sr, p_bic = psnr(sr, hr_y), psnr(bic, hr_y)
    assert p_sr > p_bic, f"ESPCN {p_sr:.2f} dB <= bicubic {p_bic:.2f} dB"


def test_espcn_via_public_api():
    from libsrcnn_tpu import SRCNNConfig, upscale

    _shipped()
    img = np.random.default_rng(9).integers(0, 256, (20, 24, 3), np.uint8)
    out, conv = upscale(img, 2.0, SRCNNConfig(model="espcn"),
                        return_conv_map=True)
    assert out.shape == (40, 48, 3) and out.dtype == np.uint8
    assert conv.shape == (40, 48)
    with pytest.raises(ValueError, match="espcn"):
        upscale(img, 2.5, SRCNNConfig(model="espcn"))


def test_espcn_via_cli(tmp_path):
    from libsrcnn_tpu import cli
    from libsrcnn_tpu.io import save_png

    _shipped()
    img = np.random.default_rng(10).integers(0, 256, (16, 16, 3), np.uint8)
    src = str(tmp_path / "in.png")
    save_png(src, img)
    rc = cli.main([src, "--scale=2", "--model=espcn"])
    assert rc == 0
    from PIL import Image

    out = np.asarray(Image.open(str(tmp_path / "in_resized.png")))
    assert out.shape == (32, 32, 3)


def test_lane_pack_matches_direct(spec, params):
    """lane_pack=True: packed convs (incl. the r^2-lane head) equal the
    direct stack up to f32 summation order."""
    lr = np.random.default_rng(88).uniform(0, 255, (17, 23)).astype(np.float32)
    base = np.asarray(espcn.forward_lr(params, jnp.asarray(lr), spec,
                                       clamp=False))
    packed = np.asarray(espcn.forward_lr(params, jnp.asarray(lr), spec,
                                         clamp=False, lane_pack=True))
    np.testing.assert_allclose(packed, base, rtol=2e-6, atol=2e-3)


def test_lane_pack_matches_direct_x3():
    """x3 head: the 9-channel sub-pixel output packs differently."""
    s3 = espcn.ESPCNSpec(scale=3, f1=16, f2=8)
    p3 = espcn.init_params(jax.random.key(9), s3)
    lr = np.random.default_rng(89).uniform(0, 255, (13, 11)).astype(np.float32)
    base = np.asarray(espcn.forward_lr(p3, jnp.asarray(lr), s3, clamp=False))
    packed = np.asarray(espcn.forward_lr(p3, jnp.asarray(lr), s3,
                                         clamp=False, lane_pack=True))
    np.testing.assert_allclose(packed, base, rtol=2e-6, atol=2e-3)
