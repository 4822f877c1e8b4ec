"""int8 draft tier: quantized pack integrity, quality vs the exact f32
path, and API/CLI wiring.

The int8 tier has no reference analog (the reference is f32-only,
`libsrcnn.cpp:350-529`); it runs the XLA int8 stack
(models/srcnn_int8.forward_y) on every path, and its contract is that
measured quality vs the exact path stays high (PSNR threshold below; the
shipped pack measures ~40 dB).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from libsrcnn_tpu import SRCNNConfig, upscale
from libsrcnn_tpu.models import srcnn, srcnn_int8

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


@pytest.fixture(scope="module")
def qparams():
    return srcnn_int8.load_params()


@pytest.fixture(scope="module")
def butterfly():
    return np.load(GOLDENS)["in_butterfly64"]


def _psnr(a, b, peak=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def test_pack_layout(qparams):
    """Key inventory and layouts match tools/calibrate_int8.py's contract."""
    assert qparams["w1q"].dtype == jnp.int8 and qparams["w1q"].shape == (81, 64)
    assert qparams["w2q"].dtype == jnp.int8 and qparams["w2q"].shape == (64, 32)
    assert qparams["w3q"].dtype == jnp.int8 and qparams["w3q"].shape == (25, 32)
    for k in ("s1", "t1"):
        assert qparams[k].shape == (64,)
    for k in ("s2", "t2"):
        assert qparams[k].shape == (32,)
    assert qparams["d3"].shape == (1,) and qparams["b3"].shape == (1,)
    # calibration intermediates are stripped from the runtime pack
    assert "a1" not in qparams and "a2" not in qparams


def test_xla_int8_quality_vs_exact(qparams, butterfly):
    """Quantization error bound on a real image: the int8 stack's Y output
    stays >= 38 dB PSNR vs the exact f32 stack (shipped pack measures ~40)."""
    from libsrcnn_tpu.ops import color, resize
    from libsrcnn_tpu.config import FilterType

    planes = color.rgb_to_ycbcr(jnp.asarray(butterfly))
    y_r = resize.resize_plane(planes[0], 128, 128, FilterType.BICUBIC)
    exact = np.asarray(srcnn.forward_y(srcnn.load_params(), y_r))
    q = np.asarray(srcnn_int8.forward_y(qparams, y_r))
    assert _psnr(q, exact) >= 38.0


def test_pipeline_int8_both_paths(butterfly):
    """End-to-end upscale with compute_dtype="int8" runs the XLA int8
    twin whatever use_pallas says (the fused kernel has no int8 tier), and
    stays close to the exact output."""
    exact = upscale(butterfly, 2.0)
    a = upscale(butterfly, 2.0, SRCNNConfig(compute_dtype="int8",
                                            use_pallas=False))
    b = upscale(butterfly, 2.0, SRCNNConfig(compute_dtype="int8",
                                            use_pallas=True))
    assert a.dtype == np.uint8 and a.shape == exact.shape
    np.testing.assert_array_equal(a, b)
    assert _psnr(a, exact) >= 38.0


def test_step_scale_int8(butterfly):
    """Step-scale chaining works under the int8 tier (u8 round-trip between
    passes is unchanged); quantization error compounds over the two chained
    passes, so the bound is looser than single-pass (measures ~34 dB)."""
    out = upscale(butterfly, 4.0, SRCNNConfig(compute_dtype="int8",
                                              step_scale=True,
                                              use_pallas=False))
    assert out.shape == (256, 256, 3)
    exact = upscale(butterfly, 4.0, SRCNNConfig(step_scale=True))
    assert _psnr(out, exact) >= 33.0


def test_debug_intermediates_int8_config(butterfly):
    """The DEBUG dumper mirrors the reference's f32 path; under an int8
    config it dumps the f32 dequant planes (full 64+32+1 set)."""
    from libsrcnn_tpu import api

    planes = api.debug_intermediates(butterfly[:24, :24], 2.0,
                                     SRCNNConfig(compute_dtype="int8"))
    assert "conv1_63" in planes and "conv2_31" in planes and "conv3" in planes
    assert planes["conv3"].dtype == np.float32


def test_cli_int8_flag(tmp_path, butterfly):
    from PIL import Image

    from libsrcnn_tpu import cli

    src = tmp_path / "in.png"
    Image.fromarray(butterfly[:24, :24]).save(src)
    dst = tmp_path / "out.png"
    cli.main([str(src), str(dst), "--scale=2", "--int8", "--no-pallas"])
    out = np.asarray(Image.open(dst))
    assert out.shape == (48, 48, 3)


def test_serve_batch_int8(butterfly):
    """The batched serving path is int8-aware (load_model_params routing)."""
    from libsrcnn_tpu import serve

    frames = np.stack([butterfly[:32, :32]] * 3)
    out = serve.upscale_frames(frames, 2.0,
                               SRCNNConfig(compute_dtype="int8",
                                           use_pallas=False))
    assert out.shape == (3, 64, 64, 3)
    one = upscale(butterfly[:32, :32], 2.0,
                  SRCNNConfig(compute_dtype="int8", use_pallas=False))
    np.testing.assert_array_equal(out[0], one)
