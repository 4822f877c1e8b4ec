"""Multi-scale model zoo: the LR families ship x3/x4 heads too.

The reference supports arbitrary factors by interpolate-first (and its
step-scale mode chains x2 passes, `libsrcnn.cpp:980-1061`); the LR
families (FSRCNN/ESPCN) instead carry one trained upscale head per
integer factor.  These tests pin the per-scale checkpoint contract
(tools/train_fsrcnn.py --scale) and the eval runner's model switch.
"""

import os

import numpy as np
import pytest


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def _butterfly_full():
    """The reference's 256x256 butterfly picture, as committed in the
    goldens archive."""
    return np.load(GOLDENS)["in_butterfly_full"]


def _load(family: str, scale: int):
    import importlib

    mod = importlib.import_module(f"libsrcnn_tpu.models.{family}")
    try:
        return mod, *mod.load_params(scale=scale)
    except FileNotFoundError:
        pytest.skip(f"shipped {family}_x{scale}.npz missing -- run "
                    f"tools/train_{family}.py --scale={scale}")


@pytest.mark.parametrize("family", ["fsrcnn", "espcn"])
@pytest.mark.parametrize("scale", [3, 4])
def test_shipped_scale_loads_and_upscales(family, scale):
    from libsrcnn_tpu import SRCNNConfig, upscale

    mod, params, spec = _load(family, scale)
    assert spec.scale == scale
    img = np.random.default_rng(3).integers(0, 256, (12, 16, 3), np.uint8)
    out = upscale(img, float(scale), SRCNNConfig(model=family))
    assert out.shape == (12 * scale, 16 * scale, 3)
    assert out.dtype == np.uint8
    # wrong factor for the shipped head is a clear error, not garbage
    # (fractional: no integer head can serve it)
    with pytest.raises(ValueError, match=family):
        upscale(img, float(scale) + 0.5, SRCNNConfig(model=family))


@pytest.mark.parametrize("family", ["fsrcnn", "espcn"])
def test_x3_beats_bicubic_on_heldout(family):
    """Quality gate at x3 on held-out butterfly, via the eval runner's
    standard protocol (downscale 1/3, super-resolve back)."""
    from libsrcnn_tpu.eval.runner import evaluate_image

    _load(family, 3)
    img = _butterfly_full()
    r = evaluate_image(img, 3.0, name="butterfly", model=family)
    assert r.psnr_srcnn > r.psnr_interp, (
        f"{family} x3 {r.psnr_srcnn:.2f} dB <= bicubic {r.psnr_interp:.2f}")


def test_eval_runner_model_crop():
    """With an LR-family model the runner crops ground truth to a scale
    multiple, so odd sizes evaluate cleanly (and metrics are finite)."""
    from libsrcnn_tpu.eval.runner import evaluate_image

    _load("fsrcnn", 2)
    img = np.random.default_rng(4).integers(0, 256, (33, 41, 3), np.uint8)
    r = evaluate_image(img, 2.0, name="odd", model="fsrcnn")
    assert np.isfinite(r.psnr_srcnn) and np.isfinite(r.psnr_interp)
    assert 0.0 <= r.ssim_srcnn <= 1.0


@pytest.mark.parametrize("family", ["fsrcnn", "espcn", "vdsr"])
def test_bfloat16_compute_tier(family):
    """compute_dtype="bfloat16" routes the family convs through
    Precision.DEFAULT (TF32 convs on the H100).  On the CPU backend
    DEFAULT is still exact f32, so the output must match the f32 tier
    bit-for-bit -- this pins the plumbing; on-chip throughput/quality
    numbers are in PERF.md/EVAL.md."""
    from libsrcnn_tpu import SRCNNConfig, upscale

    if family != "vdsr":
        _load(family, 2)
    img = np.random.default_rng(11).integers(0, 256, (20, 16, 3), np.uint8)
    a = upscale(img, 2.0, SRCNNConfig(model=family))
    b = upscale(img, 2.0, SRCNNConfig(model=family,
                                      compute_dtype="bfloat16"))
    np.testing.assert_array_equal(a, b)


def test_int8_rejected_for_families():
    """The int8 draft tier is srcnn-only; families must reject it with a
    clear error instead of silently running f32."""
    from libsrcnn_tpu import SRCNNConfig, upscale

    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="int8"):
        upscale(img, 2.0, SRCNNConfig(model="vdsr", compute_dtype="int8"))


def test_step_scale_family_contract():
    """Step-scale (`libsrcnn.cpp:980-1061` semantics) with the zoo: the
    LR families chain their x2 heads for power-of-two factors; a
    fractional remainder pass must raise the exact-scale error (never
    silently switch models); the scale-agnostic vdsr serves any chain."""
    from libsrcnn_tpu import SRCNNConfig, upscale

    _load("fsrcnn", 2)
    img = np.random.default_rng(12).integers(0, 256, (20, 16, 3), np.uint8)
    out = upscale(img, 4.0, SRCNNConfig(model="fsrcnn", step_scale=True))
    assert out.shape == (80, 64, 3)
    with pytest.raises(ValueError, match="scale 2 exactly"):
        upscale(img, 5.0, SRCNNConfig(model="fsrcnn", step_scale=True))
    out = upscale(img, 5.0, SRCNNConfig(model="vdsr", step_scale=True))
    assert out.shape == (100, 80, 3)
