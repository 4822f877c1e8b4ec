"""VDSR family: deep residual HR-domain model (beyond-reference breadth).

Unlike the LR families, VDSR runs after classical interpolation (same
position in the pipeline as the reference's SRCNN stack,
`libsrcnn.cpp:628-923`), so one checkpoint serves every factor --
including the fractional scales and step-scale chains the per-scale
heads cannot.  These tests pin the architecture contract (scan-stacked
interior layers, residual identity path, replicate SAME borders) with
random-init params, plus the shipped-weights path when vdsr.npz exists.
"""

import os

import numpy as np
import pytest


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def _butterfly_full():
    """The reference's 256x256 butterfly picture, as committed in the
    goldens archive."""
    return np.load(GOLDENS)["in_butterfly_full"]


def _init(depth=5, ch=8):
    import jax

    from libsrcnn_tpu.models import vdsr

    spec = vdsr.VDSRSpec(depth=depth, ch=ch)
    params = vdsr.init_params(jax.random.PRNGKey(0), spec)
    return vdsr, params, spec


def test_forward_shapes_and_clamp():
    vdsr, params, spec = _init()
    y = np.random.default_rng(0).uniform(0, 255, (20, 17)).astype(np.float32)
    out = np.asarray(vdsr.forward_hr(params, y, spec))
    assert out.shape == (20, 17)
    assert out.min() >= 0.0 and out.max() <= 255.0
    # batched input keeps the leading axis
    yb = np.stack([y, y * 0.5])
    ob = np.asarray(vdsr.forward_hr(params, yb, spec))
    assert ob.shape == (2, 20, 17)
    np.testing.assert_allclose(ob[0], out, rtol=0, atol=1e-4)


def test_zero_residual_head_is_identity():
    """With a zeroed output layer the net must return the input exactly:
    the identity path carries the image (residual learning)."""
    vdsr, params, spec = _init()
    params = dict(params, out_w=params["out_w"] * 0.0,
                  out_b=params["out_b"] * 0.0)
    y = np.random.default_rng(1).uniform(0, 255, (12, 15)).astype(np.float32)
    out = np.asarray(vdsr.forward_hr(params, y, spec, clamp=False))
    np.testing.assert_allclose(out, y, rtol=0, atol=1e-5)


def test_depth_is_scanned_not_unrolled():
    """The interior stack is one scan over [L,...] arrays: the same params
    dict reshaped to a different depth must still run (no per-layer
    Python structure), and depth only changes the leading axis."""
    vdsr, params, spec = _init(depth=7, ch=8)
    assert params["mid_w"].shape[0] == 5
    y = np.random.default_rng(2).uniform(0, 255, (10, 10)).astype(np.float32)
    out = np.asarray(vdsr.forward_hr(params, y, spec))
    assert out.shape == (10, 10)


def test_pipeline_serves_any_factor(monkeypatch, tmp_path):
    """vdsr through the public API at a fractional factor (which no LR
    family can serve) -- using a tiny random checkpoint."""
    import jax

    from libsrcnn_tpu import SRCNNConfig, upscale
    from libsrcnn_tpu.models import vdsr

    spec = vdsr.VDSRSpec(depth=3, ch=4)
    params = vdsr.init_params(jax.random.PRNGKey(3), spec)
    path = tmp_path / "vdsr.npz"
    np.savez(path, meta_depth=spec.depth, meta_ch=spec.ch,
             **{k: np.asarray(v) for k, v in params.items()})
    monkeypatch.setattr(vdsr, "load_params",
                        lambda scale=None, **kw: vdsr._load_cached(str(path)))
    img = np.random.default_rng(4).integers(0, 256, (16, 20, 3), np.uint8)
    out = upscale(img, 2.5, SRCNNConfig(model="vdsr"))
    assert out.shape == (40, 50, 3)
    assert out.dtype == np.uint8


def test_gspmd_paths_match_single(monkeypatch, tmp_path):
    """vdsr through the data-parallel batch and GSPMD spatial paths on the
    virtual mesh, bit-identical to the single-device pipeline."""
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig, pipeline, upscale
    from libsrcnn_tpu.models import vdsr
    from libsrcnn_tpu.parallel import sharding
    from libsrcnn_tpu.parallel.mesh import make_mesh

    spec = vdsr.VDSRSpec(depth=4, ch=8)
    params = vdsr.init_params(jax.random.PRNGKey(5), spec)
    path = tmp_path / "vdsr.npz"
    np.savez(path, meta_depth=spec.depth, meta_ch=spec.ch,
             **{k: np.asarray(v) for k, v in params.items()})
    monkeypatch.setattr(vdsr, "load_params",
                        lambda scale=None, **kw: vdsr._load_cached(str(path)))

    cfg = SRCNNConfig(model="vdsr")
    vparams = pipeline.load_model_params(cfg, 2.0)

    imgs = np.random.default_rng(6).integers(0, 256, (4, 16, 16, 3), np.uint8)
    mesh = make_mesh({"data": 4, "row": 2, "col": 1})
    out, conv = sharding.upscale_batch(jnp.asarray(imgs), vparams, 2.0,
                                       cfg, mesh)
    ref = upscale(imgs[1], 2.0, cfg)
    np.testing.assert_array_equal(np.asarray(out)[1], ref)

    mesh = make_mesh({"data": 1, "row": 4, "col": 2})
    img = np.random.default_rng(7).integers(0, 256, (32, 32, 3), np.uint8)
    out, conv = sharding.upscale_spatial(jnp.asarray(img), vparams, 2.0,
                                         cfg, mesh)
    np.testing.assert_array_equal(np.asarray(out), upscale(img, 2.0, cfg))


def test_shipped_weights_beat_bicubic_heldout():
    """Quality gate on held-out butterfly once vdsr.npz ships."""
    import os

    from libsrcnn_tpu.models import vdsr

    if not os.path.exists(os.path.join(vdsr.WEIGHTS_DIR, "vdsr.npz")):
        pytest.skip("no shipped vdsr.npz yet -- run tools/train_vdsr.py")
    from libsrcnn_tpu.eval.runner import evaluate_image

    img = _butterfly_full()
    r = evaluate_image(img, 2.0, name="butterfly", model="vdsr")
    assert r.psnr_srcnn > r.psnr_interp, (
        f"vdsr x2 {r.psnr_srcnn:.2f} dB <= bicubic {r.psnr_interp:.2f}")


def test_lane_pack_matches_direct():
    """lane_pack=4 is the same stack in a packed-GEMM formulation: equal
    to the direct path up to f32 summation order (ops/packed_conv.py)."""
    vdsr, params, spec = _init(depth=6, ch=8)
    y = np.random.default_rng(8).uniform(0, 255, (24, 23)).astype(np.float32)
    base = np.asarray(vdsr.forward_hr(params, y, spec, clamp=False))
    packed = np.asarray(vdsr.forward_hr(params, y, spec, clamp=False,
                                        lane_pack=4))
    np.testing.assert_allclose(packed, base, rtol=2e-6, atol=2e-3)


def test_lane_pack_gradients_match_direct():
    """Autodiff through the packed formulation lands the same gradients
    on the true [3,3,ch,ch] parameters (the weight expansion is linear,
    so grads fold back exactly up to f32 order)."""
    import jax
    import jax.numpy as jnp

    vdsr, params, spec = _init(depth=5, ch=8)
    y = jnp.asarray(np.random.default_rng(12).uniform(
        0, 255, (2, 16, 20)).astype(np.float32))
    t = y * 0.9 + 3.0

    def loss(p, lane_pack):
        out = vdsr.forward_hr(p, y, spec, clamp=False, lane_pack=lane_pack)
        return jnp.mean((out - t) ** 2)

    g1 = jax.grad(lambda p: loss(p, 1))(params)
    g4 = jax.grad(lambda p: loss(p, 4))(params)
    for k in g1:
        np.testing.assert_allclose(np.asarray(g4[k]), np.asarray(g1[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
