"""Multi-device paths on the 8-device virtual CPU mesh: explicit halo
exchange, GSPMD batch/spatial sharding -- all must be bit-identical to the
single-device pipeline."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libsrcnn_tpu import SRCNNConfig, upscale
from libsrcnn_tpu.models import srcnn
from libsrcnn_tpu.parallel import halo, sharding
from libsrcnn_tpu.parallel.mesh import default_mesh, make_mesh


@pytest.fixture(scope="module")
def params():
    return srcnn.load_params()


@pytest.fixture(scope="module")
def y():
    return np.random.default_rng(9).uniform(0, 255, (64, 96)).astype(np.float32)


@pytest.mark.parametrize("axes", [
    {"data": 1, "row": 4, "col": 2},
    {"data": 1, "row": 8, "col": 1},
    {"data": 1, "row": 1, "col": 8},
    {"data": 2, "row": 2, "col": 2},
    {"data": 8, "row": 1, "col": 1},
])
def test_halo_tiled_bitexact(params, y, axes):
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, jax.devices()[:n])
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    out = np.asarray(halo.forward_y_tiled(params, jnp.asarray(y), mesh))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("axes", [
    {"data": 1, "row": 4, "col": 2},
    {"data": 2, "row": 2, "col": 2},
    {"data": 1, "row": 1, "col": 1},
])
def test_halo_tiled_pallas_matches(params, y, axes):
    """Fused-kernel per-device body (single 6px exchange + edge flags)."""
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, jax.devices()[:n])
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    out = np.asarray(halo.forward_y_tiled(params, jnp.asarray(y), mesh,
                                          use_pallas=True))
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("tier", ["bfloat16", "bfloat16_fast"])
def test_halo_tiled_bf16_tiers_bitexact_vs_single_device(params, y, tier):
    """The bf16 tiers partition exactly like the exact tier: the sharded
    fused kernel must be bit-identical to the SAME tier's single-device
    fused kernel (per-pixel arithmetic does not depend on the grid)."""
    from libsrcnn_tpu.kernels import fused_conv

    ref = np.asarray(fused_conv.forward_y(params, jnp.asarray(y), tier=tier))
    mesh = make_mesh({"data": 1, "row": 2, "col": 4})
    out = np.asarray(halo.forward_y_tiled(params, jnp.asarray(y), mesh,
                                          use_pallas=True,
                                          compute_dtype=tier))
    np.testing.assert_array_equal(out, ref)


def test_halo_bf16_tier_requires_pallas(params, y):
    mesh = make_mesh({"data": 1, "row": 2, "col": 2}, jax.devices()[:4])
    with pytest.raises(ValueError, match="Pallas"):
        halo.forward_y_tiled(params, jnp.asarray(y), mesh,
                             use_pallas=False, compute_dtype="bfloat16")


def test_halo_validates_divisibility(params, y):
    mesh = make_mesh({"data": 1, "row": 8, "col": 1})
    with pytest.raises(ValueError):
        halo.forward_y_tiled(params, jnp.asarray(y[:30]), mesh)  # 30 % 8 != 0


def test_halo_tiny_tile_rejected(params):
    mesh = make_mesh({"data": 1, "row": 8, "col": 1})
    tiny = jnp.zeros((16, 16), jnp.float32)  # 2-row tiles < 4px halo
    with pytest.raises(ValueError):
        halo.forward_y_tiled(params, tiny, mesh)


def test_gspmd_batch_matches_single(params):
    mesh = make_mesh({"data": 4, "row": 2, "col": 1})
    imgs = np.random.default_rng(10).integers(0, 256, (8, 24, 32, 3), np.uint8)
    out, conv = sharding.upscale_batch(jnp.asarray(imgs), params, 2.0,
                                       SRCNNConfig(), mesh)
    for i in (0, 5):
        ref, refc = upscale(imgs[i], 2.0, return_conv_map=True)
        np.testing.assert_array_equal(np.asarray(out)[i], ref)
        np.testing.assert_array_equal(np.asarray(conv)[i], refc)


def test_gspmd_batch_lr_family(params):
    """Data-parallel batched serving supports the LR model families."""
    from libsrcnn_tpu import pipeline

    mesh = make_mesh({"data": 4, "row": 2, "col": 1})
    imgs = np.random.default_rng(12).integers(0, 256, (4, 16, 16, 3), np.uint8)
    cfg = SRCNNConfig(model="espcn")
    eparams = pipeline.load_model_params(cfg, 2.0)
    out, conv = sharding.upscale_batch(jnp.asarray(imgs), eparams, 2.0,
                                       cfg, mesh)
    ref = upscale(imgs[1], 2.0, cfg)
    np.testing.assert_array_equal(np.asarray(out)[1], ref)


def test_gspmd_spatial_lr_family(params):
    """Spatially sharded inference works for the LR families too (their
    convs are plain XLA ops, which GSPMD partitions with automatic halo
    collectives) and matches single-device output exactly."""
    from libsrcnn_tpu import pipeline

    mesh = make_mesh({"data": 1, "row": 4, "col": 2})
    img = np.random.default_rng(13).integers(0, 256, (32, 32, 3), np.uint8)
    cfg = SRCNNConfig(model="fsrcnn")
    fparams = pipeline.load_model_params(cfg, 2.0)
    out, conv = sharding.upscale_spatial(jnp.asarray(img), fparams, 2.0,
                                         cfg, mesh)
    ref = upscale(img, 2.0, cfg)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_gspmd_spatial_srcnn955(params):
    """The generic 9-5-5 HR head shards spatially under GSPMD like the
    rest of the zoo (XLA partitions its SAME convs with automatic halo
    collectives)."""
    from libsrcnn_tpu import pipeline

    mesh = make_mesh({"data": 2, "row": 2, "col": 2})
    img = np.random.default_rng(14).integers(0, 256, (48, 40, 3), np.uint8)
    cfg = SRCNNConfig(model="srcnn955")
    fparams = pipeline.load_model_params(cfg, 2.0)
    out, _ = sharding.upscale_spatial(jnp.asarray(img), fparams, 2.0,
                                      cfg, mesh)
    ref = upscale(img, 2.0, cfg)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_gspmd_batch_divisibility(params):
    mesh = make_mesh({"data": 4, "row": 2, "col": 1})
    imgs = np.zeros((6, 16, 16, 3), np.uint8)
    with pytest.raises(ValueError):
        sharding.upscale_batch(jnp.asarray(imgs), params, 2.0, SRCNNConfig(), mesh)


def test_gspmd_spatial_matches_single(params):
    mesh = make_mesh({"data": 1, "row": 4, "col": 2})
    img = np.random.default_rng(11).integers(0, 256, (64, 64, 3), np.uint8)
    out, conv = sharding.upscale_spatial(jnp.asarray(img), params, 2.0,
                                         SRCNNConfig(), mesh)
    ref, refc = upscale(img, 2.0, return_conv_map=True)
    np.testing.assert_array_equal(np.asarray(out), ref)
    np.testing.assert_array_equal(np.asarray(conv), refc)


def test_mesh_paths_reject_step_scale(params):
    # step_scale runs chained x2 passes with u8 round trips between them;
    # the one-pass mesh paths reject it rather than silently diverging
    # from api.upscale (same contract as tiled / serving).
    mesh = make_mesh({"data": 2, "row": 2, "col": 2})
    cfg = SRCNNConfig(step_scale=True)
    imgs = np.zeros((2, 16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="step_scale"):
        sharding.upscale_batch(jnp.asarray(imgs), params, 4.0, cfg, mesh)
    with pytest.raises(ValueError, match="step_scale"):
        sharding.upscale_spatial(jnp.asarray(imgs[0]), params, 4.0, cfg, mesh)


def test_gspmd_spatial_rejects_pallas(params):
    # GSPMD cannot partition a pallas call: an explicit use_pallas=True is
    # an error, never silently ignored (use parallel.tiled instead).
    mesh = make_mesh({"data": 1, "row": 4, "col": 2})
    img = np.random.default_rng(11).integers(0, 256, (64, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="use_pallas"):
        sharding.upscale_spatial(jnp.asarray(img), params, 2.0,
                                 SRCNNConfig(use_pallas=True), mesh)


def test_default_mesh_shapes():
    m = default_mesh(8)
    assert int(np.prod(list(m.shape.values()))) == 8
    assert set(m.axis_names) == {"data", "row", "col"}
    m1 = default_mesh(1)
    assert int(np.prod(list(m1.shape.values()))) == 1


def test_make_mesh_validates():
    with pytest.raises(ValueError):
        make_mesh({"data": 3, "row": 3}, jax.devices()[:8])


def test_upscale_batch_self_ensemble_matches_api():
    """The dp-sharded batch path honors self_ensemble directly: each
    device runs the vmapped 4-variant ensemble body on its frame shard,
    bit-identical to the per-frame api ensemble."""
    import jax
    import numpy as np

    from libsrcnn_tpu import SRCNNConfig, upscale
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.parallel import sharding
    from libsrcnn_tpu.parallel.mesh import make_mesh

    cfg = SRCNNConfig(self_ensemble=True, use_pallas=False)
    frames = np.random.default_rng(21).integers(
        0, 256, (4, 14, 12, 3), np.uint8)
    ref = np.stack([upscale(f, 2.0, cfg) for f in frames])
    mesh = make_mesh({"data": 4, "row": 1, "col": 1}, jax.devices()[:4])
    out, conv = sharding.upscale_batch(jax.numpy.asarray(frames),
                                       srcnn.load_params(), 2.0, cfg, mesh)
    np.testing.assert_array_equal(np.asarray(out), ref)
    assert np.asarray(conv).shape == (4, 28, 24)
