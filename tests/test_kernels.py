"""Fused srcnn kernel vs the XLA path (interpret mode on CPU), its tier ->
dot mapping, its choice of interpret mode and its border semantics."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libsrcnn_tpu.models import srcnn
from libsrcnn_tpu.kernels import fused_conv
from libsrcnn_tpu.pipeline import resolve_pallas


@pytest.fixture(scope="module")
def params():
    return srcnn.load_params()


@pytest.fixture
def on_backend(monkeypatch):
    """Pretend JAX's default backend is the given one."""
    def set_backend(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_backend


@pytest.mark.parametrize("shape", [(96, 124), (100, 140), (48, 48), (130, 250)])
def test_fused_matches_xla(params, shape):
    y = np.random.default_rng(13).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    got = np.asarray(fused_conv.forward_y(params, jnp.asarray(y)))
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("tier,tol", [("bfloat16", 4.0),
                                      ("bfloat16_fast", 8.0)])
@pytest.mark.parametrize("shape", [(37, 70), (5, 3), (33, 129)])
def test_bf16_tiers_match_xla(params, shape, tier, tol):
    """Shapes that are no multiple of the tile: every pixel stays inside
    the tier's envelope (bf16 weights; + bf16 activations for fast)."""
    y = np.random.default_rng(21).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    got = np.asarray(fused_conv.forward_y(params, jnp.asarray(y), tier=tier))
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol


def test_fused_border_semantics(params):
    """The 2-px output border must reproduce the reference's
    conv2-output-replicate padding exactly (not a wider conv ring)."""
    y = np.random.default_rng(14).uniform(0, 255, (64, 64)).astype(np.float32)
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    got = np.asarray(fused_conv.forward_y(params, jnp.asarray(y)))
    for sl in [np.s_[:2, :], np.s_[-2:, :], np.s_[:, :2], np.s_[:, -2:]]:
        np.testing.assert_allclose(got[sl], ref[sl], atol=2e-3)


def test_fused_batched(params):
    ys = np.random.default_rng(15).uniform(0, 255, (2, 48, 62)).astype(np.float32)
    got = np.asarray(fused_conv.forward_y(params, jnp.asarray(ys)))
    assert got.shape == (2, 48, 62)
    one = np.asarray(fused_conv.forward_y(params, jnp.asarray(ys[1])))
    np.testing.assert_array_equal(got[1], one)


def test_fused_vmapped_matches_per_plane(params):
    """The serve paths vmap the pass: the kernel's batching rule must
    give each plane its own result."""
    ys = np.random.default_rng(22).uniform(0, 255, (3, 20, 36)).astype(np.float32)
    fn = jax.vmap(lambda v: fused_conv._fused(v, params, interpret=True))
    got = np.asarray(fn(jnp.asarray(ys)))
    for k in range(3):
        one = np.asarray(fused_conv._fused(jnp.asarray(ys[k]), params,
                                           interpret=True))
        np.testing.assert_array_equal(got[k], one)


def test_fused_output_range(params):
    y = np.random.default_rng(16).uniform(-50, 400, (48, 62)).astype(np.float32)
    out = np.asarray(fused_conv.forward_y(params, jnp.asarray(y)))
    assert out.min() >= 0.0 and out.max() <= 255.0


def test_bf16_modes_accuracy_ladder(params):
    """The three tiers form an accuracy ladder vs the XLA-exact output:
    float32 < bfloat16 (hi+lo activations, bf16 weights) < bfloat16_fast
    (one bf16 dot), each within its documented envelope (PERF.md)."""
    y = np.random.default_rng(18).uniform(0, 255, (100, 150)).astype(np.float32)
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    d = {tier: np.abs(np.asarray(fused_conv.forward_y(
        params, jnp.asarray(y), tier=tier)) - ref).max()
        for tier in fused_conv.TIERS}
    assert d["float32"] <= 2e-3
    assert d["bfloat16"] <= 4.0       # weight bf16 rounding only
    assert d["bfloat16_fast"] <= 8.0  # + activation bf16 rounding
    assert d["float32"] < d["bfloat16"] < d["bfloat16_fast"]


def test_halo_pad_mode_matches_none(params):
    """A replicate-padded plane with every edge flag set is the plain
    plane: the two pad modes are bit-identical."""
    y = np.random.default_rng(23).uniform(0, 255, (30, 41)).astype(np.float32)
    a = fused_conv._fused(jnp.asarray(y), params, interpret=True)
    ext = jnp.pad(jnp.asarray(y), fused_conv.HALO, mode="edge")
    b = fused_conv._fused(ext, params, pad_mode="halo", interpret=True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("flags", [(0, 0, 0, 0), (1, 0, 1, 0), (0, 1, 0, 1)])
def test_edge_flags_keep_interior_ring(params, flags):
    """Where a side is not a true edge, the conv2 ring holds the real
    neighbour pixels: the kernel matches the XLA halo body (which replaces
    the ring only on flagged sides) cropped from a larger plane."""
    from libsrcnn_tpu.chunked import _xla_halo_forward

    h, w = 24, 33
    ext = np.random.default_rng(24).uniform(
        0, 255, (h + 12, w + 12)).astype(np.float32)
    f = jnp.asarray(flags, jnp.int32)
    got = np.asarray(fused_conv._fused(jnp.asarray(ext), params, f,
                                       pad_mode="halo", interpret=True))
    # the XLA band body clamps columns unconditionally, so compare it on
    # its own terms: both column flags set
    if flags[2] and flags[3]:
        ref = np.asarray(_xla_halo_forward(params, jnp.asarray(ext), f, h, w))
        np.testing.assert_allclose(got, ref, atol=2e-3)
    # and against a direct conv over the haloed plane with the ring
    # clamped on flagged sides only
    from libsrcnn_tpu.models.srcnn import _conv

    x = jnp.asarray(ext)[None, :, :, None]
    h1 = jnp.maximum(_conv(x, params["w1"]) + params["b1"], 0.0)
    h2 = jnp.maximum(_conv(h1, params["w2"]) + params["b2"], 0.0)[0]
    rows = np.arange(h + 4) - 2
    cols = np.arange(w + 4) - 2
    if flags[0]:
        rows = np.maximum(rows, 0)
    if flags[1]:
        rows = np.minimum(rows, h - 1)
    if flags[2]:
        cols = np.maximum(cols, 0)
    if flags[3]:
        cols = np.minimum(cols, w - 1)
    h2 = h2[rows + 2][:, cols + 2]
    h3 = _conv(h2[None], params["w3"]) + params["b3"]
    ref = np.clip(np.asarray(h3[0, :, :, 0]), 0.0, 255.0)
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_tile_grid_does_not_change_results(params):
    """Bands and shards rely on it: another tile grid over the same
    plane gives the same pixels."""
    y = np.random.default_rng(25).uniform(0, 255, (21, 70)).astype(np.float32)
    a = fused_conv._fused(jnp.asarray(y), params, interpret=True)
    b = fused_conv._fused(jnp.asarray(y), params, interpret=True,
                          tile=(8, 16))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_conv3_sum_matches_direct_conv(params):
    """The XLA epilogue: 25 shifted tap planes summed == the 5x5 conv."""
    from libsrcnn_tpu.models.srcnn import _conv

    rng = np.random.default_rng(26)
    c2 = jnp.asarray(rng.uniform(0, 4, (14, 17, 32)).astype(np.float32))
    w3 = params["w3"]
    g = jnp.einsum("hwc,kc->khw", c2, w3.reshape(25, 32),
                   precision=jax.lax.Precision.HIGHEST)
    got = fused_conv._conv3_sum(g, params["b3"], 10, 13)
    ref = _conv(c2[None], w3)[0, :, :, 0] + params["b3"]
    np.testing.assert_allclose(np.asarray(got),
                               np.clip(np.asarray(ref), 0, 255), atol=1e-3)


def test_kernel_weight_layout(params):
    """conv1 splits at taps 64 and 80 (t = 9*dy + dx); conv3's 25 taps
    (k = 5*dy + dx) are the live columns of a zero-padded [32, 32]."""
    w1a, w1b, w1c, b1, w2, b2, w3 = fused_conv._kernel_weights(params,
                                                               "float32")
    w1 = np.asarray(params["w1"])[:, :, 0, :]
    np.testing.assert_array_equal(np.asarray(w1a[9 * 2 + 3]), w1[2, 3])
    np.testing.assert_array_equal(np.asarray(w1b[70 - 64]), w1[7, 7])
    np.testing.assert_array_equal(np.asarray(w1c), w1[8, 8])
    assert w3.shape == (32, 32)
    np.testing.assert_array_equal(np.asarray(w3[:, 5 * 1 + 4]),
                                  np.asarray(params["w3"])[1, 4, :, 0])
    assert not np.asarray(w3[:, 25:]).any()
    for tier in ("bfloat16", "bfloat16_fast"):
        ws = fused_conv._kernel_weights(params, tier)
        assert [a.dtype for a in ws] == [jnp.bfloat16, jnp.bfloat16,
                                         jnp.float32, jnp.float32,
                                         jnp.bfloat16, jnp.float32,
                                         jnp.bfloat16]
        # the f32 rank-1 tap carries the bf16-rounded weight
        np.testing.assert_array_equal(
            np.asarray(ws[2]),
            np.asarray(jnp.asarray(w1[8, 8]).astype(jnp.bfloat16)
                       .astype(jnp.float32)))


@pytest.mark.parametrize("tier,interpret,want", [
    ("float32", False, "EXACT_DOT"),
    ("float32", True, jax.lax.Precision.HIGHEST),
    ("bfloat16", False, jax.lax.Precision.HIGHEST),
    ("bfloat16_fast", True, jax.lax.Precision.HIGHEST),
])
def test_tier_dot_mapping(tier, interpret, want):
    if want == "EXACT_DOT":
        want = fused_conv.EXACT_DOT
    assert fused_conv.dot_precision(tier, interpret) == want
    with pytest.raises(ValueError, match="tier"):
        fused_conv.dot_precision("int8", interpret)


def test_bf16_tiers_round_operands_explicitly():
    """bfloat16 = hi + lo bf16 dots (near-exact activations), bfloat16_fast
    = one bf16 dot, both on bf16 weights with f32 accumulation."""
    rng = np.random.default_rng(27)
    x = jnp.asarray(rng.uniform(0, 255, (16, 32)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    hi = jax.lax.Precision.HIGHEST
    exact = np.asarray(jnp.dot(x, w.astype(jnp.float32), precision=hi))
    two = np.asarray(fused_conv._mm(x, w, "bfloat16", hi))
    one = np.asarray(fused_conv._mm(x, w, "bfloat16_fast", hi))
    xb = x.astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_allclose(
        one, np.asarray(jnp.dot(xb, w.astype(jnp.float32), precision=hi)),
        rtol=1e-6, atol=1e-4)
    assert np.abs(two - exact).max() < np.abs(one - exact).max()
    assert np.abs(two - exact).max() <= 1e-2


@pytest.mark.parametrize("backend,want", [("cpu", True), ("gpu", False)])
def test_interpret_mode_per_backend(on_backend, backend, want):
    on_backend(backend)
    assert fused_conv.interpret_mode() is want


def test_interpret_mode_rejects_other_backends(on_backend):
    on_backend("rocm")
    with pytest.raises(RuntimeError, match="gpu"):
        fused_conv.interpret_mode()


def test_resolve_pallas_auto(on_backend):
    # CPU backend in tests -> auto resolves to XLA
    assert resolve_pallas(None) is False
    assert resolve_pallas(True) is True
    assert resolve_pallas(False) is False
    # int8 always runs its XLA twin
    assert resolve_pallas(True, "int8") is False
    on_backend("gpu")
    from libsrcnn_tpu.pipeline import PALLAS_TIERS

    for tier in ("float32", "bfloat16", "bfloat16_fast", "int8"):
        assert resolve_pallas(None, tier) is (tier in PALLAS_TIERS)


def test_pipeline_pallas_path_matches(params):
    """End-to-end pipeline with use_pallas=True (interpret) vs XLA path."""
    from libsrcnn_tpu import upscale, SRCNNConfig

    img = np.random.default_rng(17).integers(0, 256, (20, 24, 3), np.uint8)
    a = upscale(img, 2.0, SRCNNConfig(use_pallas=False))
    b = upscale(img, 2.0, SRCNNConfig(use_pallas=True))
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("tier", fused_conv.TIERS)
def test_fused_compiled_on_gpu(params, tier):
    """The compiled (Triton) kernel against the XLA reference on the card;
    chip_smoke.py runs the same comparison at full width."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled kernel has no CPU form")
    y = np.random.default_rng(28).uniform(0, 255, (300, 517)).astype(np.float32)
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    got = np.asarray(fused_conv.forward_y(params, jnp.asarray(y), tier=tier))
    tol = {"float32": 2e-3, "bfloat16": 4.0, "bfloat16_fast": 8.0}[tier]
    assert np.abs(got - ref).max() <= tol
