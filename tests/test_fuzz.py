"""Fuzz: random shapes/scales/filters through the full pipeline vs the
loop-level oracle (small sizes keep the numpy oracle fast)."""

import numpy as np
import pytest

from libsrcnn_tpu import FilterType, SRCNNConfig, upscale
import oracle


@pytest.mark.parametrize("seed", range(10))
def test_random_config_matches_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    h = int(rng.integers(3, 40))
    w = int(rng.integers(3, 40))
    d = int(rng.choice([3, 4]))
    ft = FilterType(int(rng.integers(0, 5)))
    scale = float(rng.choice([0.4, 0.75, 1.5, 2.0, 2.3, 3.0]))
    img = rng.integers(0, 256, (h, w, d), np.uint8)
    # oracle needs output >= 1 px
    if int(np.float32(w) * np.float32(scale)) < 1 or \
       int(np.float32(h) * np.float32(scale)) < 1:
        scale = 2.0

    got, gotc = upscale(img, scale, SRCNNConfig(filter=ft), return_conv_map=True)
    want, wantc = oracle.do_srcnn(img, scale, ft)
    d1 = np.abs(got.astype(int) - want.astype(int))
    assert d1.max() <= 1, (seed, h, w, d, ft, scale, d1.max())
    assert np.abs(gotc.astype(int) - wantc.astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 8, 3), (2, 2, 4)])
def test_degenerate_sizes(shape):
    img = np.random.default_rng(60).integers(0, 256, shape, np.uint8)
    out = upscale(img, 2.0)
    assert out.shape == (shape[0] * 2, shape[1] * 2, shape[2])


def test_extreme_scales():
    img = np.random.default_rng(61).integers(0, 256, (8, 8, 3), np.uint8)
    assert upscale(img, 8.0).shape == (64, 64, 3)
    assert upscale(img, 0.25).shape == (2, 2, 3)
    assert upscale(img, 7.5, SRCNNConfig(step_scale=True)).shape == (60, 60, 3)


@pytest.mark.parametrize("seed", range(5))
def test_random_step_scale(seed):
    rng = np.random.default_rng(2000 + seed)
    h, w = int(rng.integers(8, 24)), int(rng.integers(8, 24))
    scale = float(rng.choice([2.0, 2.5, 3.0, 4.0]))
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    out = upscale(img, scale, SRCNNConfig(step_scale=True))
    # step-scale output geometry must follow the reference's chained-x2 math
    mult = np.float32(scale)
    lf = np.fmod(mult, np.float32(2.0))
    repeat = int(mult / np.float32(2.0)) + (1 if lf > 0 else 0)
    sw, sh = w, h
    for cnt in range(repeat):
        curmf = np.float32(2.0)
        if cnt + 1 == repeat:
            curmf = (np.float32(w) * mult) / np.float32(sw)
            if curmf == 0.0 or curmf == 1.0:
                break
        sw = int(np.float32(sw) * curmf)
        sh = int(np.float32(sh) * curmf)
    assert out.shape == (sh, sw, 3)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_bf16_kernel_modes_geometry(seed):
    """Random plane shapes through the fused kernel's bf16 tiers vs the
    XLA-exact output: shape-correct everywhere, deviation inside each
    tier's documented envelope, and the tile grid must not leak (partial
    tiles at every height and width)."""
    import jax.numpy as jnp

    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.kernels import fused_conv

    rng = np.random.default_rng(4000 + seed)
    h = int(rng.integers(3, 140))
    w = int(rng.integers(3, 300))
    params = srcnn.load_params()
    y = rng.uniform(0, 255, (h, w)).astype(np.float32)
    ref = np.asarray(srcnn.forward_y(params, jnp.asarray(y)))
    for tier, tol in (("bfloat16", 4.0), ("bfloat16_fast", 8.0)):
        got = np.asarray(fused_conv.forward_y(params, jnp.asarray(y),
                                              tier=tier))
        assert got.shape == ref.shape
        d = np.abs(got - ref).max()
        assert d <= tol, (seed, h, w, tier, d)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_packed_conv_matches_direct(seed):
    """Random (kernel, width, phases, pads) through ops.packed_conv vs
    the direct conv -- degenerate widths (W < p, W = 1) included."""
    import jax.numpy as jnp
    from jax import lax

    from libsrcnn_tpu.ops import packed_conv

    rng = np.random.default_rng(3000 + seed)
    kh = int(rng.choice([1, 3, 5, 9]))
    kw = int(rng.choice([1, 3, 5, 9]))
    cin = int(rng.integers(1, 9))
    cout = int(rng.integers(1, 9))
    h = int(rng.integers(kh, kh + 12))
    wid = int(rng.integers(1, 30))
    p = int(rng.integers(2, 16))
    pw = int(rng.integers(0, kw))  # keep every output inside the support
    pads = ((int(rng.integers(0, kh)), int(rng.integers(0, kh))), (pw, pw))
    if h + pads[0][0] + pads[0][1] < kh or wid + 2 * pw < kw:
        pads = ((kh - 1, kh - 1), (kw - 1, kw - 1))
    x = jnp.asarray(rng.normal(size=(1, h, wid, cin)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(kh, kw, cin, cout)).astype(np.float32))
    got = packed_conv.packed_conv(x, w, p, pads, lax.Precision.HIGHEST)
    want = lax.conv_general_dilated(
        x, w, (1, 1), list(pads),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST)
    assert got.shape == want.shape, (seed, got.shape, want.shape)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-6, atol=1e-4)
