"""SRCNN 9-1-5 forward as one Pallas (Triton) kernel plus one XLA fusion.

The unfused XLA path (:func:`libsrcnn_tpu.models.srcnn.forward_y`) writes
the 64-plane conv1 and 32-plane conv2 activations to device memory and
reads them back.  Here one kernel takes every pixel from the Y plane to
conv3's per-tap products without storing either activation:

* each program owns a ``tile`` of pixels of the conv2 plane, which is the
  output plane plus the 2-px ring conv3 reads;
* conv1 gathers each pixel's 9x9 taps straight from the Y plane (a
  2048^2 f32 plane is 16 MB and stays in L2) and runs as tensor-core dots,
  ``[P, 64] x [64, 64]`` and ``[P, 16] x [16, 64]`` for taps 0..79 plus a
  rank-1 update for tap 80, so no tap is padded; bias, ReLU;
* conv2 is ``[P, 64] x [64, 32]``; bias, ReLU;
* conv3's tap products ``G = c2 x W3`` (``[P, 32] x [32, 32]``, 25 live
  columns) are written out as 25 planes, 100 B per pixel against the
  ~768 B per pixel of the unfused path's activation traffic.

conv3's 5x5 stencil reads *shifted* c2 values, which a Triton program
cannot take from registers, so the 25 shifted plane sums, the bias and
the clamp run in XLA as one elementwise fusion (:func:`_conv3_sum`).

Image-border semantics: the reference replicate-pads conv2's OUTPUT before
conv3 (`libsrcnn.cpp:463-489`).  The kernel reproduces this by clamping
each ring pixel's centre to the image before it gathers the taps, so the
ring holds the edge pixel's c2 exactly.  ``edge_flags`` [top, bottom,
left, right] gate the clamp per side: a band or shard whose border is not
a true image edge keeps the real neighbour pixels its halo carries.

Each tier's dots are spelled out here (:func:`_mm`), not left to a
default precision: float32 is a dot as accurate as f32 (``EXACT_DOT``);
bfloat16 splits the f32 activations into hi + lo bf16 halves, two bf16
dots against bf16 weights with f32 accumulation; bfloat16_fast is one
bf16 dot.  The per-pixel
arithmetic does not depend on the tile grid or the plane shape, so bands
and shards of one plane are bit-identical to the whole plane.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

HALO = 6          # 4 (conv1) + 2 (conv3) each side
RING = 2          # conv3's reach into the conv2 plane
TAPS3 = 25        # conv3 taps, k = 5*dy + dx

#: (rows, cols) of conv2-plane pixels per program and warps per program
TILE = (4, 32)
NUM_WARPS = 4

#: the kernel's tiers (the srcnn compute_dtype names it serves)
TIERS = ("float32", "bfloat16", "bfloat16_fast")

#: the f32 tier's dot on the card: six bf16 tensor-core passes over
#: three-way bf16 splits of both operands, which keeps ~f32 accuracy.  On
#: an H100 (400 W) at 2048^2 the kernel took 3.15 ms this way, 3.56 ms
#: with TF32_TF32_F32_X3 and 16.7 ms with IEEE f32 FMAs (PERF.md, "H100")
EXACT_DOT = lax.DotAlgorithmPreset.BF16_BF16_F32_X6


def interpret_mode() -> bool:
    """The one place that decides how Pallas kernels run: interpreted on
    the CPU backend, compiled on the GPU, and nowhere else -- a machine
    with a GPU never interprets quietly."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"the fused kernel runs on 'gpu' (or interpreted on "
                       f"'cpu'), not on {backend!r}")


def dot_precision(tier: str, interpret: bool):
    """The ``precision`` each tier's dots pass.  bf16 operands with
    HIGHEST are plain bf16 tensor-core dots with f32 accumulation; f32
    operands take :data:`EXACT_DOT` on the card.  The CPU does not run
    the multi-pass presets, so interpreted runs keep HIGHEST (plain f32)."""
    if tier not in TIERS:
        raise ValueError(f"kernel tier {tier!r} is not one of {TIERS}")
    if tier == "float32" and not interpret:
        return EXACT_DOT
    return lax.Precision.HIGHEST


def _mm(x, w, tier: str, precision):
    """``x [P, K] x w [K, N]`` in the tier's dot algorithm, f32 result."""
    def dot(a, b):
        return jnp.dot(a, b, precision=precision,
                       preferred_element_type=jnp.float32)

    if tier == "float32":
        return dot(x, w)
    hi = x.astype(jnp.bfloat16)
    acc = dot(hi, w)
    if tier == "bfloat16":
        lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        acc = acc + dot(lo, w)
    return acc


def _clamp_centre(v, lo_edge, hi_edge, n: int):
    """Centre coordinate of one conv2-plane pixel: the ring clamps onto
    the image where that side is a true edge; rows past the plane (grid
    padding) clamp to its last ring row so every tap stays in the halo."""
    v = jnp.where((lo_edge == 1) & (v < 0), 0, v)
    v = jnp.where((hi_edge == 1) & (v > n - 1), n - 1, v)
    return jnp.minimum(v, n - 1 + RING)


def _kernel(flags_ref, y_ref, w1a_ref, w1b_ref, w1c_ref, b1_ref, w2_ref,
            b2_ref, w3_ref, g_ref, *, h: int, w: int, tile: tuple,
            tier: str, precision):
    tr, tc = tile
    npx = tr * tc
    wx = w + 2 * HALO                   # row stride of the haloed plane
    hc, wc = h + 2 * RING, w + 2 * RING  # conv2 plane
    p = lax.broadcasted_iota(jnp.int32, (npx,), 0)
    r = pl.program_id(0) * tr + p // tc
    c = pl.program_id(1) * tc + p % tc
    cy = _clamp_centre(r - RING, flags_ref[0], flags_ref[1], h)
    cx = _clamp_centre(c - RING, flags_ref[2], flags_ref[3], w)
    # haloed-plane offset of tap (0, 0) of each pixel's 9x9 window
    base = (cy + RING) * wx + (cx + RING)

    def taps(t0: int, n: int):
        t = lax.broadcasted_iota(jnp.int32, (1, n), 1) + t0
        return plgpu.load(y_ref.at[base[:, None] + (t // 9) * wx + t % 9])

    x80 = plgpu.load(y_ref.at[base + 8 * wx + 8])
    if tier == "bfloat16_fast":
        x80 = x80.astype(jnp.bfloat16).astype(jnp.float32)
    h1 = (_mm(taps(0, 64), w1a_ref[...], tier, precision)
          + _mm(taps(64, 16), w1b_ref[...], tier, precision)
          + x80[:, None] * w1c_ref[...][None, :])
    h1 = jnp.maximum(h1 + b1_ref[...][None, :], 0.0)
    c2 = _mm(h1, w2_ref[...], tier, precision)
    c2 = jnp.maximum(c2 + b2_ref[...][None, :], 0.0)
    g = _mm(c2, w3_ref[...], tier, precision)      # [P, 32], 25 live

    k = lax.broadcasted_iota(jnp.int32, (1, 32), 1)
    live = (k < TAPS3) & ((r < hc) & (c < wc))[:, None]
    offs = k * (hc * wc) + (r * wc + c)[:, None]
    # masked lanes point past the end: never touched on the card, and
    # dropped by the interpreter's scatter
    offs = jnp.where(live, offs, TAPS3 * hc * wc)
    plgpu.store(g_ref.at[offs], g, mask=live)


def _kernel_weights(params: dict, tier: str):
    """The kernel's weight layout: conv1 split at tap 64 and 80, conv3's
    taps as the 25 live of 32 columns.  The bf16 tiers get bf16 weights
    (the f32 rank-1 tap sees the same bf16-rounded values)."""
    wdt = jnp.float32 if tier == "float32" else jnp.bfloat16
    w1 = params["w1"].reshape(81, 64).astype(wdt)
    w3 = params["w3"].reshape(TAPS3, 32).T.astype(wdt)       # [32, 25]
    w3 = jnp.pad(w3, ((0, 0), (0, 32 - TAPS3)))
    return (w1[:64], w1[64:80], w1[80].astype(jnp.float32),
            params["b1"].astype(jnp.float32),
            params["w2"].reshape(64, 32).astype(wdt),
            params["b2"].astype(jnp.float32), w3)


def _conv3_sum(g, b3, h: int, w: int):
    """conv3 from its tap planes: out[y, x] = b3 + sum_k G[k, y+dy, x+dx],
    clamped to [0, 255] (`libsrcnn.cpp:521-522`)."""
    acc = None
    for dy in range(5):
        for dx in range(5):
            t = g[5 * dy + dx, dy:dy + h, dx:dx + w]
            acc = t if acc is None else acc + t
    return jnp.clip(acc + b3.reshape(()).astype(jnp.float32), 0.0, 255.0)


@functools.partial(jax.jit, static_argnames=("pad_mode", "tier",
                                             "interpret", "tile",
                                             "num_warps"))
def _fused(y, params, edge_flags=None, *, pad_mode: str = "none",
           tier: str = "float32", interpret: bool | None = None,
           tile: tuple = TILE, num_warps: int = NUM_WARPS):
    """Run the fused kernel on one plane; returns the clamped [h, w] conv3.

    ``pad_mode``:
      * ``"none"``: ``y`` is the [h, w] plane; the 6-px replicate halo is
        padded here and every side is a true edge.
      * ``"halo"``: ``y`` is [h+12, w+12] with the halo already present
        (a band's or shard's real neighbour pixels, or a replicate pad);
        ``edge_flags`` [4] says which sides are true image edges (top,
        bottom, left, right), all of them when omitted.

    ``interpret=None`` takes :func:`interpret_mode`.
    """
    if interpret is None:
        interpret = interpret_mode()
    if pad_mode == "none":
        y = jnp.pad(y, HALO, mode="edge")
    elif pad_mode != "halo":
        raise ValueError(f"pad_mode {pad_mode!r} is not 'none' or 'halo'")
    h, w = y.shape[0] - 2 * HALO, y.shape[1] - 2 * HALO
    if edge_flags is None:
        edge_flags = jnp.ones((4,), jnp.int32)
    hc, wc = h + 2 * RING, w + 2 * RING
    if TAPS3 * hc * wc >= 2 ** 31:
        raise ValueError(f"plane {h}x{w} too large for int32 tap offsets")
    tr, tc = tile
    precision = dot_precision(tier, interpret)
    body = functools.partial(_kernel, h=h, w=w, tile=tile, tier=tier,
                             precision=precision)
    g = pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct((TAPS3 * hc * wc,), jnp.float32),
        grid=(-(-hc // tr), -(-wc // tc)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="srcnn_fused_conv",
    )(jnp.asarray(edge_flags, jnp.int32), y.astype(jnp.float32).reshape(-1),
      *_kernel_weights(params, tier))
    return _conv3_sum(g.reshape(TAPS3, hc, wc), params["b3"], h, w)


def forward_y(params: dict, y: jnp.ndarray, *, tier: str = "float32",
              interpret: bool | None = None) -> jnp.ndarray:
    """Fused replacement for :func:`libsrcnn_tpu.models.srcnn.forward_y`
    (clamped inference path).  Accepts [H, W] or [N, H, W]."""
    squeeze = y.ndim == 2
    if squeeze:
        y = y[None]
    out = jnp.stack([_fused(plane, params, tier=tier, interpret=interpret)
                     for plane in y])
    return out[0] if squeeze else out
