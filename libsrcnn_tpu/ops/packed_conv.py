"""Lane-packed SAME convolution: widen the output-channel dimension of
narrow-channel conv stacks by packing adjacent output columns into it.

Why: a ``ch=32`` stack (VDSR) or a ``ch=12`` one (FSRCNN's mapping
layers) gives a matrix unit a narrow output; packing ``p`` columns makes
it ``p`` times wider at the cost of zero-filled MACs.  The transform was
built for the first target's 128-wide matrix unit; on the GPU it is an
explicit opt-in (``lane_pack=True``) until ROADMAP D3 measures it.  The
reference has no analog (its convs are scalar loops,
`libsrcnn.cpp:350-529`).

How: pack ``p`` horizontally-adjacent output columns ("phases") into the
lane dimension.  A SAME ``kh x kw`` conv producing columns
``m*p .. m*p+p-1`` reads input columns ``m*p-lo .. m*p+p-1+hi`` (with
``lo+hi = kw-1``) -- a window of ``p+kw-1`` columns.  So the packed conv
is an ordinary XLA convolution with

* window ``(kh, p+kw-1)``, horizontal stride ``p``,
* ``p*cout`` output channels,
* an expanded kernel ``wp[dy, t, c, (j, co)] = w[dy, t-j, c, co]``
  (zero outside ``0 <= t-j < kw``): phase ``j``'s taps sit ``j`` columns
  deeper into the shared window.

XLA lowers it as one implicit GEMM with ``K = kh*(p+kw-1)*cin`` and
``N = p*cout`` -- no im2col materialization in HBM.  The zeros cost
``(p+kw-1)/kw`` extra MACs while the lane usage grows ``p``-fold, a net
``p*kw/(p+kw-1)`` speedup where the stack is lane-bound: 2.0x for
``kw=3, p=4``.  (Full 2-D space-to-depth packing was measured as a
no-win -- its FLOP inflation exactly cancels the lane gain, PERF.md
"VDSR roofline"; packing ONE axis keeps the zero fill linear instead of
quadratic, which is the whole trick.)

The transform is numerically the same set of f32 MACs in a different
reduction order (plus exact zeros), so outputs match the direct conv to
f32 rounding; families with a u8 golden gate (srcnn) do not use it.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax


def pack_weights(w: jnp.ndarray, p: int) -> jnp.ndarray:
    """[kh, kw, cin, cout] -> [kh, p+kw-1, cin, p*cout] phase-expanded.

    Column ``(j, co)`` (j = output phase, fastest-varying axis is co)
    holds ``w[:, :, :, co]`` shifted ``j`` taps deeper into the window.
    """
    kh, kw, cin, cout = w.shape
    cols = []
    for j in range(p):
        cols.append(jnp.pad(w, ((0, 0), (j, p - 1 - j), (0, 0), (0, 0))))
    # [p, kh, p+kw-1, cin, cout] -> [kh, p+kw-1, cin, p, cout]
    wp = jnp.stack(cols, axis=0).transpose(1, 2, 3, 0, 4)
    return wp.reshape(kh, p + kw - 1, cin, p * cout)


def packed_conv(x: jnp.ndarray, w: jnp.ndarray, p: int,
                padding, precision=lax.Precision.DEFAULT,
                pad_mode: str = "constant") -> jnp.ndarray:
    """Stride-1 conv with explicit padding, via p-phase lane packing.

    ``x``: [N, H, W, cin]; ``w``: [kh, kw, cin, cout];
    ``padding``: ((ph_lo, ph_hi), (pw_lo, pw_hi)) applied with
    ``pad_mode`` ("constant" = zeros, "edge" = replicate).  Equal to
    ``lax.conv_general_dilated(pad(x), w, (1, 1), "VALID")`` up to f32
    summation order, for any output width: the plane is padded out to a
    whole number of p-column groups (junk columns cropped; with "edge"
    mode the extra pad replicates the true edge, so kept outputs are
    unaffected either way -- zero/edge fill only feeds cropped phases).
    """
    kh, kw, cin, cout = w.shape
    (ph_lo, ph_hi), (pw_lo, pw_hi) = padding
    n, h, wid, _ = x.shape
    h_out = h + ph_lo + ph_hi - kh + 1
    w_out = wid + pw_lo + pw_hi - kw + 1
    groups = -(-w_out // p)
    extra = groups * p + kw - 1 - (wid + pw_lo + pw_hi)
    xp = jnp.pad(x, ((0, 0), (ph_lo, ph_hi), (pw_lo, pw_hi + extra),
                     (0, 0)), mode=pad_mode)
    out = lax.conv_general_dilated(
        xp, pack_weights(w, p), (1, p), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
        precision=precision)
    # [N, H_out, groups, p*cout]: phase j of group m is output col m*p+j
    out = out.reshape(n, h_out, groups * p, cout)
    return out[:, :, :w_out] if groups * p != w_out else out


def packed_conv_same(x: jnp.ndarray, w: jnp.ndarray, p: int,
                     precision=lax.Precision.DEFAULT) -> jnp.ndarray:
    """SAME-padded (edge-replicate) conv via p-phase lane packing.

    ``x``: [N, H, W, cin]; ``w``: [kh, kw, cin, cout] (odd kh/kw).
    Returns [N, H, W, cout], equal to the direct edge-padded VALID conv
    up to f32 summation order.
    """
    kh, kw = w.shape[0], w.shape[1]
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"odd kernel expected, got {(kh, kw)}")
    return packed_conv(x, w, p, ((kh // 2, kh // 2), (kw // 2, kw // 2)),
                       precision, pad_mode="edge")


def conv_same(x: jnp.ndarray, w: jnp.ndarray,
              precision=lax.Precision.HIGHEST,
              lane_pack: bool | int = False) -> jnp.ndarray:
    """SAME edge-padded conv -- the one entry the model families share.

    ``lane_pack``: False/0/1 = the direct conv; True = the
    roofline-optimal phase count for this kernel's shape (p=1 falls back
    to direct -- already-wide stacks and 1x1 convs pack nothing);
    an int > 1 = that explicit phase count.
    """
    kh, kw, _, cout = w.shape
    if lane_pack is True:
        p = best_phases(kw, cout)
    else:
        p = int(lane_pack) if lane_pack else 1
    if p > 1:
        return packed_conv_same(x, w, p, precision)
    xp = jnp.pad(x, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2),
                     (0, 0)), mode="edge")
    return lax.conv_general_dilated(
        xp, w, (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32, precision=precision)


@functools.lru_cache(maxsize=None)
def best_phases(kw: int, cout: int, lanes: int = 128) -> int:
    """Phase count maximizing the useful rate ~ min(p*cout, lanes)*kw /
    ((p+kw-1)*cout), i.e. lane fill divided by zero-fill overhead.

    Returns 1 when no packing helps (cout already >= lanes).
    """
    best_p, best_r = 1, float(min(cout, lanes)) / cout
    for p in range(2, lanes + 1):
        r = min(p * cout, lanes) * kw / float((p + kw - 1) * cout)
        if r > best_r + 1e-9:
            best_p, best_r = p, r
    return best_p
