"""Separable classical resize, on the device.

Device-side replica of `FRAWResizeEngine::scale` (`frawscale.cpp:162-286`).
The per-axis contribution tables are precomputed host-side in float64
(:mod:`.weights_table`), then the device applies them as a fixed-width
band-gather: for each of the K window taps, gather the shifted source rows /
columns and accumulate ``w_k * src[left+k]``.  K is static (<= 2*ceil(w)+1),
so the loop unrolls at trace time and XLA fuses the whole band into a few
vector ops -- O(K * dst * other_axis) FLOPs instead of a dense [dst, src]
matmul.

Pass ordering matches the reference (`frawscale.cpp:195-278`): upscale in
width runs the vertical pass first then horizontal; downscale-or-equal width
runs horizontal first.  Same-size resize is an exact copy (the reference's
same-size path has a half-buffer copy bug, `frawscale.cpp:185-193`, which we
deliberately do NOT reproduce -- it only triggers at scale == 1.0).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import FilterType
from .weights_table import contribution_table


def _band_arrays(filter_type: FilterType, dst: int, src: int, dtype):
    left, weights = contribution_table(filter_type, dst, src)
    window = weights.shape[1]
    # Precompute clipped gather indices per tap; weights past the right
    # boundary are zero so clipping is value-safe.
    idx = np.clip(left[:, None] + np.arange(window)[None, :], 0, src - 1)
    return idx.astype(np.int32), weights.astype(dtype)


def _resize_axis(plane: jnp.ndarray, dst: int, filter_type: FilterType, axis: int) -> jnp.ndarray:
    """Resize one axis of a [H, W] plane via the band table."""
    src = plane.shape[axis]
    if dst == src:
        return plane
    idx, w = _band_arrays(filter_type, dst, src, np.float32)
    window = w.shape[1]
    acc = None
    for k in range(window):
        if not np.any(w[:, k]):
            continue
        g = jnp.take(plane, jnp.asarray(idx[:, k]), axis=axis)
        wk = jnp.asarray(w[:, k])
        wk = wk[:, None] if axis == 0 else wk[None, :]
        term = g * wk
        acc = term if acc is None else acc + term
    if acc is None:  # degenerate: all-zero table (cannot happen in practice)
        shape = list(plane.shape)
        shape[axis] = dst
        acc = jnp.zeros(shape, plane.dtype)
    return acc


def resize_plane(
    plane: jnp.ndarray, dst_h: int, dst_w: int, filter_type: FilterType
) -> jnp.ndarray:
    """Resize a single [H, W] float plane to [dst_h, dst_w].

    Mirrors the pass ordering of `FRAWResizeEngine::scale`
    (`frawscale.cpp:195-278`).
    """
    src_h, src_w = plane.shape
    if dst_h == src_h and dst_w == src_w:
        return plane

    if dst_w <= src_w:
        # horizontal first, then vertical (`frawscale.cpp:195-237`)
        out = _resize_axis(plane, dst_w, filter_type, axis=1)
        out = _resize_axis(out, dst_h, filter_type, axis=0)
    else:
        # vertical first, then horizontal (`frawscale.cpp:238-278`)
        out = _resize_axis(plane, dst_h, filter_type, axis=0)
        out = _resize_axis(out, dst_w, filter_type, axis=1)
    return out


def _resize_axis_padded(plane: jnp.ndarray, dst: int, filter_type: FilterType,
                        axis: int, pad_lo: int, out: int) -> jnp.ndarray:
    """Like :func:`_resize_axis` but emits ``out`` entries along ``axis``:
    ``pad_lo`` replicate-padded entries, the ``dst`` real ones, then
    replicate padding to ``out``.  The padding rows reuse the first/last
    output row's contribution-table entry, so they are bit-identical to
    ``jnp.pad(resized, mode="edge")`` -- without materializing a separate
    padded copy (the fused kernel reads this plane directly)."""
    src = plane.shape[axis]
    pad_hi = out - pad_lo - dst
    if dst == src:
        # same-size axis: identity gather with clamped indices
        idx = np.clip(np.arange(out) - pad_lo, 0, src - 1).astype(np.int32)
        return jnp.take(plane, jnp.asarray(idx), axis=axis)
    idx, w = _band_arrays(filter_type, dst, src, np.float32)
    idx = np.concatenate([np.repeat(idx[:1], pad_lo, 0), idx,
                          np.repeat(idx[-1:], pad_hi, 0)])
    w = np.concatenate([np.repeat(w[:1], pad_lo, 0), w,
                        np.repeat(w[-1:], pad_hi, 0)])
    window = w.shape[1]
    acc = None
    for k in range(window):
        if not np.any(w[:, k]):
            continue
        g = jnp.take(plane, jnp.asarray(idx[:, k]), axis=axis)
        wk = jnp.asarray(w[:, k])
        wk = wk[:, None] if axis == 0 else wk[None, :]
        term = g * wk
        acc = term if acc is None else acc + term
    if acc is None:
        shape = list(plane.shape)
        shape[axis] = out
        acc = jnp.zeros(shape, plane.dtype)
    return acc


def resize_plane_padded(
    plane: jnp.ndarray, dst_h: int, dst_w: int, filter_type: FilterType,
    pad: int, out_h: int, out_w: int,
) -> jnp.ndarray:
    """Resize to [dst_h, dst_w] and emit an [out_h, out_w] plane with the
    result at offset (pad, pad), replicate-padded everywhere else.  Feeds
    the fused kernel's ``pad_mode="halo"`` call: the 6-px halo comes
    straight out of the resize gather, so no separate padding pass runs
    over the plane.  Same pass ordering as
    :func:`resize_plane`."""
    src_h, src_w = plane.shape
    if dst_w <= src_w:
        out = _resize_axis_padded(plane, dst_w, filter_type, 1, pad, out_w)
        out = _resize_axis_padded(out, dst_h, filter_type, 0, pad, out_h)
    else:
        out = _resize_axis_padded(plane, dst_h, filter_type, 0, pad, out_h)
        out = _resize_axis_padded(out, dst_w, filter_type, 1, pad, out_w)
    return out


def scaled_size(w: int, h: int, multiply: float) -> tuple[int, int]:
    """Output size computation with the reference's float32 truncation
    (`libsrcnn.cpp:662-663`: ``unsigned rs_w = width * muliply`` in f32)."""
    rs_w = int(np.float32(w) * np.float32(multiply))
    rs_h = int(np.float32(h) * np.float32(multiply))
    return rs_w, rs_h
