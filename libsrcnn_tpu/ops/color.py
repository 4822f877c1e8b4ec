"""Color-space conversion ops (JAX, runs on the device inside the jitted pipeline).

Numerics replicate the reference exactly:

* RGB(A) u8 -> planar float YCbCr uses the JPEG full-range coefficients in
  float32 (`libsrcnn.cpp:250-264`).
* YCbCr -> RGB(A) u8 uses the reference's *rational-approximation* inverse
  45/32, 11/32, 23/32, 113/64 (`libsrcnn.cpp:293-295`), NOT the exact
  coefficients -- the exact-coefficient variant ``ycbcr_to_rgb_exact``
  mirrors the (dead) `convertYCbCrtoImgU8` (`libsrcnn.cpp:310-346`) and is
  provided for completeness.
* u8 emission is MIN(255,.), MAX(0,.), then a C-style truncating cast
  (`libsrcnn.cpp:293-305`): floor for non-negative values.  XLA's
  ``convert_element_type`` rounds-to-nearest, so we floor explicitly.
"""

from __future__ import annotations

import jax.numpy as jnp


def trunc_u8(x: jnp.ndarray) -> jnp.ndarray:
    """MIN(255) / MAX(0) / truncating cast, as the reference emits u8."""
    x = jnp.maximum(jnp.minimum(x, 255.0), 0.0)
    return jnp.floor(x).astype(jnp.uint8)


def rgb_to_ycbcr(rgb_u8: jnp.ndarray) -> jnp.ndarray:
    """Interleaved u8 RGB(A) [H,W,D] -> planar float32 [D,H,W] YCbCr(+A).

    Mirrors `converImgU8toYCbCr` (`libsrcnn.cpp:233-272`).  D must be 3 or 4;
    the alpha plane (if any) is passed through as float.
    """
    f = rgb_u8.astype(jnp.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.1687 * r - 0.3313 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.4187 * g - 0.0813 * b
    planes = [y, cb, cr]
    if rgb_u8.shape[-1] == 4:
        planes.append(f[..., 3])
    return jnp.stack(planes, axis=0)


def ycbcr_to_rgb(planes: jnp.ndarray) -> jnp.ndarray:
    """Planar float32 [D,H,W] YCbCr(+A) -> interleaved u8 [H,W,D].

    Mirrors `convertImgF32XtoImgU8` (`libsrcnn.cpp:274-308`): the
    rational-approx inverse with [0,255] clamp and truncating cast.
    """
    y = planes[0]
    cb = planes[1] - 128.0
    cr = planes[2] - 128.0
    r = y + 45.0 * cr / 32.0
    g = y - (11.0 * cb + 23.0 * cr) / 32.0
    b = y + 113.0 * cb / 64.0
    chans = [trunc_u8(r), trunc_u8(g), trunc_u8(b)]
    if planes.shape[0] == 4:
        chans.append(trunc_u8(planes[3]))
    return jnp.stack(chans, axis=-1)


def ycbcr_to_rgb_exact(planes: jnp.ndarray) -> jnp.ndarray:
    """Exact-coefficient inverse, mirroring the unused `convertYCbCrtoImgU8`
    (`libsrcnn.cpp:310-346`).  Note the reference applies NO clamp there;
    we reproduce the raw truncating cast behavior modulo C's
    undefined-behavior wraparound (we clamp, which is the sane reading)."""
    y = planes[0]
    cb = planes[1]
    cr = planes[2]
    r = y + 1.402 * cr
    g = y - 0.34414 * cb - 0.71414 * cr
    b = y + 1.772 * cb
    chans = [trunc_u8(r), trunc_u8(g), trunc_u8(b)]
    if planes.shape[0] == 4:
        chans.append(trunc_u8(planes[3]))
    return jnp.stack(chans, axis=-1)
