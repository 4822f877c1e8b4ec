"""Explicit spatial tiling with halo exchange (`shard_map` + `ppermute`).

The image analog of context/ring parallelism (SURVEY.md section 5): one
large Y plane is sharded over the mesh's ``row``/``col`` axes; each device
holds a tile and exchanges fixed-width halos with its neighbors before
each spatial conv.  Replicate padding is applied ONLY at true image edges
(a boundary tile pads with its own edge, which IS the global image edge)
-- interior tiles receive real neighbor pixels.

Two per-device bodies, both numerically identical to the single-device
forward at the same tier:

* **XLA body** (`_tile_forward`): two exchanges -- 4 px of the resized Y
  plane before the 9x9 conv1 (`libsrcnn.cpp:362-392`), then 2 px of the
  conv2 OUTPUT before the 5x5 conv3 (`libsrcnn.cpp:463-489`).  The second
  exchange exists because the reference replicate-pads conv2's *output*,
  which at true image edges is NOT the same as running conv1/2 over a
  wider input ring.
* **Fused-kernel body** (`_tile_forward_pallas`): ONE 6 px exchange, then
  the fused kernel; its edge flags apply the conv2-output clamp only on
  shards whose border is a true image edge, so the single exchange stays
  exact and moves 6 px of 1 plane instead of 4 px of 1 + 2 px of 32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

HALO1 = 4  # conv1 9x9
HALO3 = 2  # conv3 5x5


def _exchange(y: jnp.ndarray, halo: int, axis: int, axis_name: str) -> jnp.ndarray:
    """Concatenate neighbor halos (or replicated own edge at mesh
    boundaries) along `axis` of a local [H, W] or [H, W, C] tile."""
    n = lax.psum(1, axis_name)
    if n == 1:
        pad = [(0, 0)] * y.ndim
        pad[axis] = (halo, halo)
        return jnp.pad(y, pad, mode="edge")

    idx = lax.axis_index(axis_name)

    def take(arr, lo, hi):
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(lo, hi)
        return arr[tuple(sl)]

    size = y.shape[axis]
    # my high edge -> next neighbor's low halo; my low edge -> prev's high
    fwd = [(i, i + 1) for i in range(n - 1)]
    bwd = [(i + 1, i) for i in range(n - 1)]
    from_prev = lax.ppermute(take(y, size - halo, size), axis_name, fwd)
    from_next = lax.ppermute(take(y, 0, halo), axis_name, bwd)

    edge_lo = jnp.concatenate([take(y, 0, 1)] * halo, axis)
    edge_hi = jnp.concatenate([take(y, size - 1, size)] * halo, axis)

    lo_part = jnp.where(idx == 0, edge_lo, from_prev)
    hi_part = jnp.where(idx == n - 1, edge_hi, from_next)
    return jnp.concatenate([lo_part, y, hi_part], axis)


def _exchange2d(y: jnp.ndarray, halo: int, row_axis: str, col_axis: str) -> jnp.ndarray:
    y = _exchange(y, halo, 0, row_axis)
    return _exchange(y, halo, 1, col_axis)


def _tile_forward(params: dict, y: jnp.ndarray, row_axis: str, col_axis: str) -> jnp.ndarray:
    """Per-device body (XLA convs): halo-exchange + conv per stage."""
    from ..models.srcnn import _conv

    ext = _exchange2d(y, HALO1, row_axis, col_axis)
    x = ext[None, :, :, None]
    h1 = jnp.maximum(_conv(x, params["w1"]) + params["b1"], 0.0)
    h2 = jnp.maximum(_conv(h1, params["w2"]) + params["b2"], 0.0)
    # h2 is tile-exact; exchange conv2-output halos for the 5x5
    h2 = _exchange2d(h2[0], HALO3, row_axis, col_axis)[None]
    h3 = _conv(h2, params["w3"]) + params["b3"]
    return jnp.clip(h3[0, :, :, 0], 0.0, 255.0)


def _tile_forward_pallas(params: dict, y: jnp.ndarray, row_axis: str,
                         col_axis: str, tier: str) -> jnp.ndarray:
    """Per-device body (fused kernel): ONE 6 px Y-plane exchange, then
    the whole conv stack on-device.  The kernel's edge flags apply the
    reference's conv2-output clamp only where this shard's border is a
    TRUE image edge; interior shard rings keep the real neighbor pixels
    from the exchange, so the result is exact everywhere with a single
    exchange instead of two."""
    from ..kernels import fused_conv

    ext = _exchange2d(y, HALO1 + HALO3, row_axis, col_axis)
    ri = lax.axis_index(row_axis)
    ci = lax.axis_index(col_axis)
    rn = lax.psum(1, row_axis)
    cn = lax.psum(1, col_axis)
    flags = jnp.stack([
        (ri == 0), (ri == rn - 1), (ci == 0), (ci == cn - 1),
    ]).astype(jnp.int32)
    return fused_conv._fused(ext, params, flags, pad_mode="halo", tier=tier)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _run(params, y, mesh: Mesh, use_pallas: bool, tier: str = "float32"):
    spec = P("row", "col")
    if use_pallas:
        body = functools.partial(_tile_forward_pallas, row_axis="row",
                                 col_axis="col", tier=tier)
    else:
        body = functools.partial(_tile_forward, row_axis="row", col_axis="col")
    # check_vma off for the kernel body: pallas_call outputs carry no
    # varying-across-mesh annotation
    fn = shard_map(body, mesh=mesh, in_specs=(P(), spec), out_specs=spec,
                   check_vma=not use_pallas)
    return fn(params, y)


def forward_y_tiled(params: dict, y: jnp.ndarray, mesh: Mesh,
                    use_pallas: bool | None = None,
                    compute_dtype: str = "float32") -> jnp.ndarray:
    """SRCNN forward on one [H, W] Y plane spatially sharded over
    ``mesh`` axes ("row", "col").  H and W must divide by the respective
    axis sizes; tiles must be at least HALO1+HALO3 pixels.

    ``use_pallas=None`` auto-selects the fused per-device kernel on the
    GPU (:func:`libsrcnn_tpu.pipeline.resolve_pallas`).
    ``compute_dtype`` is the srcnn tier: ``float32`` (exact, either
    body), ``bfloat16`` or ``bfloat16_fast`` (fused-kernel body only).
    Per tier the partitioned result is bit-identical to the same tier's
    single-device :func:`libsrcnn_tpu.kernels.fused_conv.forward_y` (the
    per-pixel arithmetic does not depend on the tile grid).
    """
    from ..pipeline import resolve_pallas

    rows = mesh.shape["row"]
    cols = mesh.shape["col"]
    h, w = y.shape
    if h % rows or w % cols:
        raise ValueError(f"plane {h}x{w} not divisible by mesh {rows}x{cols}")
    if h // rows < HALO1 + HALO3 or w // cols < HALO1 + HALO3:
        raise ValueError(f"tile smaller than halo {HALO1 + HALO3}")
    use_pallas = resolve_pallas(use_pallas, compute_dtype)
    if compute_dtype != "float32" and not use_pallas:
        raise ValueError(
            "bf16 tiers on the halo path require the fused kernel (Pallas) "
            "body; the XLA body runs the exact HIGHEST convs only")
    y = jax.device_put(y, NamedSharding(mesh, P("row", "col")))
    return _run(params, y, mesh, use_pallas, compute_dtype)
