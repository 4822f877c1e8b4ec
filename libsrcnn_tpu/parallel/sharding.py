"""GSPMD-annotated sharded pipelines (jit + NamedSharding).

Where :mod:`.halo` spells out the halo exchange by hand, this module takes
the idiomatic single-controller JAX route: annotate array shardings and let
XLA's SPMD partitioner insert the collectives -- including the halo
exchanges for spatially-partitioned convolutions.

* :func:`upscale_batch` -- data parallelism: a batch of same-sized frames
  (video / eval sets) sharded over the ``data`` mesh axis; each device runs
  the full per-frame pipeline locally, zero communication.
* :func:`upscale_spatial` -- one big frame with its H/W sharded over
  ``row``/``col``; XLA inserts conv halo collectives automatically.

The reference has no multi-image or multi-node story at all (SURVEY.md
section 2.9) -- frames would be processed one `ProcessSRCNN` call at a time.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SRCNNConfig
from ..ops import resize
from .. import pipeline


@functools.lru_cache(maxsize=64)
def _batch_fn(h, w, d, dst_h, dst_w, filter_type, use_pallas, mesh,
              model="srcnn", spec=None, compute_dtype="float32",
              lane_pack=False, ensemble=False):
    body = functools.partial(
        pipeline._single_pass, dst_h=dst_h, dst_w=dst_w,
        filter_type=filter_type, use_pallas=use_pallas,
        compute_dtype=compute_dtype, model=model, fsrcnn_spec=spec,
        lane_pack=lane_pack,
    )
    if ensemble:
        # flip self-ensemble per frame, inside the per-device shard: the
        # same vmapped 4-variant body as serve._ensemble_pass(batched=True),
        # so the sharded batch stays bit-identical to the unsharded one
        from .. import serve

        body = functools.partial(serve._ensemble_body, body=body)
    vbody = jax.vmap(body, in_axes=(0, None))
    # shard_map, not GSPMD annotations: each device runs the full per-frame
    # pipeline on its local batch shard (zero communication), which keeps
    # the fused kernel a plain per-device call -- the GSPMD partitioner
    # cannot split a pallas custom call, so an annotation-based version
    # could only honor use_pallas by replicating the batch.  (check_vma
    # off for the kernel: pallas_call outputs carry no varying-across-mesh
    # annotation.)
    smapped = shard_map(
        vbody, mesh=mesh,
        in_specs=(P("data", None, None, None), P()),
        out_specs=(P("data", None, None, None), P("data", None, None)),
        check_vma=not use_pallas,
    )
    return jax.jit(smapped)


def upscale_batch(images, params, multiply: float, cfg: SRCNNConfig, mesh: Mesh):
    """Upscale a [N, H, W, D] u8 batch, N sharded over the ``data`` axis.

    Returns (out [N,H',W',D] u8, conv [N,H',W'] u8).  N must divide by the
    data-axis size.  ``self_ensemble=True`` runs the vmapped 4-variant
    flip ensemble per frame inside each device's shard (bit-identical to
    the per-frame api ensemble).
    """
    if cfg.step_scale:
        raise ValueError(
            "step_scale is not supported by the GSPMD batch path (it runs "
            "one direct pass; silently skipping the chained-x2 u8 round "
            "trips would break bit-identity with api.upscale) -- chain "
            "upscale_batch calls per x2 pass instead")
    n, h, w, d = images.shape
    dp = mesh.shape["data"]
    if n % dp:
        raise ValueError(f"batch {n} not divisible by data axis {dp}")
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    params, spec = pipeline.prepare_model_params(cfg, params, h, w,
                                                 dst_h, dst_w, multiply)
    fn = _batch_fn(h, w, d, dst_h, dst_w, int(cfg.filter),
                   pipeline.resolve_pallas(cfg.use_pallas,
                                           cfg.compute_dtype), mesh,
                   cfg.model, spec, cfg.compute_dtype,
                   pipeline.resolve_lane_pack(cfg.lane_pack, cfg.model),
                   cfg.self_ensemble)
    return fn(images, params)


@functools.lru_cache(maxsize=64)
def _spatial_fn(h, w, d, dst_h, dst_w, filter_type, mesh,
                model="srcnn", spec=None, compute_dtype="float32",
                lane_pack=False):
    def body(img, params):
        out, conv = pipeline._single_pass(
            img, params, dst_h=dst_h, dst_w=dst_w,
            filter_type=filter_type, use_pallas=False,
            compute_dtype=compute_dtype, model=model, fsrcnn_spec=spec,
            lane_pack=lane_pack,
        )
        spatial = NamedSharding(mesh, P("row", "col"))
        out = jax.lax.with_sharding_constraint(
            out, NamedSharding(mesh, P("row", "col", None)))
        conv = jax.lax.with_sharding_constraint(conv, spatial)
        return out, conv

    img_sh = NamedSharding(mesh, P("row", "col", None))
    return jax.jit(body, in_shardings=(img_sh, None))


def upscale_spatial(image, params, multiply: float, cfg: SRCNNConfig, mesh: Mesh):
    """Upscale one [H, W, D] u8 frame with H/W sharded over ``row``/``col``;
    XLA GSPMD partitions the resize matmuls and convs, inserting halo
    collectives between the devices.

    This path always runs the XLA convolutions: the GSPMD partitioner
    cannot split a pallas custom call, so ``cfg.use_pallas=True`` is
    rejected rather than silently ignored.  For an explicitly tiled
    pipeline that runs the fused kernel per shard, use
    :func:`libsrcnn_tpu.parallel.tiled.upscale_tiled` (see PARITY.md for
    the measured comparison).

    Family models with ``lane_pack`` resolved on: GSPMD's partitioned
    reductions can flip u8 rounding ties vs the single-device result
    (<=1 LSB; the srcnn bit-identity invariant is unaffected -- srcnn
    never packs).
    """
    if cfg.self_ensemble:
        raise ValueError("self_ensemble is not implemented for the "
                         "GSPMD spatial path; ensemble per frame via "
                         "api.upscale")
    if cfg.use_pallas:
        raise ValueError(
            "upscale_spatial cannot honor use_pallas=True (GSPMD cannot "
            "partition a pallas call); use parallel.tiled.upscale_tiled "
            "for the fused-kernel multi-device path, or use_pallas=None.")
    if cfg.step_scale:
        raise ValueError(
            "step_scale is not supported by the GSPMD spatial path (it "
            "runs one direct pass; silently skipping the chained-x2 u8 "
            "round trips would break bit-identity with api.upscale) -- "
            "chain upscale_spatial calls per x2 pass instead")
    h, w, d = image.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    params, spec = pipeline.prepare_model_params(cfg, params, h, w,
                                                 dst_h, dst_w, multiply)
    fn = _spatial_fn(h, w, d, dst_h, dst_w, int(cfg.filter), mesh,
                     cfg.model, spec, cfg.compute_dtype,
                     pipeline.resolve_lane_pack(cfg.lane_pack, cfg.model))
    return fn(image, params)
