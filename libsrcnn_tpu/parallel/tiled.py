"""Gigapixel tiled pipeline: the FULL upscale (color -> resize -> SRCNN ->
merge) spatially sharded over a device mesh with explicit halo exchange.

This is the framework's answer to "frames too large for one device"
(BASELINE.json config: gigapixel single image tiled across hosts).  Unlike
:mod:`.sharding`'s GSPMD path (XLA decides the collectives, XLA conv only),
everything here is explicit `shard_map`:

* color split / merge are elementwise -- no communication;
* the separable resize exchanges ``ceil(filter_support)+1`` source
  rows/cols per pass and applies the GLOBAL contribution tables sliced
  per shard (so boundary renormalization semantics are exactly the
  reference's, `frawscale.cpp:52-108`);
* the conv stack reuses the halo bodies (the fused kernel with edge-flag
  clamping, or the two-exchange XLA body).

Result is numerically identical to the single-device pipeline.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import FilterType, SRCNNConfig, chroma_filter
from ..ops import color
from ..ops.filters import FILTERS
from ..ops.weights_table import contribution_table
from . import halo as halo_mod


def _axis_halo(filter_type: FilterType, dst: int, src: int) -> int:
    """Source-pixel halo needed by one resize axis on interior shards."""
    _, fw = FILTERS[FilterType(filter_type)]
    scale = dst / src
    width = fw / scale if scale < 1.0 else fw
    return int(math.ceil(width)) + 1


def _band_tables(filter_type: FilterType, dst: int, src: int):
    left, w = contribution_table(filter_type, dst, src)
    return left.astype(np.int32), w.astype(np.float32)


def _resize_axis_sharded(plane, left_l, w_l, halo: int, axis: int,
                         axis_name: str, src_local: int):
    """Per-shard band resize along `axis` with exchanged halos and the
    global table rows/cols for this shard (indices converted to local)."""
    ext = halo_mod._exchange(plane, halo, axis, axis_name)
    base = lax.axis_index(axis_name) * src_local - halo
    left_local = left_l - base
    kdim = w_l.shape[1]
    acc = None
    for k in range(kdim):
        idx = jnp.clip(left_local + k, 0, ext.shape[axis] - 1)
        g = jnp.take(ext, idx, axis=axis)
        wk = w_l[:, k]
        wk = wk[:, None] if axis == 0 else wk[None, :]
        term = g * wk
        acc = term if acc is None else acc + term
    return acc


@functools.partial(jax.jit, static_argnames=(
    "dst_h", "dst_w", "filter_type", "use_pallas", "mesh",
    "precision", "model", "spec", "model_halo"))
def _run_tiled(img, params, row_tabs, col_tabs, *, dst_h, dst_w, filter_type,
               use_pallas, mesh: Mesh, precision=None,
               model: str = "srcnn", spec=None, model_halo: int = 0):
    h, w, d = img.shape
    rows, cols = mesh.shape["row"], mesh.shape["col"]
    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)
    up_width = dst_w > w  # reference pass ordering (`frawscale.cpp:195-278`)

    def body(img_l, params, rt_y, wt_y, rt_c, wt_c, ct_y, cwt_y, ct_c, cwt_c):
        planes = color.rgb_to_ycbcr(img_l)          # [D, hl, wl]
        src_hl, src_wl = planes.shape[1], planes.shape[2]

        def one(plane, lv, wv, hv, lh, wh, hh):
            # reference skips an axis whose size is unchanged
            # (`frawscale.cpp:195-278`): applying a scale-1 table would
            # blur under non-interpolating filters like Mitchell bicubic.
            v = (functools.partial(_resize_axis_sharded, left_l=lv, w_l=wv,
                                   halo=hv, axis=0, axis_name="row",
                                   src_local=src_hl)
                 if dst_h != h else (lambda p: p))
            z = (functools.partial(_resize_axis_sharded, left_l=lh, w_l=wh,
                                   halo=hh, axis=1, axis_name="col",
                                   src_local=src_wl)
                 if dst_w != w else (lambda p: p))
            if up_width:
                return z(v(plane))
            return v(z(plane))

        hv_y = _axis_halo(y_filter, dst_h, h)
        hh_y = _axis_halo(y_filter, dst_w, w)
        hv_c = _axis_halo(c_filter, dst_h, h)
        hh_c = _axis_halo(c_filter, dst_w, w)

        from .. import pipeline as _pipeline

        lr_family = model in _pipeline.LR_FAMILIES
        if not lr_family:  # LR stacks consume the raw Y plane directly
            y_r = one(planes[0], rt_y, wt_y, hv_y, ct_y, cwt_y, hh_y)
        rest = [one(planes[c], rt_c, wt_c, hv_c, ct_c, cwt_c, hh_c)
                for c in range(1, d)]

        if model != "srcnn":
            # Learned family: ONE 2-D halo exchange of `model_halo` REAL
            # neighbor pixels (HR families: output-domain px on the
            # resized plane; LR families: LR px on the raw Y plane),
            # then the flag-gated halo forward -- true-edge shards
            # re-impose the stack's own per-layer padding on the
            # out-of-image ring, interior shards keep exchanged pixels;
            # LR shards additionally crop the halo's output rows/cols.
            mod = _pipeline._lr_family(model)
            src_plane = planes[0] if lr_family else y_r
            ext = halo_mod._exchange2d(src_plane, model_halo, "row", "col")
            ri = lax.axis_index("row")
            ci = lax.axis_index("col")
            rn = lax.psum(1, "row")
            cn = lax.psum(1, "col")
            flags = jnp.stack([
                (ri == 0), (ri == rn - 1), (ci == 0), (ci == cn - 1),
            ]).astype(jnp.int32)
            prec = (jax.lax.Precision.HIGHEST if precision is None
                    else precision)
            fwd = mod.forward_lr_halo if lr_family else mod.forward_hr_halo
            y_sr = fwd(params, ext, flags, spec, halo=model_halo,
                       precision=prec)
        elif use_pallas:
            y_sr = halo_mod._tile_forward_pallas(
                params, y_r, "row", "col", tier=precision)
        else:
            y_sr = halo_mod._tile_forward(params, y_r, "row", "col")

        merged = jnp.stack([y_sr, *rest], axis=0)
        out_u8 = color.ycbcr_to_rgb(merged)
        conv_u8 = jnp.floor(y_sr).astype(jnp.uint8)
        return out_u8, conv_u8

    spec_img = P("row", "col", None)
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(spec_img, P(),
                  P("row"), P("row"), P("row"), P("row"),
                  P("col"), P("col"), P("col"), P("col")),
        out_specs=(P("row", "col", None), P("row", "col")),
        check_vma=False,
    )
    rt_y, wt_y, ct_y, cwt_y = row_tabs[0], row_tabs[1], col_tabs[0], col_tabs[1]
    rt_c, wt_c, ct_c, cwt_c = row_tabs[2], row_tabs[3], col_tabs[2], col_tabs[3]
    return fn(img, params, rt_y, wt_y, rt_c, wt_c, ct_y, cwt_y, ct_c, cwt_c)


def upscale_tiled(image, params, multiply: float, cfg: SRCNNConfig,
                  mesh: Mesh):
    """Full upscale of one [H, W, D] u8 frame spatially sharded over the
    mesh ("row", "col") with explicit halo exchange at every stage.

    Constraints: H, W and the output H', W' must divide by the respective
    mesh axis sizes, and per-shard tiles must exceed the halo widths.
    Returns (out_u8 [H', W', D], conv_u8 [H', W']) with values identical to
    the single-device pipeline AT THE SAME COMPUTE TIER: float32 (exact,
    default), or -- fused-kernel body only -- the bfloat16 / bfloat16_fast
    tiers (the per-pixel arithmetic does not depend on the tile grid, so
    each tier stays bit-identical to its single-device twin).

    Models: srcnn (fused-kernel / XLA per-device bodies, halo plan 4+2
    px with the conv2-ring quirk), the HR families (vdsr/srcnn955 --
    direct XLA convs, halo derived from the spec via
    ``<family>.halo_width``), and the LR families (fsrcnn/espcn --
    shards exchange ``<family>.lr_halo_width`` REAL LR pixels, true-edge
    shards re-impose the stack's replicate padding on the out-of-image ring
    per layer, and each shard crops the halo's output; exact-scale
    contract, H/W constraints in LR pixels).  All learned families run
    float32/bfloat16 tiers; bit-identity is vs the api with
    ``lane_pack=False``.

    ``self_ensemble=True`` composes the flip ensemble over four tiled
    passes (:func:`_tiled_ensemble`), bitwise equal to the api-level
    ensemble; returns numpy arrays in that case.
    """
    from ..ops.resize import scaled_size
    from .. import pipeline as _pipeline
    from ..pipeline import resolve_pallas

    if cfg.self_ensemble:
        return _tiled_ensemble(image, params, multiply, cfg, mesh)
    if cfg.step_scale:
        raise ValueError(
            "step_scale is not supported by the tiled path (it runs one "
            "direct pass; silently skipping the chained-x2 u8 round trips "
            "would break bit-identity with api.upscale) -- chain "
            "upscale_tiled calls per x2 pass instead")
    if cfg.lane_pack:
        # shards run the LR stacks unpacked (bit-identity contract above
        # is vs lane_pack=False); reject an explicit True like step_scale
        raise ValueError("lane_pack=True is not supported by the tiled "
                         "path (shards run the LR stacks unpacked; leave "
                         "lane_pack unset/False)")
    spec, model_halo = None, 0
    if cfg.model == "srcnn":
        use_pallas = resolve_pallas(cfg.use_pallas, cfg.compute_dtype)
        if not (cfg.compute_dtype == "float32"
                or (use_pallas and cfg.compute_dtype != "int8")):
            raise ValueError(
                "the tiled path's srcnn conv tiers are float32 (exact, XLA "
                "or fused-kernel body) and bfloat16/bfloat16_fast (fused "
                f"kernel only) -- got compute_dtype={cfg.compute_dtype!r} "
                f"with use_pallas={cfg.use_pallas!r}; use single-device or "
                "upscale_batch for other tiers")
        # the srcnn shard body takes the tier name; the XLA body is exact
        precision = cfg.compute_dtype
    elif cfg.model in _pipeline.HR_FAMILIES:
        precision = _pipeline.family_precision(cfg.compute_dtype)
        use_pallas = False
        mod = _pipeline._lr_family(cfg.model)
        spec = params.get("__spec__") or mod.default_spec()
        params = {k: v for k, v in params.items() if k != "__spec__"}
        model_halo = mod.halo_width(spec)
    elif cfg.model in _pipeline.LR_FAMILIES:
        precision = _pipeline.family_precision(cfg.compute_dtype)
        use_pallas = False
        mod = _pipeline._lr_family(cfg.model)
        spec = params.get("__spec__") or mod.default_spec()
        params = {k: v for k, v in params.items() if k != "__spec__"}
        model_halo = mod.lr_halo_width(spec, params)
    else:
        raise ValueError(f"unknown model {cfg.model!r}")
    h, w, d = image.shape
    rows, cols = mesh.shape["row"], mesh.shape["col"]
    dst_w, dst_h = scaled_size(w, h, multiply)
    if cfg.model in _pipeline.LR_FAMILIES:
        r = spec.scale
        if (dst_h, dst_w) != (h * r, w * r):
            raise ValueError(
                f"{cfg.model} x{r} weights require scale {r} exactly; "
                f"got {multiply} ({w}x{h} -> {dst_w}x{dst_h})")
    for name, size, parts in (("H", h, rows), ("W", w, cols),
                              ("H'", dst_h, rows), ("W'", dst_w, cols)):
        if size % parts:
            raise ValueError(f"{name}={size} not divisible by mesh axis {parts}")
    if model_halo:
        # HR families: halo counted in OUTPUT px; LR families: in LR px
        th_, tw_ = ((h // rows, w // cols)
                    if cfg.model in _pipeline.LR_FAMILIES
                    else (dst_h // rows, dst_w // cols))
        if th_ < model_halo or tw_ < model_halo:
            raise ValueError(
                f"per-shard tile {th_}x{tw_} smaller than "
                f"the {cfg.model} halo {model_halo}")

    y_filter = FilterType(cfg.filter)
    c_filter = chroma_filter(y_filter)
    rt_y, wt_y = _band_tables(y_filter, dst_h, h)
    ct_y, cwt_y = _band_tables(y_filter, dst_w, w)
    rt_c, wt_c = _band_tables(c_filter, dst_h, h)
    ct_c, cwt_c = _band_tables(c_filter, dst_w, w)

    sh = NamedSharding(mesh, P("row", "col", None))
    image = jax.device_put(jnp.asarray(image), sh)
    row_tabs = tuple(jax.device_put(jnp.asarray(t), NamedSharding(mesh, P("row")))
                     for t in (rt_y, wt_y, rt_c, wt_c))
    col_tabs = tuple(jax.device_put(jnp.asarray(t), NamedSharding(mesh, P("col")))
                     for t in (ct_y, cwt_y, ct_c, cwt_c))
    return _run_tiled(
        image, params, row_tabs, col_tabs,
        dst_h=dst_h, dst_w=dst_w, filter_type=int(cfg.filter),
        use_pallas=use_pallas, mesh=mesh,
        precision=precision, model=cfg.model, spec=spec,
        model_halo=model_halo)


def _tiled_ensemble(image, params, multiply: float, cfg: SRCNNConfig,
                    mesh: Mesh):
    """Flip self-ensemble over the tiled path: four plain tiled passes on
    the flip variants, unflipped and mean-reduced host-side exactly as
    serve._ensemble_body does (f32 mean of the four u8 outputs,
    round-half-even) -- so the result is bitwise the api-level ensemble
    wherever the per-variant tiled pass is bit-identical to the api
    (i.e. everywhere the plain tiled invariant holds).  Returns numpy
    arrays.
    """
    import dataclasses

    base = dataclasses.replace(cfg, self_ensemble=False)
    image = np.asarray(image)
    acc_o = acc_c = None
    for fy, fx in ((False, False), (False, True), (True, False),
                   (True, True)):
        v = np.ascontiguousarray(image[::-1 if fy else 1,
                                       ::-1 if fx else 1])
        out, conv = upscale_tiled(v, params, multiply, base, mesh)
        o = np.asarray(out)[::-1 if fy else 1, ::-1 if fx else 1]
        c = np.asarray(conv)[::-1 if fy else 1, ::-1 if fx else 1]
        acc_o = o.astype(np.float32) if acc_o is None else acc_o + o
        acc_c = c.astype(np.float32) if acc_c is None else acc_c + c
    return (np.rint(acc_o / 4.0).astype(np.uint8),
            np.rint(acc_c / 4.0).astype(np.uint8))
