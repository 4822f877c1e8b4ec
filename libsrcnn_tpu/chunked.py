"""Out-of-core gigapixel upscaling on ONE device: stream output-row bands.

The reference is O(W·H) single-node and simply dies on frames whose float
planes exceed RAM (SURVEY.md section 5's "long-context analog").  The
framework's multi-chip answer is :func:`libsrcnn_tpu.parallel.upscale_tiled`
(spatial shards + halo exchange); THIS module is the single-device
leg of the same size-scaling story: the image never exists on the device
(or in host f32) at once.  The host streams horizontal output bands --
u8 source rows up, u8 result rows back -- and every intermediate lives
only at band height, so peak device memory is O(band) instead of O(image).

Exactness is the design constraint (same bar as the tiled path): each
band is computed from the GLOBAL contribution tables sliced to its rows
(boundary renormalization semantics stay exactly the reference's,
`frawscale.cpp:52-108`), the conv stack reads a band halo of REAL
neighbor rows (replicated rows only at true image edges, via the same
table-row replication trick as ops.resize.resize_plane_padded), and the
model's edge semantics are gated by per-band edge flags.  Result:
bit-identical to :func:`libsrcnn_tpu.api.upscale` at the same compute
tier.

Three model kinds, three halo plans -- all DERIVED, not assumed:

* **srcnn** (9-1-5): 6-px halo (4 conv1 + 2 conv3) and the reference's
  conv2-OUTPUT border replication quirk (`libsrcnn.cpp:463-489`), gated
  by edge flags -- the same mechanism as parallel/halo.py, driven
  sequentially instead of by ppermute.
* **HR families** (vdsr/srcnn955, per-layer replicate-padded stacks):
  halo = stack receptive radius (``<family>.halo_width(spec)``); at true
  image edges the per-layer replicate padding is re-imposed before every
  conv (``forward_hr_halo``), interior band borders keep real neighbor
  rows.  Direct (non-lane-packed) convs: the packed formulation's
  reduction order is plane-shape-dependent, so only the direct stack can
  be bit-identical between a band and the full frame.
* **LR families** (fsrcnn/espcn, replicate-pad SAME stacks + learned
  upscale): bands are cut on whole LR rows, extended by
  ``<family>.lr_halo_width(spec)`` REAL neighbor LR rows (clamped at
  true edges), run through the unmodified ``forward_lr``, and the halo's
  output rows are cropped.  No edge-flag machinery is needed: every kept
  output row's receptive field either lies inside the slice's real rows
  or reaches a TRUE image edge -- where the slice border IS the image
  border, so the stack's own replicate padding applies exactly as in the full
  frame.

One program compiles per band SHAPE (interior bands share one; a ragged
last band adds one more): the vertical band tables are passed as device
arguments, not baked into the trace.

``self_ensemble=True`` composes the flip self-ensemble BAND-WISE: for
each output band, the four flip variants' corresponding bands are
dispatched (the flipped image's band ranges are the mirrored plan --
the cut rules are mirror-symmetric), unflipped, and averaged exactly as
the api-level ensemble does (f32 mean of the four u8 outputs,
round-half-even) -- so peak memory stays O(band) while matching
:func:`libsrcnn_tpu.api.upscale` with ``self_ensemble=True`` bitwise.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .config import FilterType, SRCNNConfig, DEFAULT_CONFIG, chroma_filter
from .ops import color, resize
from .ops.weights_table import contribution_table

#: srcnn conv stack halo: 4 (conv1 9x9) + 2 (conv3 5x5) -- parallel/halo.py
CONV_HALO = 6


def _global_band_tables(filter_type: FilterType, dst: int, src: int):
    """Full-plane vertical gather tables in band form: clipped source
    indices [dst, K] + f32 weights, with the all-zero tap columns dropped
    exactly as ops.resize._resize_axis drops them (so per-row arithmetic
    -- term order included -- is identical to the single-pass resize).
    ``dst == src`` degenerates to the K=1 identity table (multiply by
    1.0), which is bitwise the no-op the full resize performs."""
    if dst == src:
        idx = np.arange(src, dtype=np.int64)[:, None]
        return idx, np.ones((src, 1), np.float32)
    left, w = contribution_table(filter_type, dst, src)
    k_all = w.shape[1]
    idx = np.clip(left[:, None] + np.arange(k_all)[None, :], 0, src - 1)
    keep = [k for k in range(k_all) if np.any(w[:, k])]
    return idx[:, keep].astype(np.int64), w[:, keep].astype(np.float32)


def _apply_band_axis0(plane, idx, w):
    """Vertical band gather with RUNTIME tables: emit len(idx) rows of
    the globally-resized plane.  Same k-order accumulation as
    ops.resize._resize_axis."""
    acc = None
    for k in range(w.shape[1]):
        g = jnp.take(plane, idx[:, k], axis=0)
        term = g * w[:, k][:, None]
        acc = term if acc is None else acc + term
    return acc


def _xla_halo_forward(params, ext, flags, bh: int, dst_w: int):
    """Exact-tier srcnn conv stack on a pre-haloed band ([bh+12, dst_w+12]
    -> [bh, dst_w]): XLA twin of the fused kernel's pad_mode="halo" call.
    The conv2-output ring is replaced by the edge value only where the
    band border is a TRUE image edge (flags [top, bottom]; columns are
    always true edges here -- bands span the full width)."""
    from .models.srcnn import _conv

    x = ext[None, :, :, None]
    h1 = jnp.maximum(_conv(x, params["w1"]) + params["b1"], 0.0)
    h2 = jnp.maximum(_conv(h1, params["w2"]) + params["b2"], 0.0)
    # h2 rows cover band rows -2..bh+1, cols -2..dst_w+1
    ri = jnp.arange(bh + 4)[None, :, None, None]
    ci = jnp.arange(dst_w + 4)[None, None, :, None]
    h2 = jnp.where((flags[0] == 1) & (ri < 2), h2[:, 2:3], h2)
    h2 = jnp.where((flags[1] == 1) & (ri > bh + 1), h2[:, bh + 1:bh + 2], h2)
    h2 = jnp.where(ci < 2, h2[:, :, 2:3], h2)
    h2 = jnp.where(ci > dst_w + 1, h2[:, :, dst_w + 1:dst_w + 2], h2)
    h3 = _conv(h2, params["w3"]) + params["b3"]
    return jnp.clip(h3[0, :, :, 0], 0.0, 255.0)


@functools.lru_cache(maxsize=64)
def _compiled_band(d: int, s_rows: int, src_w: int, bh: int, dst_w: int,
                   filter_type: int, use_pallas: bool, precision,
                   model: str = "srcnn", spec=None,
                   halo: int = CONV_HALO):
    """One jitted band program; interior bands of equal height share it."""
    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)
    up_width = dst_w > src_w

    def body(band_u8, params, vy_idx, vy_w, vc_idx, vc_w, flags):
        planes = color.rgb_to_ycbcr(band_u8)      # [D, s_rows, src_w]

        if model == "srcnn":
            # Y: vertical band (+halo rows) and horizontal with the
            # kernel's column padding, in the reference's pass order
            if up_width:
                yb = _apply_band_axis0(planes[0], vy_idx, vy_w)
                yb = resize._resize_axis_padded(yb, dst_w, y_filter, 1,
                                                halo, dst_w + 2 * halo)
            else:
                yh = resize._resize_axis_padded(planes[0], dst_w, y_filter,
                                                1, halo, dst_w + 2 * halo)
                yb = _apply_band_axis0(yh, vy_idx, vy_w)
        else:
            # HR family: resize the band, then replicate the column halo
            # (bands span the full width, so columns are true edges --
            # per-layer padding is re-imposed by forward_hr_halo)
            if up_width:
                yb = _apply_band_axis0(planes[0], vy_idx, vy_w)
                yb = resize._resize_axis(yb, dst_w, y_filter, 1)
            else:
                yh = resize._resize_axis(planes[0], dst_w, y_filter, 1)
                yb = _apply_band_axis0(yh, vy_idx, vy_w)
            yb = jnp.pad(yb, ((0, 0), (halo, halo)), mode="edge")

        rest = []
        for c in range(1, d):
            if up_width:
                pb = _apply_band_axis0(planes[c], vc_idx, vc_w)
                pb = resize._resize_axis(pb, dst_w, c_filter, 1)
            else:
                ph = resize._resize_axis(planes[c], dst_w, c_filter, 1)
                pb = _apply_band_axis0(ph, vc_idx, vc_w)
            rest.append(pb)

        if model != "srcnn":
            from . import pipeline as _pipeline

            mod = _pipeline._lr_family(model)
            y_sr = mod.forward_hr_halo(params, yb, flags, spec, halo=halo,
                                       precision=precision)
        elif use_pallas:
            from .kernels import fused_conv

            y_sr = fused_conv._fused(yb, params, flags, pad_mode="halo",
                                     tier=precision)
        else:
            y_sr = _xla_halo_forward(params, yb, flags, bh, dst_w)

        merged = jnp.stack([y_sr, *rest], axis=0)
        out_u8 = color.ycbcr_to_rgb(merged)
        conv_u8 = jnp.floor(y_sr).astype(jnp.uint8)
        return out_u8, conv_u8

    return jax.jit(body)


def _bands_from_edges_lr(edges, halo: int, r: int, src_h: int, gc_idx):
    """LR-family band plan entries: output band [r0, r1) (both multiples
    of the scale ``r``), its LR Y window [ys0, ys1) (the band's own LR
    rows extended by up to ``halo`` REAL neighbor rows, clamped at the
    true edges -- where the model's own replicate padding must apply, exactly
    as it does in the full frame), the chroma output rows, and the u8
    source-row window covering both."""
    bands = []
    for r0, r1 in zip(edges[:-1], edges[1:]):
        ys0 = max(0, r0 // r - halo)
        ys1 = min(src_h, r1 // r + halo)
        rows_c = np.arange(r0, r1)
        ic = gc_idx[rows_c]
        smin = int(min(ys0, ic.min()))
        smax = int(max(ys1, ic.max() + 1))
        bands.append((r0, r1, ys0, ys1, rows_c, smin, smax))
    return bands


@functools.lru_cache(maxsize=64)
def _compiled_band_lr(d: int, s_rows: int, src_w: int, bh: int,
                      filter_type: int, precision, model: str, spec,
                      y_len: int, crop_top: int):
    """One jitted LR-family band program.  The Y slice geometry
    (``y_len`` LR rows, crop ``crop_top`` LR rows of output off the top)
    is static; interior bands share one program, the first/last bands
    (clamped halo) add one each."""
    from . import pipeline as _pipeline

    mod = _pipeline._lr_family(model)
    c_filter = chroma_filter(FilterType(filter_type))
    r = spec.scale
    dst_w = src_w * r

    def body(band_u8, params, y_idx, vc_idx, vc_w):
        planes = color.rgb_to_ycbcr(band_u8)      # [D, s_rows, src_w]
        # REAL LR rows (band + halo); the stack's replicate padding applies
        # only at the slice borders, and every output row kept below has
        # its full receptive field inside the slice -- or reaches the
        # TRUE image edge, where the full frame replicate-pads identically
        y_lr = jnp.take(planes[0], y_idx, axis=0)  # [y_len, src_w]
        sr = mod.forward_lr(params, y_lr, spec, precision=precision,
                            lane_pack=False)       # [y_len*r, dst_w]
        y_sr = jax.lax.slice_in_dim(sr, crop_top * r, crop_top * r + bh,
                                    axis=0)
        rest = []
        for c in range(1, d):
            pb = _apply_band_axis0(planes[c], vc_idx, vc_w)
            pb = resize._resize_axis(pb, dst_w, c_filter, 1)
            rest.append(pb)
        merged = jnp.stack([y_sr, *rest], axis=0)
        out_u8 = color.ycbcr_to_rgb(merged)
        conv_u8 = jnp.floor(y_sr).astype(jnp.uint8)
        return out_u8, conv_u8

    return jax.jit(body)


def _dispatch_band_lr(image, band, params, gc_idx, gc_w, s_rows: int,
                      d: int, src_w: int, cfg: SRCNNConfig, precision,
                      spec):
    """LR-family twin of :func:`_dispatch_band`."""
    r0, r1, ys0, ys1, rows_c, smin, smax = band
    src = np.ascontiguousarray(image[smin:smax])
    if src.shape[0] < s_rows:               # equalize the compiled shape
        src = np.pad(src, ((0, s_rows - src.shape[0]), (0, 0), (0, 0)),
                     mode="edge")
    y_idx = jnp.asarray(np.arange(ys0, ys1) - smin, jnp.int32)
    vc_idx = jnp.asarray(gc_idx[rows_c] - smin, jnp.int32)
    vc_w = jnp.asarray(gc_w[rows_c])
    crop_top = r0 // spec.scale - ys0
    fn = _compiled_band_lr(d, s_rows, src_w, r1 - r0, int(cfg.filter),
                           precision, cfg.model, spec, ys1 - ys0, crop_top)
    return fn(jnp.asarray(src), params, y_idx, vc_idx, vc_w)


def _cut_ok(r: int, dst_h: int, halo: int, model: str) -> bool:
    """May a band boundary sit at output row ``r``?

    srcnn: no cut at row 1 or dst_h-1 -- the conv2-output ring is +-2
    rows, so a band starting at row 1 (or ending at dst_h-1) has a ring
    row beyond the TRUE image edge while its edge flag is off, and a
    replicated-input ring is not the reference's replicated-conv2-output
    ring (`libsrcnn.cpp:463-489`).

    HR families: every cut must be >= halo away from the true edges --
    a band whose halo rows cross the image edge WITHOUT its edge flag
    set would fill them with replicated input, which is not the model's
    per-layer replicate padding.  (Both rules are mirror-symmetric in
    r <-> dst_h - r, which the band-wise flip ensemble relies on.)
    """
    if model == "srcnn":
        return r != 1 and r != dst_h - 1
    return halo <= r <= dst_h - halo


def _bands_from_edges(edges, halo: int, dst_h: int, gy_idx, gc_idx):
    bands = []
    for r0, r1 in zip(edges[:-1], edges[1:]):
        rows_y = np.clip(np.arange(r0 - halo, r1 + halo), 0, dst_h - 1)
        rows_c = np.arange(r0, r1)
        iy = gy_idx[rows_y]
        ic = gc_idx[rows_c]
        smin = int(min(iy.min(), ic.min()))
        smax = int(max(iy.max(), ic.max())) + 1
        bands.append((r0, r1, rows_y, rows_c, smin, smax))
    return bands


def _plan_bands(dst_h: int, band_rows: int, halo: int, model: str,
                gy_idx, gc_idx):
    """Band plan: per band, the Y rows (+halo) and chroma rows pull from
    a source-row window; all interior bands share one padded window
    height.  Cuts violating the model's edge rule (see :func:`_cut_ok`)
    are dropped, merging the offending band into its neighbor."""
    cuts = [r for r in range(band_rows, dst_h, band_rows)
            if _cut_ok(r, dst_h, halo, model)]
    return cuts, _bands_from_edges([0] + cuts + [dst_h], halo, dst_h,
                                   gy_idx, gc_idx)


def _resolve_chunked(cfg: SRCNNConfig, multiply: float,
                     params: dict | None):
    """Shared validation/resolution for the chunked paths: returns
    (params-on-device, spec, halo, use_pallas, precision)."""
    from . import pipeline as _pipeline

    if cfg.step_scale:
        raise ValueError("step_scale is not supported by the chunked path "
                         "(one direct pass; chain calls per x2 pass)")
    if cfg.lane_pack:
        # the band programs run the LR stacks unpacked (lane_pack=False)
        # so bands stay bit-identical to the unpacked one-shot path;
        # honoring an explicit lane_pack=True here would silently change
        # the reduction partitioning mid-path -- reject like step_scale
        raise ValueError("lane_pack=True is not supported by the chunked "
                         "path (bands run the LR stacks unpacked; leave "
                         "lane_pack unset/False)")
    if params is None:
        params = _pipeline.load_model_params(cfg, multiply)

    if cfg.model == "srcnn":
        _pipeline.validate_compute_dtype(cfg)
        use_pallas = _pipeline.resolve_pallas(cfg.use_pallas,
                                              cfg.compute_dtype)
        if not (cfg.compute_dtype == "float32"
                or (use_pallas and cfg.compute_dtype != "int8")):
            raise ValueError(
                f"the chunked path's srcnn conv tiers are float32 (XLA or "
                f"fused-kernel body) and bfloat16/bfloat16_fast (fused "
                f"kernel only) -- got compute_dtype={cfg.compute_dtype!r} "
                f"with use_pallas={cfg.use_pallas!r}")
        # the srcnn band body takes the tier name; the XLA body is exact
        precision = cfg.compute_dtype
        spec, halo = None, CONV_HALO
    elif cfg.model in _pipeline.HR_FAMILIES:
        # XLA direct convs at the family tier (float32 exact / bfloat16)
        precision = _pipeline.family_precision(cfg.compute_dtype)
        use_pallas = False
        mod = _pipeline._lr_family(cfg.model)
        spec = params.get("__spec__") or mod.default_spec()
        halo = mod.halo_width(spec)
    elif cfg.model in _pipeline.LR_FAMILIES:
        # LR-domain stacks: the halo is counted in LR rows and the edge
        # story is crop-after-halo-extend (see upscale_chunked docstring)
        precision = _pipeline.family_precision(cfg.compute_dtype)
        use_pallas = False
        mod = _pipeline._lr_family(cfg.model)
        spec = params.get("__spec__") or mod.default_spec()
        halo = mod.lr_halo_width(spec, params)
    else:
        raise ValueError(f"unknown model {cfg.model!r}")

    params = jax.device_put(
        {k: v for k, v in params.items() if k != "__spec__"})
    return params, spec, halo, use_pallas, precision


def upscale_chunked(image, multiply: float, cfg: SRCNNConfig = DEFAULT_CONFIG,
                    *, band_rows: int = 512, params: dict | None = None,
                    inflight_bands: int = 2):
    """Full upscale of one [H, W, D] u8 frame streamed through the device
    in horizontal output bands of ``band_rows`` rows.

    Returns host numpy ``(out_u8 [H', W', D], conv_u8 [H', W'])``,
    bit-identical to :func:`libsrcnn_tpu.api.upscale` at the same compute
    tier; peak device memory is O(inflight_bands x band_rows x W'),
    independent of H.

    ``inflight_bands`` bounds the dispatch window: JAX dispatch is async,
    so keeping a few bands in flight overlaps band k's device compute
    with band k-1's device->host fetch and band k+1's host-side slice
    (the fetch is the only blocking call in the loop).  1 = fully
    serial; the default 2 double-buffers.

    Models: srcnn (fused kernel / XLA; float32 + the two bf16 tiers, which
    need the fused kernel -- int8 is one-shot only), the HR families
    (vdsr/srcnn955 -- direct XLA convs, float32/bfloat16 tiers, halo
    derived from the spec), and the LR families (fsrcnn/espcn -- bands
    cut on whole LR rows, crop-after-halo-extend, exact-scale contract
    as everywhere).  For every learned family, bit-identity is vs the
    api with ``lane_pack=False``.  No step_scale (chain calls per x2
    pass, as with the tiled path);
    ``self_ensemble=True`` runs the band-wise flip ensemble (4x compute,
    still O(band) memory, bitwise equal to the api-level ensemble).
    """
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[-1] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] u8 image, got {image.shape}")
    h, w, d = image.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    if band_rows < 1:
        raise ValueError("band_rows must be >= 1")
    if inflight_bands < 1:
        raise ValueError("inflight_bands must be >= 1")

    params, spec, halo, use_pallas, precision = _resolve_chunked(
        cfg, multiply, params)

    y_filter = FilterType(cfg.filter)
    c_filter = chroma_filter(y_filter)
    gc_idx, gc_w = _global_band_tables(c_filter, dst_h, h)
    from . import pipeline as _pipeline

    if cfg.model in _pipeline.LR_FAMILIES:
        r = spec.scale
        if (dst_h, dst_w) != (h * r, w * r):
            raise ValueError(
                f"{cfg.model} x{r} weights require scale {r} exactly; "
                f"got {multiply} ({w}x{h} -> {dst_w}x{dst_h})")
        # band boundaries must sit on whole LR rows (each LR row emits
        # exactly r output rows through the learned upscale head)
        br = max(r, band_rows // r * r)
        cuts = list(range(br, dst_h, br))
        bands = _bands_from_edges_lr([0] + cuts + [dst_h], halo, r, h,
                                     gc_idx)
        plans = [bands]
        if cfg.self_ensemble:
            # mirrored cuts stay r-aligned: dst_h = r*h
            m_edges = [0] + [dst_h - c for c in reversed(cuts)] + [dst_h]
            plans.append(_bands_from_edges_lr(m_edges, halo, r, h, gc_idx))
        s_rows = max(smax - smin for plan in plans for *_, smin, smax in plan)

        def dispatch(img_v, band):
            return _dispatch_band_lr(img_v, band, params, gc_idx, gc_w,
                                     s_rows, d, w, cfg, precision, spec)
    else:
        gy_idx, gy_w = _global_band_tables(y_filter, dst_h, h)
        cuts, bands = _plan_bands(dst_h, band_rows, halo, cfg.model,
                                  gy_idx, gc_idx)
        plans = [bands]
        if cfg.self_ensemble:
            # flipped geometry: the MIRRORED cuts (valid: both cut rules
            # are mirror-symmetric), windows recomputed from the same
            # tables
            m_edges = [0] + [dst_h - c for c in reversed(cuts)] + [dst_h]
            plans.append(_bands_from_edges(m_edges, halo, dst_h, gy_idx,
                                           gc_idx))
        s_rows = max(smax - smin for plan in plans for *_, smin, smax in plan)
        def dispatch(img_v, band):
            return _dispatch_band(img_v, band, params, gy_idx, gy_w,
                                  gc_idx, gc_w, s_rows, dst_h, d, w, dst_w,
                                  cfg, use_pallas, precision,
                                  spec, halo)

    if cfg.self_ensemble:
        return _chunked_ensemble(image, plans[0], plans[1], dispatch,
                                 inflight_bands)

    outs, convs = [], []
    inflight: list = []   # bounded dispatch window (device arrays)

    def _drain_one():
        out_b, conv_b = inflight.pop(0)
        outs.append(np.asarray(out_b))
        convs.append(np.asarray(conv_b))

    for band in bands:
        inflight.append(dispatch(image, band))
        if len(inflight) > inflight_bands:
            _drain_one()
    while inflight:
        _drain_one()
    return np.concatenate(outs, axis=0), np.concatenate(convs, axis=0)


def _dispatch_band(image, band, params, gy_idx, gy_w, gc_idx, gc_w,
                   s_rows: int, dst_h: int, d: int, src_w: int, dst_w: int,
                   cfg: SRCNNConfig, use_pallas: bool, precision,
                   spec, halo: int):
    """Slice one band's source rows, bind its runtime tables, and launch
    the compiled band program (async; returns device arrays)."""
    r0, r1, rows_y, rows_c, smin, smax = band
    bh = r1 - r0
    src = np.ascontiguousarray(image[smin:smax])
    if src.shape[0] < s_rows:               # equalize the compiled shape
        src = np.pad(src, ((0, s_rows - src.shape[0]), (0, 0), (0, 0)),
                     mode="edge")
    vy_idx = jnp.asarray(gy_idx[rows_y] - smin, jnp.int32)
    vy_w = jnp.asarray(gy_w[rows_y])
    vc_idx = jnp.asarray(gc_idx[rows_c] - smin, jnp.int32)
    vc_w = jnp.asarray(gc_w[rows_c])
    flags = jnp.asarray([r0 == 0, r1 == dst_h, True, True], jnp.int32)
    fn = _compiled_band(d, s_rows, src_w, bh, dst_w, int(cfg.filter),
                        use_pallas, precision, cfg.model, spec,
                        halo)
    return fn(jnp.asarray(src), params, vy_idx, vy_w, vc_idx, vc_w, flags)


def _chunked_ensemble(image, bands, mirrored, dispatch,
                      inflight_bands: int):
    """Band-wise flip self-ensemble: every output band is the f32 mean of
    the four flip variants' corresponding bands (round-half-even u8 cast,
    `jnp.round == np.rint`), bitwise equal to serve._ensemble_body's
    unflip-mean of the four full-frame u8 outputs.

    A vertically-flipped variant's band ranges are the MIRRORED plan
    (same cuts, reflected), so its contribution to output band i is its
    own band n-1-i, vertically unflipped.  Peak memory stays O(band):
    each output band is reduced and cast before the next is drained.
    """
    n = len(bands)
    flips = ((False, False), (False, True), (True, False), (True, True))
    views = {fv: image[::-1 if fv[0] else 1, ::-1 if fv[1] else 1]
             for fv in flips}

    def variant_band(fv, i):
        fy, _ = fv
        return (mirrored[n - 1 - i] if fy else bands[i])

    def unflip(a, fv):
        fy, fx = fv
        if fy:
            a = a[::-1]
        if fx:
            a = a[:, ::-1]
        return a

    outs, convs = [], []
    inflight: list = []   # [(fv, device_out, device_conv) x4] per band

    def _drain_one():
        group = inflight.pop(0)
        acc_o = acc_c = None
        for fv, ob, cb in group:
            o = unflip(np.asarray(ob), fv).astype(np.float32)
            c = unflip(np.asarray(cb), fv).astype(np.float32)
            acc_o = o if acc_o is None else acc_o + o
            acc_c = c if acc_c is None else acc_c + c
        outs.append(np.rint(acc_o / 4.0).astype(np.uint8))
        convs.append(np.rint(acc_c / 4.0).astype(np.uint8))

    for i in range(n):
        group = []
        for fv in flips:
            ob, cb = dispatch(views[fv], variant_band(fv, i))
            group.append((fv, ob, cb))
        inflight.append(group)
        if len(inflight) > inflight_bands:
            _drain_one()
    while inflight:
        _drain_one()
    return np.concatenate(outs, axis=0), np.concatenate(convs, axis=0)
