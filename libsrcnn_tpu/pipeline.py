"""End-to-end single-pass SRCNN upscale pipeline (the `doSRCNN` equivalent).

The reference's pipeline driver (`libsrcnn.cpp:628-923`) runs color split ->
per-channel resize -> conv stack on Y -> merge as separate OpenMP'd CPU
stages with heap round-trips.  Here the whole pass is ONE jitted XLA program:
u8 image in device memory -> planar f32 -> band-resample -> SRCNN 9-1-5 ->
u8 out, so XLA fuses the elementwise stages into the convs.  Shapes are static per (input size, scale, depth) -- compiled
programs are cached.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .config import FilterType, SRCNNConfig, chroma_filter
from .models import srcnn
from .ops import color, resize

#: model families that run at LOW resolution with a learned upscale head
#: (vs SRCNN's interpolate-first).  Each module exposes the same protocol:
#: ``load_params(scale) -> (params, spec)``, ``forward_lr(params, y, spec)``,
#: ``default_spec()``.
LR_FAMILIES = ("fsrcnn", "espcn")

#: learned families that, like SRCNN, run AFTER classical interpolation at
#: high resolution (`forward_hr(params, y_hr, spec)`): one checkpoint
#: serves every factor, including fractional scales and step-scale chains.
#: "srcnn955" is Dong et al.'s higher-rated 9-5-5 SRCNN variant, served
#: by the generic family module.
HR_FAMILIES = ("vdsr", "srcnn955")

#: model-name -> models submodule (families whose module name differs)
_FAMILY_MODULES = {"srcnn955": "srcnn_generic"}


def _lr_family(name: str):
    import importlib

    return importlib.import_module(
        f".models.{_FAMILY_MODULES.get(name, name)}", __package__)


#: valid srcnn compute tiers (the learned families take float32/bfloat16,
#: validated by family_precision)
SRCNN_TIERS = ("float32", "bfloat16", "bfloat16_fast", "int8")


def validate_compute_dtype(cfg: "SRCNNConfig") -> None:
    """Reject unknown srcnn tiers up front -- BEFORE weights load or any
    compute branch runs (an arbitrary dtype string would otherwise
    quietly load rounded weights and run a nonstandard tier on the XLA
    path, or die in a raw KeyError on the Pallas path)."""
    if cfg.model == "srcnn" and cfg.compute_dtype not in SRCNN_TIERS:
        raise ValueError(
            f"srcnn compute_dtype={cfg.compute_dtype!r} is not a tier: "
            f"use one of {SRCNN_TIERS}")


def param_dtype(compute_dtype: str) -> str:
    """Storage dtype for srcnn params.  ``bfloat16_fast`` is a dot-pass
    policy, not a storage dtype: it shares bf16 weight storage with the
    ``bfloat16`` tier (the fused kernel casts its operands itself; on the
    XLA path both bf16 tiers run the same bf16-operand convs)."""
    return "bfloat16" if compute_dtype == "bfloat16_fast" else compute_dtype


def family_precision(compute_dtype: str):
    """Dot precision for the learned model families (which have no u8
    golden gate): exact f32 (``HIGHEST``), or bf16 operands."""
    if compute_dtype == "float32":
        return jax.lax.Precision.HIGHEST
    if compute_dtype == "bfloat16":
        return jax.lax.Precision.DEFAULT
    raise ValueError(
        f"compute_dtype={compute_dtype!r} is only supported by the srcnn "
        f"model; the fsrcnn/espcn/vdsr families take 'float32' or "
        f"'bfloat16'")


def load_model_params(cfg: "SRCNNConfig", scale: float = 2.0) -> dict:
    """Default parameters for ``cfg.model``: the pre-trained SRCNN 9-1-5
    weights, or an LR family's shipped checkpoint (with its spec attached
    under ``"__spec__"``).  Step-scale chains x2 passes, so x2 weights
    serve power-of-two factors there; a fractional remainder pass still
    raises for the LR families (pinned by
    tests/test_zoo_scales.py::test_step_scale_family_contract -- use
    vdsr for arbitrary factors)."""
    validate_compute_dtype(cfg)
    if cfg.model != "srcnn":
        family_precision(cfg.compute_dtype)  # reject int8 etc. up front
    if cfg.model in LR_FAMILIES:
        mod = _lr_family(cfg.model)
        fparams, spec = mod.load_params(
            scale=2 if cfg.step_scale else int(scale))
        return dict(fparams, __spec__=spec)
    if cfg.model in HR_FAMILIES:
        fparams, spec = _lr_family(cfg.model).load_params()
        return dict(fparams, __spec__=spec)
    if cfg.compute_dtype == "int8":
        from .models import srcnn_int8

        return srcnn_int8.load_params()
    return srcnn.load_params(dtype=param_dtype(cfg.compute_dtype))


def prepare_model_params(cfg: "SRCNNConfig", params: dict, h: int, w: int,
                         dst_h: int, dst_w: int, multiply):
    """Validate cfg.model against the geometry and split off the LR-family
    spec: returns (params-without-spec, spec-or-None)."""
    validate_compute_dtype(cfg)
    if cfg.model in LR_FAMILIES:
        mod = _lr_family(cfg.model)
        spec = params.get("__spec__") or mod.default_spec()
        params = {k: v for k, v in params.items() if k != "__spec__"}
        if (dst_h, dst_w) != (h * spec.scale, w * spec.scale):
            raise ValueError(
                f"{cfg.model} x{spec.scale} weights require scale "
                f"{spec.scale} exactly; got {multiply} "
                f"({w}x{h} -> {dst_w}x{dst_h})")
        return params, spec
    if cfg.model in HR_FAMILIES:
        mod = _lr_family(cfg.model)
        spec = params.get("__spec__") or mod.default_spec()
        params = {k: v for k, v in params.items() if k != "__spec__"}
        return params, spec  # HR families serve any factor
    if cfg.model != "srcnn":
        raise ValueError(f"unknown model {cfg.model!r}")
    return params, None


def _single_pass(img_u8, params, *, dst_h, dst_w, filter_type, use_pallas,
                 compute_dtype="float32", model="srcnn", fsrcnn_spec=None,
                 lane_pack=False):
    """Trace-time builder: [H,W,D] u8 -> ([dst_h,dst_w,D] u8, [dst_h,dst_w] u8).

    Mirrors `doSRCNN` (`libsrcnn.cpp:628-923`): the second output is the
    truncated-u8 conv3 map (`:889-915`).  With ``model="fsrcnn"`` the Y
    channel skips the classical pre-interpolation and goes through the
    FSRCNN low-resolution stack + learned deconv instead (chroma keeps the
    reference's classical policy).
    """
    d = img_u8.shape[-1]
    planes = color.rgb_to_ycbcr(img_u8)  # [D,H,W] f32

    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)

    rest = [
        resize.resize_plane(planes[c], dst_h, dst_w, c_filter) for c in range(1, d)
    ]

    if model in LR_FAMILIES:
        mod = _lr_family(model)
        y_sr = mod.forward_lr(params, planes[0], fsrcnn_spec,
                              precision=family_precision(compute_dtype),
                              lane_pack=bool(lane_pack))
    elif model in HR_FAMILIES:
        mod = _lr_family(model)
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        y_sr = mod.forward_hr(params, y_r, fsrcnn_spec,
                              precision=family_precision(compute_dtype),
                              lane_pack=bool(lane_pack))
    elif compute_dtype == "int8":
        from .models import srcnn_int8

        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        y_sr = srcnn_int8.forward_y(params, y_r)
    elif use_pallas:
        from .kernels import fused_conv

        # the resize gather emits the kernel's 6-px replicate halo
        # directly, so no separate padding pass runs over the plane
        halo = fused_conv.HALO
        y_r = resize.resize_plane_padded(planes[0], dst_h, dst_w, y_filter,
                                         halo, dst_h + 2 * halo,
                                         dst_w + 2 * halo)
        y_sr = fused_conv._fused(y_r, params, pad_mode="halo",
                                 tier=compute_dtype)
    else:
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        y_sr = srcnn.forward_y(params, y_r)

    merged = jnp.stack([y_sr, *rest], axis=0)
    out_u8 = color.ycbcr_to_rgb(merged)
    # conv3 output is already clamped to [0,255]; truncating u8 cast
    # (`libsrcnn.cpp:897-901`).
    conv_u8 = jnp.floor(y_sr).astype(jnp.uint8)
    return out_u8, conv_u8


@functools.lru_cache(maxsize=128)
def compiled_pass(h: int, w: int, d: int, dst_h: int, dst_w: int,
                  filter_type: int, use_pallas: bool,
                  compute_dtype: str = "float32", model: str = "srcnn",
                  fsrcnn_spec=None, lane_pack: bool = False):
    """JIT-compiled single pass for one static shape configuration."""
    fn = functools.partial(
        _single_pass, dst_h=dst_h, dst_w=dst_w,
        filter_type=filter_type, use_pallas=use_pallas,
        compute_dtype=compute_dtype, model=model, fsrcnn_spec=fsrcnn_spec,
        lane_pack=lane_pack,
    )
    return jax.jit(fn)


def run_intermediates(img_u8, params, multiply: float, cfg: SRCNNConfig):
    """Eager-ish pass that also returns every intermediate plane, mirroring
    the reference's DEBUG dump sites (`libsrcnn.cpp:731-850`): the resized
    Y/Cb/Cr(/A) planes, all 64 conv1 maps, 32 conv2 maps, and conv3."""
    import jax.numpy as jnp
    from .models.srcnn import edge_pad, _conv

    h, w, d = img_u8.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    y_filter = FilterType(cfg.filter)
    c_filter = chroma_filter(y_filter)

    planes = color.rgb_to_ycbcr(jnp.asarray(img_u8))
    names = ["resized_Y", "resized_Cb", "resized_Cr", "resized_A"][:d]
    out = {}
    rz = []
    for c, name in enumerate(names):
        ft = y_filter if c == 0 else c_filter
        p = resize.resize_plane(planes[c], dst_h, dst_w, ft)
        rz.append(p)
        out[name] = p

    x = rz[0][None, :, :, None]
    h1 = jnp.maximum(_conv(edge_pad(x, 4), params["w1"]) + params["b1"], 0.0)
    h2 = jnp.maximum(_conv(h1, params["w2"]) + params["b2"], 0.0)
    h3 = _conv(edge_pad(h2, 2), params["w3"]) + params["b3"]
    conv3 = jnp.clip(h3[0, :, :, 0], 0.0, 255.0)
    for f in range(h1.shape[-1]):
        out[f"conv1_{f}"] = h1[0, :, :, f]
    for f in range(h2.shape[-1]):
        out[f"conv2_{f}"] = h2[0, :, :, f]
    out["conv3"] = conv3
    return out


#: srcnn tiers the fused kernel serves when ``use_pallas`` is auto on the
#: GPU: those where it beat the XLA conv stack end to end on the card
#: (PERF.md, "H100").  int8 always runs its XLA twin.
PALLAS_TIERS = ("float32", "bfloat16", "bfloat16_fast")


def resolve_pallas(use_pallas, compute_dtype: str = "float32") -> bool:
    """``None`` -> auto: the fused kernel on the GPU for the tiers in
    :data:`PALLAS_TIERS`, XLA elsewhere (the Pallas interpreter on the
    CPU is far slower than XLA's native conv)."""
    if use_pallas is None:
        return (jax.default_backend() == "gpu"
                and compute_dtype in PALLAS_TIERS)
    return bool(use_pallas) and compute_dtype != "int8"


def resolve_lane_pack(lane_pack, model: str) -> bool:
    """``None`` -> auto: the direct convs.  The lane-packed formulation
    (:mod:`libsrcnn_tpu.ops.packed_conv`) runs only when asked for.  The
    srcnn model ignores the flag: its conv stack is owned by the fused
    kernel / golden-gated XLA path."""
    if model == "srcnn":
        return False
    return bool(lane_pack)


def run_pass(img_u8, params, multiply: float, cfg: SRCNNConfig):
    """One resize+model pass; returns (out_u8, conv_u8) device arrays."""
    h, w, d = img_u8.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    params, spec = prepare_model_params(cfg, params, h, w, dst_h, dst_w,
                                        multiply)
    fn = compiled_pass(h, w, d, dst_h, dst_w, int(cfg.filter),
                       resolve_pallas(cfg.use_pallas, cfg.compute_dtype),
                       cfg.compute_dtype,
                       cfg.model, spec,
                       resolve_lane_pack(cfg.lane_pack, cfg.model))
    return fn(img_u8, params)
