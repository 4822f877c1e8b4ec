"""Immutable run configuration.

The reference keeps two mutable process globals set via
``ConfigureFilterSRCNN`` (`libsrcnn.cpp:91-92,930-941`) which are not
thread-safe.  This framework replaces them with this frozen config object
passed per call; a thin compat shim in :mod:`libsrcnn_tpu.api` reproduces the
global-state API for drop-in use.
"""

from __future__ import annotations

import dataclasses
import enum


class FilterType(enum.IntEnum):
    """Interpolation filter for the classical upscale stage.

    Values match the reference's ``SRCNNFilterType`` enum
    (`libsrcnn.h:37-44`) and the CLI ``--filter=N`` mapping
    (`test.cpp:341-365`).
    """

    NEAREST = 0   # box filter, width 0.5
    BILINEAR = 1  # triangle, width 1
    BICUBIC = 2   # Mitchell-Netravali b=c=1/3, width 2 (default)
    LANCZOS3 = 3  # sinc * sinc, width 3
    BSPLINE = 4   # cubic B-spline, width 2


#: Per-channel filter policy (`libsrcnn.cpp:677-714`): the Y channel gets the
#: configured filter; Cb/Cr/A are forced to bilinear -- unless the configured
#: filter is NEAREST, in which case chroma uses the box filter too.
def chroma_filter(y_filter: FilterType) -> FilterType:
    return FilterType.NEAREST if y_filter == FilterType.NEAREST else FilterType.BILINEAR


@dataclasses.dataclass(frozen=True)
class SRCNNConfig:
    """Configuration for one upscale call.

    Attributes:
      filter: interpolation filter for the Y channel (chroma policy is
        derived, see :func:`chroma_filter`).
      step_scale: decompose scale factors > 2 into chained x2 passes with a
        u8 round-trip between passes, mirroring `libsrcnn.cpp:980-1061`.
      compute_dtype: the conv stack's tier on device.  ``float32`` matches
        the reference within 1 u8 LSB (the golden gate); the srcnn fused
        kernel runs it as f32-accurate six-pass bf16 tensor-core dots, the
        XLA path as f32 convs at ``HIGHEST``.  ``bfloat16``: for srcnn,
        bf16-rounded weights against hi + lo bf16 halves of the f32
        activations (two bf16 dots, f32 accumulation) in the fused kernel,
        or bf16-operand convs on the XLA path; for the learned families,
        convs at ``Precision.DEFAULT`` (TF32 on the H100).
        ``bfloat16_fast`` (srcnn only): one bf16 dot per conv in the fused
        kernel, adding the activations' bf16 rounding (SSIM vs float32
        >=0.99); the XLA path runs it as ``bfloat16``.  ``int8`` (srcnn
        only) is the quantized draft tier, XLA int8 convs on every path;
        quality vs the exact path is ~40 dB PSNR (models/srcnn_int8.py).
      self_ensemble: flip self-ensemble (Timofte et al., CVPR 2016
        enhanced-prediction trick): run the pipeline on the 4 flip
        variants of the input in ONE vmapped device dispatch, unflip and
        average the outputs in f32 before the u8 cast.  Trades 4x compute
        for a free quality bump on every model family (measured in
        EVAL.md) -- the variants run as one batch.  Off by default; the golden parity gate applies
        only to the non-ensemble path.
      emit_conv_map: also return the raw Y-channel conv3 output as u8
        (`libsrcnn.cpp:889-915`).
      use_pallas: route the srcnn conv stack through the fused kernel
        (:mod:`libsrcnn_tpu.kernels.fused_conv`).  ``None`` (default)
        auto-selects (:func:`libsrcnn_tpu.pipeline.resolve_pallas`): the
        kernel on the GPU for the tiers where it measured faster end to
        end, XLA elsewhere; on the CPU an explicit True interprets it.
      model: which model family upscales the Y channel.  ``"srcnn"``
        (default) is the reference's 9-1-5 stack on the pre-interpolated
        plane.  ``"fsrcnn"`` (features at LOW resolution, learned deconv
        upscale) and ``"espcn"`` (LOW-resolution stack + sub-pixel
        convolution / pixel shuffle) are beyond-reference families with
        shipped x2/x3/x4 heads (tools/train_fsrcnn.py / train_espcn.py);
        both require the scale to equal a trained head's integer factor.
        ``"vdsr"`` (deep residual stack on the pre-interpolated plane,
        tools/train_vdsr.py) ships one scale-agnostic checkpoint serving
        any factor, including fractional and step-scale chains -- the
        zoo's strongest quality tier (EVAL.md).
      lane_pack: run the learned families' convs in the lane-packed
        formulation (:mod:`libsrcnn_tpu.ops.packed_conv`): p adjacent
        output columns share the channel dimension, widening narrow
        stacks (vdsr ch=32, fsrcnn s=12, the r^2 sub-pixel heads).  Same
        f32 MACs in a different reduction order.  ``None`` (default) and
        False run the direct convs; True opts in.  Ignored by the srcnn
        model (its fused kernel owns the conv stack, and the golden gate
        pins its reduction order).
    """

    filter: FilterType = FilterType.BICUBIC
    step_scale: bool = False
    compute_dtype: str = "float32"
    self_ensemble: bool = False
    emit_conv_map: bool = False
    use_pallas: bool | None = None
    model: str = "srcnn"
    lane_pack: bool | None = None


DEFAULT_CONFIG = SRCNNConfig()
