"""Public API: functional `upscale` plus a reference-compatible shim.

The reference exposes exactly two C functions (`libsrcnn.h:46-54`):
``ConfigureFilterSRCNN(filter, stepscale)`` writing process globals, and
``ProcessSRCNN(buf, w, h, d, multiply, ...)`` returning int codes.  The
native API is :func:`upscale` (pure, config-in/arrays-out); the shims
:func:`configure_filter_srcnn` / :func:`process_srcnn` reproduce the
reference's stateful surface and error codes for drop-in use.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import jax

from .config import DEFAULT_CONFIG, FilterType, SRCNNConfig
from .models import srcnn
from .ops.resize import scaled_size
from . import pipeline

__all__ = [
    "upscale",
    "configure_filter_srcnn",
    "process_srcnn",
    "FilterType",
    "SRCNNConfig",
]


def _as_u8_image(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"expected uint8 image, got {img.dtype}")
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)  # gray -> RGB, as the reference
        # test app normalizes inputs to RGB (`test.cpp:45-120`)
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4] image, got {img.shape}")
    return img


def upscale(
    image: np.ndarray,
    scale: float,
    config: SRCNNConfig = DEFAULT_CONFIG,
    params: dict | None = None,
    return_conv_map: bool | None = None,
):
    """Super-resolve an RGB(A) u8 image by ``scale``.

    Args:
      image: [H, W, 3|4] uint8 array (RGB or RGBA interleaved); [H, W]
        grayscale is promoted to RGB.
      scale: multiply factor (> 0); non-integer factors supported, output
        size truncates like the reference (`libsrcnn.cpp:662-663`).
      config: immutable run options (filter, step_scale, pallas, ...).
      params: optional SRCNN params pytree (defaults to the pre-trained
        9-1-5 weights).
      return_conv_map: also return the u8 Y-channel conv3 map; defaults to
        ``config.emit_conv_map``.

    Returns:
      ``out`` u8 array [H', W', D], or ``(out, conv_map)`` when requested --
      matching the reference's optional convbuff output
      (`libsrcnn.cpp:889-915`).

    Step-scale mode (`config.step_scale`) decomposes the factor into chained
    x2 passes with a u8 round-trip between passes, exactly like
    `ProcessSRCNN`'s else-branch (`libsrcnn.cpp:980-1061`) -- including its
    quantization-between-passes behavior.
    """
    img = _as_u8_image(image)
    if params is None:
        params = pipeline.load_model_params(config, scale)
    want_conv = config.emit_conv_map if return_conv_map is None else return_conv_map

    h, w, _ = img.shape
    if float(scale) <= 0.0 or min(scaled_size(w, h, scale)) <= 0:
        raise ValueError(f"invalid scale factor {scale}")

    if config.self_ensemble:
        out, conv = _upscale_flip_ensemble(img, scale, config, params)
        return (out, conv) if want_conv else out

    if not config.step_scale:
        out, conv = pipeline.run_pass(img, params, float(scale), config)
        out, conv = np.asarray(out), np.asarray(conv)
        return (out, conv) if want_conv else out

    # --- step-scale: chained x2 passes (`libsrcnn.cpp:980-1061`) ---
    multiply = np.float32(scale)
    lf = np.fmod(multiply, np.float32(2.0))
    repeat = int(multiply / np.float32(2.0))
    if lf > 0.0:
        repeat += 1

    cur = img
    sw, sh = w, h
    out = conv = None
    final_ran = False
    for cnt in range(repeat):
        curmf = np.float32(2.0)
        if cnt + 1 == repeat:
            curmf = (np.float32(w) * multiply) / np.float32(sw)
            if curmf == 0.0 or curmf == 1.0:
                break
            final_ran = True
        o, c = pipeline.run_pass(cur, params, float(curmf), config)
        out, conv = o, c
        cur = o  # stays on device between passes (u8 quantization intact)
        if repeat > 1:
            sw = int(np.float32(sw) * curmf)
            sh = int(np.float32(sh) * curmf)

    # conv-map parity: the reference passes convbuff only to the FINAL
    # chain pass (`libsrcnn.cpp:1025-1029`); an early-broken chain (exact
    # remainder) therefore emits NO conv map even though the output is
    # the last completed pass's buffer (`:1058-1060`).
    if not final_ran:
        conv = None
    out = np.asarray(out) if out is not None else img.copy()
    conv = np.asarray(conv) if conv is not None else None
    return (out, conv) if want_conv else out


def _upscale_flip_ensemble(img, scale, config, params):
    """Flip self-ensemble: the 4 flip variants of ``img`` through the
    pipeline, outputs unflipped and averaged in f32 before the u8 cast.

    The non-step path batches all 4 variants into ONE vmapped device
    dispatch (`serve._ensemble_pass` -- the device sees a batch, not 4
    calls, and the flip/unflip bookkeeping lives there);
    step-scale chains go through the scalar path per variant.  Flips
    only (no transposes): 90-degree rotations swap H/W and would need a
    second set of resize tables for non-square frames.
    """
    base = dataclasses.replace(config, self_ensemble=False)
    if not base.step_scale:
        # flips, pipeline x4, unflip, average -- all inside ONE jitted
        # device program (serve._ensemble_pass holds the flip/unflip
        # bookkeeping)
        from . import serve

        out, conv = serve._ensemble_pass(img, params, float(scale), base)
        return np.asarray(out), np.asarray(conv)

    # step-scale chains go through the scalar path per variant; the
    # average happens host-side on the final u8 outputs
    flips = ((False, False), (False, True), (True, False), (True, True))

    def flip(a, fy, fx):
        return a[::-1] if fy and not fx else (
            a[:, ::-1] if fx and not fy else (
                a[::-1, ::-1] if fy and fx else a))

    res = [upscale(np.ascontiguousarray(flip(img, fy, fx)), scale, base,
                   params, True) for fy, fx in flips]
    outs, convs = [o for o, _ in res], [c for _, c in res]

    out = np.rint(np.mean(
        [flip(o, fy, fx).astype(np.float32)
         for (fy, fx), o in zip(flips, outs)], axis=0)).astype(np.uint8)
    if any(c is None for c in convs):
        # a degenerate chain (e.g. scale 1.0) ran zero passes: the plain
        # step path returns conv=None, so the ensemble does too
        return out, None
    conv = np.rint(np.mean(
        [flip(c, fy, fx).astype(np.float32)
         for (fy, fx), c in zip(flips, convs)], axis=0)).astype(np.uint8)
    return out, conv


def debug_intermediates(
    image: np.ndarray,
    scale: float,
    config: SRCNNConfig = DEFAULT_CONFIG,
    params: dict | None = None,
) -> dict:
    """Return every intermediate plane of a single pass as numpy arrays --
    the analog of the reference's DEBUG PNG dumps
    (`libsrcnn.cpp:731-850`).  Keys: resized_Y/Cb/Cr(/A), conv1_0..63,
    conv2_0..31, conv3."""
    img = _as_u8_image(image)
    if params is None:
        # the dumper mirrors the reference's f32 DEBUG path for EVERY
        # tier: the int8 tier's intermediates are its f32 dequants, and
        # the bf16 tiers' planes differ from f32 only by GEMM rounding
        # (run_intermediates' XLA convs also require f32 weights --
        # mixed-dtype conv operands are a TypeError)
        params = srcnn.load_params(dtype="float32")
    planes = pipeline.run_intermediates(img, params, float(scale), config)
    return {k: np.asarray(v) for k, v in planes.items()}


# ---------------------------------------------------------------------------
# Reference-compatible stateful shim
# ---------------------------------------------------------------------------

_state_lock = threading.Lock()
_state = {"filter": FilterType.BICUBIC, "step_scale": False}


def configure_filter_srcnn(filter_type: FilterType | int, step_scale: bool = False) -> None:
    """Drop-in for ``ConfigureFilterSRCNN`` (`libsrcnn.cpp:930-941`) --
    process-global, but lock-protected unlike the reference."""
    with _state_lock:
        _state["filter"] = FilterType(int(filter_type))
        _state["step_scale"] = bool(step_scale)


def process_srcnn(refbuff, w: int, h: int, d: int, multiply: float):
    """Drop-in for ``ProcessSRCNN`` (`libsrcnn.cpp:943-1064`).

    Args:
      refbuff: bytes / u8 array of interleaved RGB(A), length w*h*d.
      w, h, d: image geometry (d must be 3 or 4).
      multiply: scale factor.

    Returns:
      (retcode, outbuff, convbuff): retcode 0 on success, -1 for bad args,
      -2 for bad scale (matching `libsrcnn.cpp:951-966`); outbuff/convbuff
      are flat u8 numpy arrays (or None on failure).
    """
    # The reference declares w/h/d `unsigned` (`libsrcnn.h:48-50`), so a
    # negative geometry is unrepresentable there; in Python we report it as
    # bad args (-1) like the NULL/zero check (`libsrcnn.cpp:951-952`)
    # instead of letting reshape raise.
    if refbuff is None or w <= 0 or h <= 0 or d <= 0:
        return -1, None, None
    if isinstance(refbuff, np.ndarray):
        if refbuff.dtype != np.uint8:
            # an unsafe cast would silently value-wrap (300 -> 44);
            # reject like the NULL/zero check instead
            return -1, None, None
        buf = refbuff.ravel()
    else:
        buf = np.frombuffer(bytes(refbuff), dtype=np.uint8)
    if buf.size != w * h * d:
        return -1, None, None
    m_w = np.float32(w) * np.float32(multiply)
    m_h = np.float32(h) * np.float32(multiply)
    if m_w <= 0.0 or m_h <= 0.0:
        return -2, None, None
    if int(m_w) < 1 or int(m_h) < 1:
        # output would be empty (e.g. 0 < w*multiply < 1); the reference
        # fails inside doSRCNN's resize alloc -- report bad scale rather
        # than raise out of the retcode contract
        return -2, None, None
    if d not in (3, 4):
        # reference UB territory: depth<3 leaves doSRCNN's buffers
        # uninitialized (`libsrcnn.cpp:235-236`); we report bad args.
        return -1, None, None
    with _state_lock:
        cfg = SRCNNConfig(filter=_state["filter"], step_scale=_state["step_scale"])
    if cfg.step_scale and np.float32(multiply) == np.float32(1.0):
        # reference parity: a step-scale chain whose single pass breaks
        # (curmf == 1) leaves retval = -100 and NULL buffers
        # (`libsrcnn.cpp:1004-1008,636`); upscale() itself stays
        # Pythonic and returns the input copy for this case.
        return -100, None, None
    img = buf.reshape(h, w, d)
    # Allocation-failure parity (`libsrcnn.cpp:883,910`): the reference
    # returns -11 when the output RGB buffer allocation fails and -12 when
    # the conv-map u8 buffer allocation fails (with the already-built
    # output still handed back).  Here device/host allocation failures
    # surface as MemoryError or an XLA RESOURCE_EXHAUSTED error.
    try:
        out, conv = upscale(img, multiply, cfg, return_conv_map=True)
        out_flat = np.asarray(out).ravel()
    except MemoryError:
        return -11, None, None
    except jax.errors.JaxRuntimeError as e:  # jaxlib XlaRuntimeError subclass
        if "RESOURCE_EXHAUSTED" in str(e) or "Out of memory" in str(e):
            return -11, None, None
        raise
    try:
        conv_flat = conv.ravel() if conv is not None else None
    except MemoryError:
        # reference keeps the copied output buffer on a conv-map
        # allocation failure (`libsrcnn.cpp:895-912`)
        return -12, out_flat, None
    return 0, out_flat, conv_flat
