"""int8-quantized SRCNN 9-1-5 forward — the framework's draft/throughput
tier beyond the float tiers.

It trades bounded quantization error for fewer bytes per operand; on
the H100 it runs as XLA int8 convs (no fused kernel), and whether it
pays there is ROADMAP S8.  Scheme (tools/calibrate_int8.py): symmetric
per-output-channel int8 weights, per-channel-calibrated activation
requantization with each layer's activation scale folded into the next
layer's weights; all accumulation in int32.  The inter-layer
dequant/bias/ReLU/requant chain is FOLDED into one f32 FMA + round +
clip per element (pack keys s = dequant*requant, t = bias*requant; the
clip's lower bound subsumes the ReLU), so epilogue ops are minimized
by construction.

This module is the XLA implementation (``lax.conv_general_dilated`` on
int8 operands) and the only one: the int8 tier runs it on every path.

There is no reference analog (the reference is f32-only); the exactness
contract of the framework (<=1 u8 LSB vs `libsrcnn.cpp`) applies to the
default f32 mode, NOT this tier -- quality vs the exact path is measured
and documented (PSNR/SSIM) instead.
"""

from __future__ import annotations

import functools
import importlib.resources

import numpy as np
import jax.numpy as jnp
from jax import lax

from .srcnn import _DN, edge_pad


@functools.lru_cache(maxsize=1)
def _load_npz() -> dict[str, np.ndarray]:
    ref = (importlib.resources.files("libsrcnn_tpu.models") / "weights"
           / "srcnn_915_int8.npz")
    with ref.open("rb") as f:
        z = np.load(f)
        return {k: z[k] for k in z.files}


def load_params() -> dict[str, jnp.ndarray]:
    """The quantized parameter pack (kernel-layout arrays, see
    tools/calibrate_int8.py for the key inventory)."""
    return {k: jnp.asarray(v) for k, v in _load_npz().items()
            if k not in ("a1", "a2")}


#: conv1 input scale: the resized Y plane lives in [0, 255]
INPUT_SCALE = 127.0 / 255.0


def quantize_input(y: jnp.ndarray) -> jnp.ndarray:
    """[.., H, W] f32 Y plane in [0,255] -> int8 codes in [0,127]."""
    return jnp.clip(jnp.round(y * INPUT_SCALE), 0, 127).astype(jnp.int8)


def fold_requant(acc: jnp.ndarray, s: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """int32 conv accumulators -> next layer's int8 codes via the folded
    epilogue: clip(round(acc*s + t), 0, 127) with s = dequant*requant and
    t = bias*requant per channel (the clip's lower bound subsumes the
    ReLU -- tools/calibrate_int8.py derives the identity)."""
    return jnp.clip(jnp.round(acc.astype(jnp.float32) * s + t),
                    0, 127).astype(jnp.int8)


def _conv_i8(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    return lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="VALID",
        dimension_numbers=_DN, preferred_element_type=jnp.int32)


def forward_y(qparams: dict, y: jnp.ndarray, *, clamp: bool = True) -> jnp.ndarray:
    """int8 9-1-5 stack on [H, W] or [N, H, W] Y plane(s), XLA ops.

    Integer-exact twin of the fused kernel's int8 path: conv taps are
    contracted in int8->int32, folded f32 FMA epilogue between layers.
    """
    squeeze = y.ndim == 2
    if squeeze:
        y = y[None]
    p = qparams

    w1 = p["w1q"].reshape(9, 9, 1, 64)
    w2 = p["w2q"].reshape(1, 1, 64, 32)
    # kernel layout is tap-major [25, 32] with k = 5*dx + dy; the XLA conv
    # wants HWIO = [dy, dx, 32, 1]
    w3 = p["w3q"].reshape(5, 5, 32).transpose(1, 0, 2)[..., None].astype(jnp.int8)

    xq = quantize_input(y.astype(jnp.float32))[..., None]   # NHWC int8
    acc1 = _conv_i8(edge_pad(xq, 4), w1)
    h1q = fold_requant(acc1, p["s1"], p["t1"])
    acc2 = _conv_i8(h1q, w2)
    h2q = fold_requant(acc2, p["s2"], p["t2"])
    acc3 = _conv_i8(edge_pad(h2q, 2), w3)
    out = acc3[..., 0].astype(jnp.float32) * p["d3"][0] + p["b3"][0]
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out
