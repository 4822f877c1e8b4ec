"""SRCNN 9-1-5 model (Dong et al., ECCV 2014) -- the XLA forward pass.

The reference implements this as three hand-rolled C++ loops over planar
float buffers (`libsrcnn.cpp:350-529`); here it is a pure function over a
params pytree, lowered through ``lax.conv_general_dilated`` (or the
fused kernel in :mod:`libsrcnn_tpu.kernels` when enabled).

Behavioral contract (golden path, SURVEY.md section 3.1):

* conv1: 9x9, 1->64, replicate-pad 4 (`libsrcnn.cpp:362-392`), bias, ReLU.
* conv2: 1x1, 64->32, bias, ReLU (`libsrcnn.cpp:424-447`).
* conv3: 5x5, 32->1, replicate-pad 2, bias, clamp to [0, 255]
  (`libsrcnn.cpp:449-529`; the reference accumulates per-channel in double,
  which f32 matches within 1 u8 LSB -- the device path has no fp64).

Weights come from ``weights/srcnn_915.npz`` (extracted from the reference's
`convdata.h` with the conv3 spatial transpose fixed, see
tools/extract_weights.py).
"""

from __future__ import annotations

import functools
import importlib.resources

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

_DN = lax.conv_dimension_numbers((1, 1, 1, 1), (1, 1, 1, 1), ("NHWC", "HWIO", "NHWC"))


@functools.lru_cache(maxsize=1)
def _load_npz() -> dict[str, np.ndarray]:
    ref = importlib.resources.files("libsrcnn_tpu.models") / "weights" / "srcnn_915.npz"
    with ref.open("rb") as f:
        z = np.load(f)
        return {k: z[k] for k in ("w1", "b1", "w2", "b2", "w3", "b3")}


def load_params(dtype=jnp.float32) -> dict[str, jnp.ndarray]:
    """Load the pre-trained 8,129 SRCNN parameters as a pytree.

    ``dtype`` is the WEIGHT storage dtype (it drives the conv operand
    dtype on the XLA path).  Biases always stay f32: every compute tier
    -- the fused kernel's bf16 dots and the XLA path alike --
    accumulates in f32 and adds biases in f32, so rounding bias storage
    would only add error without changing any dot operand.  This also
    keeps each bf16 tier's output independent of whether the caller
    loaded f32 or bf16 params (the weights reach the dots bf16-rounded
    either way)."""
    return {k: jnp.asarray(v, jnp.float32 if k.startswith("b") else dtype)
            for k, v in _load_npz().items()}


def init_params(key: jax.Array, dtype=jnp.float32) -> dict[str, jnp.ndarray]:
    """Random init with the SRCNN paper's scheme (Gaussian, std 1e-3) for
    training from scratch; shapes identical to :func:`load_params`."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "w1": jax.random.normal(k1, (9, 9, 1, 64), dtype) * 1e-3,
        "b1": jnp.zeros((64,), dtype),
        "w2": jax.random.normal(k2, (1, 1, 64, 32), dtype) * 1e-3,
        "b2": jnp.zeros((32,), dtype),
        "w3": jax.random.normal(k3, (5, 5, 32, 1), dtype) * 1e-3,
        "b3": jnp.zeros((1,), dtype),
    }


def _conv(x: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    # precision=HIGHEST: without it an f32 conv on the H100 runs in TF32
    # (10-bit mantissa, visible as several u8 LSB); HIGHEST keeps full f32
    # so the output matches the reference's C++ f32 loops.
    return lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="VALID",
        dimension_numbers=_DN, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )


def edge_pad(x: jnp.ndarray, p: int) -> jnp.ndarray:
    """Replicate-pad H and W of an NHWC tensor by p pixels each side,
    matching the reference's clamp-to-edge expansion (`libsrcnn.cpp:362-392`)."""
    return jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="edge")


def forward_y(params: dict, y: jnp.ndarray, *, clamp: bool = True) -> jnp.ndarray:
    """Run the 9-1-5 stack on a batch of Y planes.

    Args:
      params: pytree from :func:`load_params` / :func:`init_params`.
      y: [N, H, W] or [H, W] float plane(s) in [0, 255] domain.
      clamp: apply the reference's final clamp to [0, 255]
        (`libsrcnn.cpp:521-522`); disable for training.

    Returns:
      Same leading shape as ``y``: the reconstructed Y plane(s).
    """
    squeeze = y.ndim == 2
    if squeeze:
        y = y[None]
    x = y[..., None]  # NHWC, C=1

    dtype = params["w1"].dtype
    x = x.astype(dtype)

    # accumulation stays f32 (preferred_element_type); activations are cast
    # back to the params dtype so bf16-mode weights see matching operands
    h1 = _conv(edge_pad(x, 4), params["w1"]) + params["b1"]
    h1 = jnp.maximum(h1, 0.0).astype(dtype)
    h2 = _conv(h1, params["w2"]) + params["b2"]
    h2 = jnp.maximum(h2, 0.0).astype(dtype)
    h3 = _conv(edge_pad(h2, 2), params["w3"]) + params["b3"]
    out = h3[..., 0].astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out
