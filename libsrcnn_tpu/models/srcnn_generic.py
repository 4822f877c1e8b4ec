"""Generalized SRCNN family: configurable f1-n1-f2-n2-f3 variants.

The reference ships exactly one architecture (9-1-5 with 64/32 filters,
baked into `convdata.h`).  Dong et al. also evaluate 9-5-5 and 9-3-5 and
wider/narrower filter banks; this module makes the family a config so the
training subsystem can explore it:

>>> spec = ModelSpec(f1=9, n1=64, f2=5, n2=32, f3=5)        # SRCNN 9-5-5
>>> params = init_params(jax.random.key(0), spec)
>>> y_sr = forward_y(params, y, spec)

Semantics generalize the reference's: replicate ("edge") padding on every
spatial conv, ReLU after layers 1 and 2, clamp [0,255] at the end.
NOTE the deliberate divergence from the 9-1-5 reference's border quirk:
the reference replicate-pads conv2's OUTPUT before conv3
(`libsrcnn.cpp:463-489`); this family replicate-pads each layer's INPUT
-- for f2 == 1 the two differ only in a 2-px border ring, and the
generic per-layer rule is what the halo/tiling machinery generalizes
over.  The pre-trained 9-1-5 weights load through :func:`from_pretrained`.
The fused Pallas kernel is specialized to 9-1-5; this family runs the
XLA path (lane-packable on request).

As the ``"srcnn955"`` model family (the shipped 9-5-5 head, trained by
tools/train_srcnn955.py), it follows the HR-domain protocol: one
checkpoint refines the classically-interpolated plane at ANY factor,
with :func:`halo_width`/:func:`forward_hr_halo` providing the derived
halo plan for the chunked/tiled gigapixel paths.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import srcnn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    f1: int = 9   # layer-1 kernel size (patch extraction)
    n1: int = 64  # layer-1 filters
    f2: int = 1   # layer-2 kernel size (non-linear mapping)
    n2: int = 32  # layer-2 filters
    f3: int = 5   # layer-3 kernel size (reconstruction)

    @property
    def name(self) -> str:
        return f"srcnn-{self.f1}{self.f2}{self.f3}-{self.n1}x{self.n2}"

    def param_count(self) -> int:
        return (self.f1**2 * self.n1 + self.n1
                + self.f2**2 * self.n1 * self.n2 + self.n2
                + self.f3**2 * self.n2 + 1)


SRCNN_915 = ModelSpec()
SRCNN_955 = ModelSpec(f2=5)
SRCNN_935 = ModelSpec(f2=3)


def init_params(key: jax.Array, spec: ModelSpec = SRCNN_915,
                dtype=jnp.float32) -> dict:
    """Gaussian init (std 1e-3), zero biases -- the paper's scheme."""
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "w1": jax.random.normal(k1, (spec.f1, spec.f1, 1, spec.n1), dtype) * 1e-3,
        "b1": jnp.zeros((spec.n1,), dtype),
        "w2": jax.random.normal(k2, (spec.f2, spec.f2, spec.n1, spec.n2), dtype) * 1e-3,
        "b2": jnp.zeros((spec.n2,), dtype),
        "w3": jax.random.normal(k3, (spec.f3, spec.f3, spec.n2, 1), dtype) * 1e-3,
        "b3": jnp.zeros((1,), dtype),
    }


def from_pretrained(spec: ModelSpec = SRCNN_915, dtype=jnp.float32) -> dict:
    if spec != SRCNN_915:
        raise ValueError(f"pre-trained weights exist only for 9-1-5, not {spec.name}")
    return srcnn.load_params(dtype=dtype)


def spec_of(params: dict) -> ModelSpec:
    """Recover the ModelSpec from a params pytree's shapes."""
    w1 = np.asarray(params["w1"])
    w2 = np.asarray(params["w2"])
    w3 = np.asarray(params["w3"])
    return ModelSpec(f1=w1.shape[0], n1=w1.shape[3],
                     f2=w2.shape[0], n2=w2.shape[3], f3=w3.shape[0])


def forward_y(params: dict, y: jnp.ndarray, spec: ModelSpec | None = None,
              *, clamp: bool = True) -> jnp.ndarray:
    """Generic 3-layer forward on [H, W] or [N, H, W] planes."""
    if spec is None:
        spec = spec_of(params)
    squeeze = y.ndim == 2
    if squeeze:
        y = y[None]
    x = y[..., None].astype(params["w1"].dtype)

    def pad(t, k):
        p = k // 2
        return srcnn.edge_pad(t, p) if p else t

    h = srcnn._conv(pad(x, spec.f1), params["w1"]) + params["b1"]
    h = jnp.maximum(h, 0.0)
    h = srcnn._conv(pad(h, spec.f2), params["w2"]) + params["b2"]
    h = jnp.maximum(h, 0.0)
    h = srcnn._conv(pad(h, spec.f3), params["w3"]) + params["b3"]
    out = h[..., 0].astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out


# ---------------------------------------------------------------------------
# HR-family protocol (model="srcnn955"): shipped 9-5-5 head
# ---------------------------------------------------------------------------

WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")


def default_spec() -> ModelSpec:
    return SRCNN_955


@functools.lru_cache(maxsize=2)
def _load_cached(path: str):
    z = np.load(path)
    spec = ModelSpec(f1=int(z["meta_f1"]), n1=int(z["meta_n1"]),
                     f2=int(z["meta_f2"]), n2=int(z["meta_n2"]),
                     f3=int(z["meta_f3"]))
    params = {k: jnp.asarray(z[k]) for k in z.files
              if not k.startswith("meta_")}
    return params, spec


def load_params(scale: int | None = None, path: str | None = None,
                dtype=jnp.float32):
    """Load the shipped 9-5-5 checkpoint -> (params, spec).

    ``scale`` is accepted for model-zoo protocol uniformity and ignored:
    like the reference's own 9-1-5 (and vdsr), the HR-domain head serves
    every factor from one checkpoint.
    """
    if path is None:
        path = os.path.join(WEIGHTS_DIR, "srcnn955.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped 9-5-5 weights ({path}); train them with "
                f"tools/train_srcnn955.py")
    params, spec = _load_cached(os.path.abspath(path))
    if dtype != jnp.float32:
        params = {k: v.astype(dtype) for k, v in params.items()}
    return params, spec


def _conv_same(x, w, precision=lax.Precision.HIGHEST, lane_pack=False):
    from libsrcnn_tpu.ops import packed_conv

    return packed_conv.conv_same(x, w, precision, lane_pack)


def forward_hr(params: dict, y_hr: jnp.ndarray,
               spec: ModelSpec | None = None, *, clamp: bool = True,
               precision=lax.Precision.HIGHEST,
               lane_pack: bool | int = False) -> jnp.ndarray:
    """Interpolated HR Y plane(s) [H, W] or [N, H, W] -> reconstructed,
    same shape.  ``precision``/``lane_pack`` as in vdsr.forward_hr;
    with ``precision=HIGHEST, lane_pack=False`` this equals
    :func:`forward_y` bitwise (same edge-padded VALID convs)."""
    if spec is None:
        spec = spec_of(params)
    squeeze = y_hr.ndim == 2
    if squeeze:
        y_hr = y_hr[None]
    x = y_hr[..., None].astype(params["w1"].dtype)

    h = jnp.maximum(_conv_same(x, params["w1"], precision, lane_pack)
                    + params["b1"], 0.0)
    h = jnp.maximum(_conv_same(h, params["w2"], precision, lane_pack)
                    + params["b2"], 0.0)
    h = _conv_same(h, params["w3"], precision, lane_pack) + params["b3"]
    out = h[..., 0].astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out


def halo_width(spec: ModelSpec) -> int:
    """Pixels of context per side: each SAME conv consumes k//2."""
    return spec.f1 // 2 + spec.f2 // 2 + spec.f3 // 2


def forward_hr_halo(params: dict, ext: jnp.ndarray, flags: jnp.ndarray,
                    spec: ModelSpec | None = None, *,
                    halo: int | None = None, clamp: bool = True,
                    precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """Forward on an extended plane carrying ``halo`` px of context per
    side -> the interior result, bit-identical to :func:`forward_hr`
    (direct convs) -- same flag mechanism as vdsr.forward_hr_halo: true
    image edges re-impose the per-layer replicate padding, interior
    borders keep exchanged neighbor pixels."""
    from .vdsr import _edge_refresh

    if spec is None:
        spec = spec_of(params)
    if halo is None:
        halo = halo_width(spec)
    if halo < halo_width(spec):
        raise ValueError(f"halo {halo} < required {halo_width(spec)}")
    x = ext[None, :, :, None].astype(params["w1"].dtype)

    h = jnp.maximum(
        _conv_same(_edge_refresh(x, flags, halo), params["w1"], precision)
        + params["b1"], 0.0)
    h = jnp.maximum(
        _conv_same(_edge_refresh(h, flags, halo), params["w2"], precision)
        + params["b2"], 0.0)
    h = (_conv_same(_edge_refresh(h, flags, halo), params["w3"], precision)
         + params["b3"])[..., 0].astype(jnp.float32)
    if clamp:
        h = jnp.clip(h, 0.0, 255.0)
    return h[0, halo:ext.shape[0] - halo, halo:ext.shape[1] - halo]


def make_loss_forward(spec: ModelSpec, lane_pack: int = 1):
    """Adapter for train.trainer.loss_fn: HR-domain pairs (interp_y,
    hr_y) at the same size, like vdsr's (build with the mixed-scale
    pool)."""
    def forward(params, interp_y, clamp=False):
        return forward_hr(params, interp_y, spec, clamp=clamp,
                          lane_pack=lane_pack)

    return forward
