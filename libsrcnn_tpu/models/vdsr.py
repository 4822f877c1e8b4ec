"""VDSR (Kim et al., CVPR 2016 -- "Accurate Image Super-Resolution Using
Very Deep Convolutional Networks") as the zoo's deep HR-domain family.

Like the reference's SRCNN (and unlike FSRCNN/ESPCN), VDSR runs AFTER
classical interpolation, at high resolution -- so one checkpoint serves
EVERY factor the pipeline can produce (fractional scales, step-scale
chains), which neither per-scale LR family can.  What it adds over
SRCNN's 3 layers is depth with residual learning: the network predicts
only the interpolation residual, and the identity path carries the
image.  (The reference stops at 9-1-5 with baked-in weights,
`libsrcnn.cpp:350-529`; a deep family is beyond-reference breadth.)

Implementation details:

* The interior layers all share one shape (3x3, ch->ch), so they are
  STACKED into a single [L, 3, 3, ch, ch] array and driven by
  ``lax.scan`` -- the conv is traced and compiled once regardless of
  depth (compile time stays O(1) in L).
* The scan body is wrapped in ``jax.checkpoint``: activations for the L
  interior layers are rematerialized in the backward pass instead of
  stored, so training memory is O(1) in depth -- the standard recipe
  for deep stacks (device memory is the bottleneck, FLOPs are cheap).
* Replicate SAME padding (edge semantics match the reference's conv
  border policy), f32 accumulation at HIGHEST precision.

Shipped weights: ``weights/vdsr.npz``, trained by tools/train_vdsr.py
with mixed scales {2, 3, 4} on the same corpus/degradation model as the
other families (butterfly held out); :func:`load_params` restores them.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

WEIGHTS_DIR = os.path.join(os.path.dirname(__file__), "weights")


@dataclasses.dataclass(frozen=True)
class VDSRSpec:
    depth: int = 12   # total conv layers (>= 3): in + (depth-2) interior + out
    ch: int = 32      # interior feature channels

    @property
    def name(self) -> str:
        return f"vdsr-d{self.depth}c{self.ch}"


def default_spec() -> VDSRSpec:
    return VDSRSpec()


def init_params(key: jax.Array, spec: VDSRSpec = VDSRSpec(),
                dtype=jnp.float32) -> dict:
    if spec.depth < 3:
        raise ValueError(f"VDSR depth must be >= 3, got {spec.depth}")
    k_in, k_mid, k_out = jax.random.split(key, 3)
    L = spec.depth - 2

    def he(k, shape, fan_in):
        return jax.random.normal(k, shape, dtype) * float(
            np.sqrt(2.0 / fan_in))

    return {
        "in_w": he(k_in, (3, 3, 1, spec.ch), 9),
        "in_b": jnp.zeros((spec.ch,), dtype),
        "mid_w": he(k_mid, (L, 3, 3, spec.ch, spec.ch), 9 * spec.ch),
        "mid_b": jnp.zeros((L, spec.ch), dtype),
        # residual head starts near zero: the net begins as the identity
        "out_w": he(k_out, (3, 3, spec.ch, 1), 9 * spec.ch) * 0.1,
        "out_b": jnp.zeros((1,), dtype),
    }


@functools.lru_cache(maxsize=2)
def _load_cached(path: str):
    z = np.load(path)
    spec = VDSRSpec(depth=int(z["meta_depth"]), ch=int(z["meta_ch"]))
    params = {k: jnp.asarray(z[k]) for k in z.files
              if not k.startswith("meta_")}
    return params, spec


def load_params(scale: int | None = None, path: str | None = None,
                dtype=jnp.float32):
    """Load shipped (or checkpointed) VDSR weights -> (params, spec).

    ``scale`` is accepted for model-zoo protocol uniformity and ignored:
    the checkpoint is scale-agnostic (trained with mixed factors).
    """
    if path is None:
        path = os.path.join(WEIGHTS_DIR, "vdsr.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped VDSR weights ({path}); train them with "
                f"tools/train_vdsr.py")
    params, spec = _load_cached(os.path.abspath(path))
    if dtype != jnp.float32:
        params = {k: v.astype(dtype) for k, v in params.items()}
    return params, spec


def _conv_same(x, w, precision=lax.Precision.HIGHEST, lane_pack=False):
    from libsrcnn_tpu.ops import packed_conv

    return packed_conv.conv_same(x, w, precision, lane_pack)


def forward_hr(params: dict, y_hr: jnp.ndarray,
               spec: VDSRSpec = VDSRSpec(), *, clamp: bool = True,
               precision=lax.Precision.HIGHEST,
               lane_pack: bool | int = False):
    """Interpolated HR Y plane(s) [H, W] or [N, H, W] -> refined, same
    shape.  ``y + residual`` with the residual net under scan+remat.

    ``precision`` sets the dot precision of every conv: HIGHEST (default)
    is exact f32; DEFAULT is the backend's fast f32 conv (TF32 tensor
    cores on the H100) -- the throughput tier (quality delta measured in
    EVAL.md; there is no u8 golden gate on this family).

    ``lane_pack`` runs the interior stack through
    :func:`libsrcnn_tpu.ops.packed_conv.conv_same`: True = the
    module's default phase count (p=4 at ch=32), an int > 1 = that
    explicit count.  Same f32 MACs in a
    different reduction order, so it is not used where bit-stability
    across configs matters."""
    squeeze = y_hr.ndim == 2
    if squeeze:
        y_hr = y_hr[None]
    x = y_hr[..., None].astype(params["in_w"].dtype)

    # The inter-layer activations stay f32 on every tier, for exact
    # tier parity (bf16 carries are a bytes question, ROADMAP S3).
    h = jnp.maximum(_conv_same(x, params["in_w"], precision)
                    + params["in_b"], 0.0)

    @jax.checkpoint
    def layer(carry, wb):
        w, b = wb
        return jnp.maximum(
            _conv_same(carry, w, precision, lane_pack) + b, 0.0), None

    h, _ = lax.scan(layer, h, (params["mid_w"], params["mid_b"]))

    res = (_conv_same(h, params["out_w"], precision) + params["out_b"])[..., 0]
    out = y_hr.astype(jnp.float32) + res.astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out


def halo_width(spec: VDSRSpec) -> int:
    """Pixels of context one output pixel needs per side: ``depth`` SAME
    3x3 convs each consume 1 px of neighborhood.  This is the model's
    halo plan for the explicit-tiling paths (parallel/tiled.py,
    chunked.py) -- derived from the spec, not hard-coded."""
    return spec.depth


def _edge_refresh(x: jnp.ndarray, flags: jnp.ndarray, halo: int) -> jnp.ndarray:
    """Re-impose replicate-padding semantics on TRUE image edges of an
    extended [N, E_h, E_w, C] activation: where a side's flag is set, the
    ``halo`` boundary rows/cols are replaced by the first interior
    row/col.  Run before EVERY conv layer: the model's per-layer
    replicate ("edge") padding at a true edge is NOT the same as padding
    the input once (each layer must re-replicate its own activations).
    Interior sides (flag 0) keep real neighbor pixels from the halo
    exchange; their exact region shrinks by 1 px per conv, bounded by
    ``halo >= number of convs``."""
    e_h, e_w = x.shape[1], x.shape[2]
    ri = jnp.arange(e_h)[None, :, None, None]
    ci = jnp.arange(e_w)[None, None, :, None]
    x = jnp.where((flags[0] == 1) & (ri < halo), x[:, halo:halo + 1], x)
    x = jnp.where((flags[1] == 1) & (ri >= e_h - halo),
                  x[:, e_h - halo - 1:e_h - halo], x)
    x = jnp.where((flags[2] == 1) & (ci < halo), x[:, :, halo:halo + 1], x)
    x = jnp.where((flags[3] == 1) & (ci >= e_w - halo),
                  x[:, :, e_w - halo - 1:e_w - halo], x)
    return x


def forward_hr_halo(params: dict, ext: jnp.ndarray, flags: jnp.ndarray,
                    spec: VDSRSpec = VDSRSpec(), *, halo: int | None = None,
                    clamp: bool = True,
                    precision=lax.Precision.HIGHEST) -> jnp.ndarray:
    """VDSR forward on an extended [E_h, E_w] plane carrying ``halo``
    pixels of context per side -> the interior [E_h-2h, E_w-2h] result,
    bit-identical to the same rows/cols of :func:`forward_hr` (direct
    convs) on the full plane.

    ``flags`` [top, bottom, left, right] (int32) mark which borders are
    TRUE image edges: there the halo pixels are replicated input and
    :func:`_edge_refresh` re-imposes the per-layer replicate padding;
    interior borders carry real neighbor pixels (band stream / ppermute
    exchange) and stay untouched.  This is the same flag mechanism as the
    fused srcnn kernel's border clamp (kernels/fused_conv._border_clamp),
    driving per-layer padding semantics instead of the conv2-ring quirk.

    Always the DIRECT conv formulation: the lane-packed conv's reduction
    order is plane-shape-dependent (measured), so it cannot be
    bit-identical between a band/tile and the full plane.
    """
    if halo is None:
        halo = halo_width(spec)
    if halo < spec.depth:
        raise ValueError(f"halo {halo} < depth {spec.depth} convs")
    x = ext[None, :, :, None].astype(params["in_w"].dtype)

    def conv(t, w):
        return _conv_same(t, w, precision)

    h = jnp.maximum(conv(_edge_refresh(x, flags, halo), params["in_w"])
                    + params["in_b"], 0.0)

    @jax.checkpoint
    def layer(carry, wb):
        w, b = wb
        return jnp.maximum(
            conv(_edge_refresh(carry, flags, halo), w) + b, 0.0), None

    h, _ = lax.scan(layer, h, (params["mid_w"], params["mid_b"]))

    res = (conv(_edge_refresh(h, flags, halo), params["out_w"])
           + params["out_b"])[..., 0]
    out = ext[None].astype(jnp.float32) + res.astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0, halo:ext.shape[0] - halo, halo:ext.shape[1] - halo]


def make_loss_forward(spec: VDSRSpec, lane_pack: int = 1):
    """Adapter for :func:`libsrcnn_tpu.train.trainer.loss_fn`: VDSR
    consumes the ALREADY-INTERPOLATED plane, so training pairs are
    (interp_y, hr_y) at the SAME size -- build them with
    tools/train_vdsr.py's mixed-scale pool.

    ``lane_pack > 1`` trains through the packed formulation (autodiff
    flows through the weight expansion, so gradients land on the true
    [3,3,ch,ch] parameters); same MACs in another reduction order."""
    def forward(params, interp_y, clamp=False):
        return forward_hr(params, interp_y, spec, clamp=clamp,
                          lane_pack=lane_pack)

    return forward
