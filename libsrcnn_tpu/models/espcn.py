"""ESPCN (Shi et al., CVPR 2016 -- "Real-Time Single Image and Video
Super-Resolution Using an Efficient Sub-Pixel Convolutional Neural
Network") as a third model family.

Like FSRCNN it runs entirely at LOW resolution, but instead of a learned
transposed convolution it ends with a sub-pixel convolution: the last
layer emits scale^2 channels per LR pixel and a depth-to-space shuffle
rearranges them into the HR plane.  The shuffle is a pure
reshape/transpose, which XLA fuses into the final conv's epilogue --
there is no scatter and no stride-dilated conv anywhere, making this the
simplest upscale head of the three families.

Layers (paper notation): 5x5x(f1) tanh -> 3x3x(f2) tanh ->
3x3x(scale^2) linear -> pixel shuffle.  Replicate SAME padding.  The
external domain is [0,255] like the rest of the framework; internally
the input is affinely mapped to [-1,1] before the first tanh layer and
the linear head maps back (its bias starts at 127.5), so the tanh
layers operate in their active range.

The reference library covers only SRCNN 9-1-5
(`/root/reference/src/libsrcnn.cpp:350-529`); ESPCN is a beyond-reference
family.  Shipped weights: ``weights/espcn_x2.npz``, trained by
tools/train_espcn.py with the framework's own Mitchell-bicubic
degradation model (butterfly held out); :func:`load_params` restores
them.
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
class ESPCNSpec:
    scale: int = 2
    f1: int = 64   # feature channels, 5x5 layer
    f2: int = 32   # mapping channels, 3x3 layer

    @property
    def name(self) -> str:
        return f"espcn-x{self.scale}-f{self.f1}-{self.f2}"


def default_spec() -> ESPCNSpec:
    return ESPCNSpec()


def init_params(key: jax.Array, spec: ESPCNSpec = ESPCNSpec(),
                dtype=jnp.float32) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)

    def conv_init(k, kh, kw, cin, cout):
        # Glorot for tanh layers
        std = float(np.sqrt(2.0 / (kh * kw * cin + kh * kw * cout)))
        return jax.random.normal(k, (kh, kw, cin, cout), dtype) * std

    r2 = spec.scale * spec.scale
    return {
        "c1_w": conv_init(k1, 5, 5, 1, spec.f1),
        "c1_b": jnp.zeros((spec.f1,), dtype),
        "c2_w": conv_init(k2, 3, 3, spec.f1, spec.f2),
        "c2_b": jnp.zeros((spec.f2,), dtype),
        # linear sub-pixel head back to the [0,255] domain: weights scaled
        # so a unit feature moves the output O(100), bias at mid-gray
        "c3_w": conv_init(k3, 3, 3, spec.f2, r2) * 127.5,
        "c3_b": jnp.full((r2,), 127.5, dtype),
    }


@functools.lru_cache(maxsize=4)
def _load_cached(path: str):
    z = np.load(path)
    spec = ESPCNSpec(scale=int(z["meta_scale"]), f1=int(z["meta_f1"]),
                     f2=int(z["meta_f2"]))
    params = {k: jnp.asarray(z[k]) for k in z.files
              if not k.startswith("meta_")}
    return params, spec


def load_params(scale: int = 2, path: str | None = None,
                dtype=jnp.float32):
    """Load shipped (or checkpointed) ESPCN weights -> (params, spec)."""
    if path is None:
        path = os.path.join(WEIGHTS_DIR, f"espcn_x{scale}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped ESPCN weights for x{scale} ({path}); train "
                f"them with tools/train_espcn.py")
    params, spec = _load_cached(os.path.abspath(path))
    if dtype != jnp.float32:
        params = {k: v.astype(dtype) for k, v in params.items()}
    return params, spec


def _conv_same(x, w, precision=lax.Precision.HIGHEST,
               lane_pack: bool = False):
    from libsrcnn_tpu.ops import packed_conv

    return packed_conv.conv_same(x, w, precision, lane_pack)


def pixel_shuffle(x: jnp.ndarray, r: int) -> jnp.ndarray:
    """[N, H, W, r*r] -> [N, H*r, W*r]; channel k = (dy, dx) sub-pixel.

    Pure reshape+transpose (depth-to-space): XLA lowers it to a single
    copy fused with the producing conv -- the dense analog of the
    paper's "periodic shuffling" scatter.
    """
    n, h, w, c = x.shape
    assert c == r * r, (c, r)
    x = x.reshape(n, h, w, r, r)              # [..., dy, dx]
    x = x.transpose(0, 1, 3, 2, 4)            # [N, H, dy, W, dx]
    return x.reshape(n, h * r, w * r)


def lr_halo_width(spec: ESPCNSpec = ESPCNSpec(),
                  params: dict | None = None) -> int:
    """LR-domain receptive radius: c1 5x5 -> 2, c2/c3 3x3 -> 1 each (the
    pixel-shuffle head is purely local).  ``params`` (optional, protocol
    uniformity with fsrcnn) derives the radii from the checkpoint's
    actual kernel shapes.  Used by the gigapixel paths
    (libsrcnn_tpu/chunked.py, parallel/tiled.py)."""
    if params is None:
        return 4
    return sum(int(np.asarray(params[k]).shape[0]) // 2
               for k in ("c1_w", "c2_w", "c3_w"))


def forward_lr(params: dict, lr_y: jnp.ndarray,
               spec: ESPCNSpec = ESPCNSpec(), *, clamp: bool = True,
               precision=lax.Precision.HIGHEST, lane_pack: bool = False):
    """LR Y plane(s) [H, W] or [N, H, W] -> HR [scale*H, scale*W].

    ``precision``: HIGHEST = exact f32 (default); DEFAULT = the
    backend's fast f32 convs (TF32 tensor cores on the H100), the
    throughput tier.  ``lane_pack=True`` = packed convs at per-layer
    phase counts (see :mod:`libsrcnn_tpu.ops.packed_conv`)."""
    squeeze = lr_y.ndim == 2
    if squeeze:
        lr_y = lr_y[None]
    x = lr_y[..., None].astype(params["c1_w"].dtype)
    x = x * (1.0 / 127.5) - 1.0               # [0,255] -> [-1,1]

    h = jnp.tanh(_conv_same(x, params["c1_w"], precision, lane_pack)
                 + params["c1_b"])
    h = jnp.tanh(_conv_same(h, params["c2_w"], precision, lane_pack)
                 + params["c2_b"])
    h = _conv_same(h, params["c3_w"], precision, lane_pack) + params["c3_b"]
    out = pixel_shuffle(h, spec.scale).astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out


def forward_lr_halo(params: dict, ext: jnp.ndarray, flags,
                    spec: ESPCNSpec = ESPCNSpec(), *, halo: int | None
                    = None, precision=lax.Precision.HIGHEST):
    """Halo-aware forward for the explicit-tiled mesh path (see
    fsrcnn.forward_lr_halo for the scheme): replicate padding is
    re-imposed on the out-of-image ring at flagged true edges before
    every spatial conv reads it (normalize-then-replicate == replicate-
    then-normalize -- the map is pointwise).  No fix-up is needed after
    c3: the pixel-shuffle head is purely local and the ring is
    cropped."""
    from .fsrcnn import _edge_replicate

    if halo is None:
        halo = lr_halo_width(spec)
    r = spec.scale
    x = ext[None, :, :, None].astype(params["c1_w"].dtype)
    x = x * (1.0 / 127.5) - 1.0               # [0,255] -> [-1,1]
    x = _edge_replicate(x, flags, halo)

    h = jnp.tanh(_conv_same(x, params["c1_w"], precision) + params["c1_b"])
    h = _edge_replicate(h, flags, halo)
    h = jnp.tanh(_conv_same(h, params["c2_w"], precision) + params["c2_b"])
    h = _edge_replicate(h, flags, halo)
    h = _conv_same(h, params["c3_w"], precision) + params["c3_b"]
    out = pixel_shuffle(h, r)[0].astype(jnp.float32)
    c = halo * r
    out = out[c:out.shape[0] - c, c:out.shape[1] - c]
    return jnp.clip(out, 0.0, 255.0)


def make_loss_forward(spec: ESPCNSpec):
    """Adapter for :func:`libsrcnn_tpu.train.trainer.loss_fn` -- same
    (lr, hr) pair protocol as FSRCNN (see fsrcnn.make_lr_patch_batch,
    which is family-agnostic: it only reads ``spec.scale``)."""
    def forward(params, lr_y, clamp=False):
        return forward_lr(params, lr_y, spec, clamp=clamp)

    return forward
