"""FSRCNN (Dong et al., ECCV 2016 -- "Accelerating the Super-Resolution
Convolutional Neural Network") as a second model family.

Where SRCNN interpolates FIRST and then convolves at high resolution,
FSRCNN runs its feature stack at LOW resolution and upscales at the end
with a learned transposed convolution -- (scale^2)x fewer conv FLOPs.  No
pre-trained weights ship (the reference covers only SRCNN 9-1-5); this
family exists to be trained via :mod:`libsrcnn_tpu.train`:

>>> spec = FSRCNNSpec(scale=2)
>>> params = init_params(jax.random.key(0), spec)
>>> hr_y = forward_lr(params, lr_y, spec)     # [H, W] -> [2H, 2W]

Layers (paper notation d=56, s=12, m=4):
  feature extraction 5x5x(d) -> shrink 1x1x(s) -> m mapping 3x3x(s) ->
  expand 1x1x(d) -> deconv 9x9 stride=scale -> 1 channel.
PReLU activations (per-channel alpha), replicate padding, [0,255] domain.

Shipped weights: ``weights/fsrcnn_x2.npz``, trained by
tools/train_fsrcnn.py on the reference repo's castle.jpg plus two public
sample photos with the framework's own Mitchell-bicubic degradation model
(butterfly held out for validation); :func:`load_params` restores them.
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
class FSRCNNSpec:
    scale: int = 2
    d: int = 56   # feature dim
    s: int = 12   # shrink dim
    m: int = 4    # mapping depth

    @property
    def name(self) -> str:
        return f"fsrcnn-x{self.scale}-d{self.d}s{self.s}m{self.m}"


def default_spec() -> FSRCNNSpec:
    return FSRCNNSpec()


def init_params(key: jax.Array, spec: FSRCNNSpec = FSRCNNSpec(),
                dtype=jnp.float32) -> dict:
    ks = jax.random.split(key, 4 + spec.m)

    def conv_init(k, kh, kw, cin, cout):
        # He init for PReLU nets
        std = float(np.sqrt(2.0 / (kh * kw * cin)))
        return jax.random.normal(k, (kh, kw, cin, cout), dtype) * std

    params = {
        "feat_w": conv_init(ks[0], 5, 5, 1, spec.d),
        "feat_b": jnp.zeros((spec.d,), dtype),
        "feat_a": jnp.full((spec.d,), 0.25, dtype),
        "shrink_w": conv_init(ks[1], 1, 1, spec.d, spec.s),
        "shrink_b": jnp.zeros((spec.s,), dtype),
        "shrink_a": jnp.full((spec.s,), 0.25, dtype),
        "expand_w": conv_init(ks[2], 1, 1, spec.s, spec.d),
        "expand_b": jnp.zeros((spec.d,), dtype),
        "expand_a": jnp.full((spec.d,), 0.25, dtype),
        # transposed conv 9x9, stride=scale, d -> 1
        "deconv_w": conv_init(ks[3], 9, 9, spec.d, 1) * 0.1,
        "deconv_b": jnp.zeros((1,), dtype),
    }
    for i in range(spec.m):
        params[f"map{i}_w"] = conv_init(ks[4 + i], 3, 3, spec.s, spec.s)
        params[f"map{i}_b"] = jnp.zeros((spec.s,), dtype)
        params[f"map{i}_a"] = jnp.full((spec.s,), 0.25, dtype)
    return params


@functools.lru_cache(maxsize=4)
def _load_cached(path: str):
    z = np.load(path)
    spec = FSRCNNSpec(scale=int(z["meta_scale"]), d=int(z["meta_d"]),
                      s=int(z["meta_s"]), m=int(z["meta_m"]))
    params = {k: jnp.asarray(z[k]) for k in z.files
              if not k.startswith("meta_")}
    return params, spec


def load_params(scale: int = 2, path: str | None = None,
                dtype=jnp.float32):
    """Load shipped (or checkpointed) FSRCNN weights.

    Returns ``(params, spec)``; the spec is reconstructed from the
    checkpoint's metadata so callers never have to guess the architecture.
    """
    if path is None:
        path = os.path.join(WEIGHTS_DIR, f"fsrcnn_x{scale}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no shipped FSRCNN weights for x{scale} ({path}); train "
                f"them with tools/train_fsrcnn.py")
    params, spec = _load_cached(os.path.abspath(path))
    if dtype != jnp.float32:
        params = {k: v.astype(dtype) for k, v in params.items()}
    return params, spec


def _prelu(x, alpha):
    return jnp.where(x >= 0, x, x * alpha)


def _conv_same(x, w, precision=lax.Precision.HIGHEST,
               lane_pack: bool = False):
    from libsrcnn_tpu.ops import packed_conv

    return packed_conv.conv_same(x, w, precision, lane_pack)


@functools.lru_cache(maxsize=8)
def _subpixel_plan(k: int, r: int):
    """Static scatter plan turning a stride-``r`` transposed-conv kernel
    [k,k,Cin,1] into a stride-1 kernel [L,L,Cin,r*r] whose conv +
    depth-to-space computes the SAME-padded ``lax.conv_transpose``
    exactly (same per-pixel terms; order-of-addition differences only).

    Derivation: conv_transpose SAME == lhs_dilated conv with top/left pad
    ``pa = k-1-(k-r)//2``; output residue d (mod r) only sees kernel taps
    ``i = i0 + r*t`` with ``i0 = (pa-d) % r``, each reading input offset
    ``(d+i0-pa)//r + t`` -- a plain stride-1 conv per residue class.
    Returns (L, P, [(channel, sy, sx, wy, wx)]) tap placements.
    """
    pa = k - 1 - (k - r) // 2
    subs = []
    for d in range(r):
        i0 = (pa - d) % r
        subs.append((i0, (d + i0 - pa) // r, (k - i0 + r - 1) // r))
    P = max(-o for _, o, _ in subs)
    L = max(P + o + t for _, o, t in subs)
    taps = []
    for dy, (iy, oy, ty) in enumerate(subs):
        for dx, (ix, ox, tx) in enumerate(subs):
            for t_y in range(ty):
                for t_x in range(tx):
                    taps.append((dy * r + dx, P + oy + t_y, P + ox + t_x,
                                 iy + r * t_y, ix + r * t_x))
    return L, P, tuple(taps)


def _deconv_subpixel(h, w, r: int, precision, lane_pack: bool = False):
    """[N,H,W,Cin] x [k,k,Cin,1] -> [N,H*r,W*r,1], equal to
    ``lax.conv_transpose(h, w, (r,r), "SAME")`` computed the dense
    way: one dense stride-1 conv emitting the r*r sub-pixel phases,
    then a depth-to-space reshuffle.  The plan derivation assumes every
    output phase sees at least one kernel tap (k >= r); a hypothetical
    head with stride beyond its kernel falls back to the slow-but-correct
    lowering rather than silently diverging."""
    from .espcn import pixel_shuffle

    k, cin = w.shape[0], w.shape[2]
    if k < r:
        return lax.conv_transpose(
            h, w, (r, r), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32,
            precision=precision)
    L, P, taps = _subpixel_plan(k, r)
    c, sy, sx, wy, wx = (np.asarray(a) for a in zip(*taps))
    w2 = jnp.zeros((L, L, cin, r * r), w.dtype)
    w2 = w2.at[sy, sx, :, c].set(w[wy, wx, :, 0])
    if lane_pack:
        # r*r output channels: the lane-packed formulation widens
        # this head's output by packing columns into channels.
        from libsrcnn_tpu.ops import packed_conv
        p = packed_conv.best_phases(L, r * r)
        if p > 1:
            up = packed_conv.packed_conv(
                h, w2, p, ((P, L - 1 - P),) * 2, precision)
            return pixel_shuffle(up, r)[..., None]
    up = lax.conv_general_dilated(
        h, w2, (1, 1), [(P, L - 1 - P)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
        precision=precision)
    return pixel_shuffle(up, r)[..., None]


def lr_halo_width(spec: FSRCNNSpec = FSRCNNSpec(),
                  params: dict | None = None) -> int:
    """LR-domain receptive radius of the whole stack: how many REAL
    neighbor LR rows a band needs on each side so that its cropped output
    rows are bit-identical to the full-frame forward (the 1x1 shrink /
    expand layers contribute nothing).  feat 5x5 -> 2, the m mapping
    3x3 convs -> m, and the sub-pixel deconv's stride-1 LxL conv ->
    max(P, L-1-P) (its asymmetric SAME padding, see _subpixel_plan).
    The spec carries no deconv kernel size (init_params fixes 9x9), so
    pass ``params`` to derive it from the checkpoint's actual
    ``deconv_w`` -- the chunked/tiled paths do, keeping the halo honest
    for any hypothetical non-9x9 head.  Used by the gigapixel paths
    (libsrcnn_tpu/chunked.py, parallel/tiled.py)."""
    k = 9 if params is None else int(np.asarray(params["deconv_w"]).shape[0])
    L, P, _ = _subpixel_plan(k, spec.scale)
    return 2 + spec.m + max(P, L - 1 - P)


def forward_lr(params: dict, lr_y: jnp.ndarray,
               spec: FSRCNNSpec = FSRCNNSpec(), *, clamp: bool = True,
               precision=lax.Precision.HIGHEST, lane_pack: bool = False):
    """LR Y plane(s) [H, W] or [N, H, W] -> HR [scale*H, scale*W].

    ``precision``: HIGHEST = exact f32 (default); DEFAULT = the
    backend's fast f32 convs (TF32 tensor cores on the H100), the
    throughput tier.

    ``lane_pack=True`` runs every spatial conv (and the sub-pixel
    deconv) through :mod:`libsrcnn_tpu.ops.packed_conv` at its
    phase count -- same f32 MACs, different reduction order (see that
    module)."""
    squeeze = lr_y.ndim == 2
    if squeeze:
        lr_y = lr_y[None]
    x = lr_y[..., None].astype(params["feat_w"].dtype)

    h = _prelu(_conv_same(x, params["feat_w"], precision, lane_pack)
               + params["feat_b"], params["feat_a"])
    h = _prelu(_conv_same(h, params["shrink_w"], precision)
               + params["shrink_b"], params["shrink_a"])
    for i in range(spec.m):
        h = _prelu(_conv_same(h, params[f"map{i}_w"], precision, lane_pack)
                   + params[f"map{i}_b"], params[f"map{i}_a"])
    h = _prelu(_conv_same(h, params["expand_w"], precision)
               + params["expand_b"], params["expand_a"])

    # learned upscale: transposed conv, stride = scale, SAME-style output.
    # Computed as its sub-pixel equivalent (stride-1 conv emitting scale^2
    # channels + depth-to-space): XLA lowers `lax.conv_transpose` through
    # input dilation, which the first target measured ~16x slower than
    # the dense reformulation (ROADMAP D7 re-measures it on the GPU);
    # the two are the same per-pixel sums.
    up = _deconv_subpixel(h, params["deconv_w"], spec.scale, precision,
                          lane_pack)
    out = (up + params["deconv_b"])[..., 0].astype(jnp.float32)
    if clamp:
        out = jnp.clip(out, 0.0, 255.0)
    return out[0] if squeeze else out


def _edge_replicate(x, flags, halo: int):
    """Re-impose the stack's edge-replicate padding on the out-of-image
    halo ring at flagged TRUE edges (flags [4] = top, bottom, left,
    right) of an [N, H, W, C] activation: ring rows/cols take the true
    edge row/col's value (rows first, then columns, so corners get the
    corner value -- jnp.pad edge-mode order).  Applying this after every
    layer whose output a SPATIAL conv reads reproduces the full frame's
    per-layer ``conv_same`` replicate padding, while unflagged sides
    keep the exchanged REAL neighbor values."""
    H, W = x.shape[1], x.shape[2]
    ri = jnp.arange(H)[None, :, None, None]
    x = jnp.where((flags[0] == 1) & (ri < halo),
                  jax.lax.slice_in_dim(x, halo, halo + 1, axis=1), x)
    x = jnp.where((flags[1] == 1) & (ri >= H - halo),
                  jax.lax.slice_in_dim(x, H - halo - 1, H - halo, axis=1), x)
    ci = jnp.arange(W)[None, None, :, None]
    x = jnp.where((flags[2] == 1) & (ci < halo),
                  jax.lax.slice_in_dim(x, halo, halo + 1, axis=2), x)
    x = jnp.where((flags[3] == 1) & (ci >= W - halo),
                  jax.lax.slice_in_dim(x, W - halo - 1, W - halo, axis=2), x)
    return x


def _edge_zero(x, flags, halo: int):
    """Zero the out-of-image halo ring at flagged TRUE edges -- the
    fix-up for layers whose padding is zeros (the sub-pixel deconv's
    explicit conv padding), where :func:`_edge_replicate` is for the
    ``conv_same`` replicate layers."""
    H, W = x.shape[1], x.shape[2]
    ri = jnp.arange(H)
    ci = jnp.arange(W)
    rmask = (((flags[0] == 0) | (ri >= halo))
             & ((flags[1] == 0) | (ri < H - halo)))
    cmask = (((flags[2] == 0) | (ci >= halo))
             & ((flags[3] == 0) | (ci < W - halo)))
    return x * (rmask[:, None] & cmask[None, :])[None, :, :, None].astype(
        x.dtype)


def forward_lr_halo(params: dict, ext: jnp.ndarray, flags,
                    spec: FSRCNNSpec = FSRCNNSpec(), *, halo: int | None
                    = None, precision=lax.Precision.HIGHEST):
    """Halo-aware forward for the explicit-tiled mesh path: ``ext`` [H, W]
    is the shard's LR plane extended by ``halo`` exchanged pixels on
    EVERY side (uniform shard_map shape); ``flags`` [4] mark which of its
    borders are true image edges, where the halo ring lies outside the
    image and gets the stack's replicate padding re-imposed before every spatial
    conv reads it (see :func:`_edge_replicate`).  Returns the shard's own
    output tile [(H-2*halo)*r, (W-2*halo)*r], bit-identical to the
    full-frame :func:`forward_lr` restricted to the shard (direct convs;
    the lane-packed reduction order is plane-shape-dependent)."""
    if halo is None:
        halo = lr_halo_width(spec)
    r = spec.scale
    x = ext[None, :, :, None].astype(params["feat_w"].dtype)
    x = _edge_replicate(x, flags, halo)

    h = _prelu(_conv_same(x, params["feat_w"], precision)
               + params["feat_b"], params["feat_a"])
    h = _edge_replicate(h, flags, halo)
    h = _prelu(_conv_same(h, params["shrink_w"], precision)
               + params["shrink_b"], params["shrink_a"])
    h = _edge_replicate(h, flags, halo)
    for i in range(spec.m):
        h = _prelu(_conv_same(h, params[f"map{i}_w"], precision)
                   + params[f"map{i}_b"], params[f"map{i}_a"])
        h = _edge_replicate(h, flags, halo)
    h = _prelu(_conv_same(h, params["expand_w"], precision)
               + params["expand_b"], params["expand_a"])
    # the deconv's explicit conv padding is ZEROS (unlike the conv_same
    # layers' replicate) -- so beyond a true edge its input must be 0,
    # exactly what the full-frame deconv's own padding supplies there
    h = _edge_zero(h, flags, halo)

    up = _deconv_subpixel(h, params["deconv_w"], r, precision)
    out = (up + params["deconv_b"])[0, :, :, 0].astype(jnp.float32)
    c = halo * r
    out = out[c:out.shape[0] - c, c:out.shape[1] - c]
    return jnp.clip(out, 0.0, 255.0)


def make_loss_forward(spec: FSRCNNSpec):
    """Adapter for :func:`libsrcnn_tpu.train.trainer.loss_fn`: FSRCNN
    consumes the RAW low-resolution plane, so training pairs are
    (lr_small_y, hr_y) with hr = scale * lr.  Use
    ``make_lr_patch_batch`` below to build them."""
    def forward(params, lr_y, clamp=False):
        return forward_lr(params, lr_y, spec, clamp=clamp)

    return forward


def make_lr_patch_batch(images, batch_size: int, patch: int = 16,
                        spec: FSRCNNSpec = FSRCNNSpec(), seed: int = 0,
                        filter_type=None):
    """(lr [B,p,p], hr [B,s*p,s*p]) pairs: HR crops + classical downscale."""
    from ..config import FilterType
    from ..ops import color, resize

    if filter_type is None:
        filter_type = FilterType.BICUBIC
    rng = np.random.default_rng(seed)
    sp = patch * spec.scale
    lr = np.empty((batch_size, patch, patch), np.float32)
    hr = np.empty((batch_size, sp, sp), np.float32)
    for b in range(batch_size):
        img = images[rng.integers(len(images))]
        h, w = img.shape[:2]
        if h < sp or w < sp:
            raise ValueError(f"image {h}x{w} smaller than HR patch {sp}")
        r = rng.integers(h - sp + 1)
        c = rng.integers(w - sp + 1)
        crop = img[r:r + sp, c:c + sp]
        hr_y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(crop))[0])
        lr[b] = np.asarray(resize.resize_plane(
            jnp.asarray(hr_y), patch, patch, filter_type))
        hr[b] = hr_y
    return lr, hr
