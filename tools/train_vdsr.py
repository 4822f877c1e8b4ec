#!/usr/bin/env python3
"""Train the shipped VDSR weights (scale-agnostic HR-domain family).

VDSR (Kim et al., CVPR 2016) refines an ALREADY-INTERPOLATED Y plane, so
training pairs are (bicubic-upscaled, ground-truth) patches at the SAME
size, and one checkpoint serves every factor.  Following the paper's
multi-scale recipe, the pool mixes degradations at x2/x3/x4: each HR
patch is downscaled by 1/s and bicubic-upscaled back with the
framework's reference-exact resampler (ops.resize), so the training
degradation matches inference exactly.

Corpus and held-out protocol match tools/train_fsrcnn.py: castle +
scikit-learn photos train, butterfly validates; the best-butterfly
checkpoint ships.

Run (on the GPU; the CPU works but is far slower for the deep stack):
    python tools/train_vdsr.py
    JAX_PLATFORMS=cpu python tools/train_vdsr.py --steps=800
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from train_fsrcnn import corpus_images, dihedral_variants  # noqa: E402

WEIGHTS_OUT = os.path.join(os.path.dirname(__file__), "..", "libsrcnn_tpu",
                           "models", "weights", "vdsr.npz")

SCALES = (2, 3, 4)


def build_pair_pool(images, n_patches: int, patch: int, seed: int = 0,
                    content_scales: tuple = (), base_frac: float = 0.0):
    """(interp [N,p,p], hr [N,p,p]) with the x2/x3/x4 degradations mixed.

    ``patch`` must be divisible by every scale (lcm 12) so the LR sizes
    are exact and the round trip uses the same weights-table math as
    inference.
    """
    import jax

    assert all(patch % s == 0 for s in SCALES), patch

    # One-time host work: every distinct resize shape below would cost a
    # device compile; the CPU backend computes the same table-gather math
    # in milliseconds (f32 rounding may differ from the device's by ~1e-7
    # rel — irrelevant for a training pool).
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return _build_pair_pool_on(images, n_patches, patch, seed,
                                   content_scales, base_frac)


def _build_pair_pool_on(images, n_patches: int, patch: int, seed: int,
                        content_scales: tuple, base_frac: float = 0.0):
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.ops import color, resize

    planes = []
    n_base_planes = 0
    for i, img in enumerate(images):
        y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
        # optional multi-scale CONTENT augmentation (VDSR paper trains on
        # multiple scales of each image): downscaled copies contribute
        # different texture statistics from the same pixels, the standard
        # remedy when the corpus is tiny.  The degradation model of the
        # PAIRS is untouched (still the reference-exact bicubic round
        # trip below).  Off by default: the shipped checkpoint was
        # trained without it.
        versions = [y]
        for f in content_scales:
            if not 0.0 < f < 1.0:
                raise ValueError(f"content scale {f} must be in (0, 1)")
            vh, vw = int(y.shape[0] * f), int(y.shape[1] * f)
            if vh < patch or vw < patch:
                continue  # too small to crop a patch from -- skip
            versions.append(np.asarray(resize.resize_plane(
                jnp.asarray(y), vh, vw, FilterType.BICUBIC)))
        for v in versions:
            planes.extend(dihedral_variants(v))
        if i < 3:   # tools/corpus.py lists the base photos first
            n_base_planes = len(planes)

    rng = np.random.default_rng(seed)
    hr = np.empty((n_patches, patch, patch), np.float32)
    for i in range(n_patches):
        # base_frac > 0: draw that fraction of patches from the base
        # photos regardless of the texture set's pixel majority (the
        # held-out validation is a natural photo; an unweighted draw from
        # an extended corpus is 95% textures)
        if base_frac > 0.0 and rng.random() < base_frac:
            y = planes[rng.integers(n_base_planes)]
        else:
            y = planes[rng.integers(len(planes))]
        r = rng.integers(y.shape[0] - patch + 1)
        c = rng.integers(y.shape[1] - patch + 1)
        hr[i] = y[r:r + patch, c:c + patch]

    interp = np.empty_like(hr)
    for s in SCALES:  # round-trip each third of the pool at one factor
        sel = np.arange(n_patches) % len(SCALES) == SCALES.index(s)
        down = jax.jit(jax.vmap(functools.partial(
            resize.resize_plane, dst_h=patch // s, dst_w=patch // s,
            filter_type=FilterType.BICUBIC)))
        up = jax.jit(jax.vmap(functools.partial(
            resize.resize_plane, dst_h=patch, dst_w=patch,
            filter_type=FilterType.BICUBIC)))
        idx = np.nonzero(sel)[0]
        for i in range(0, len(idx), 512):
            j = idx[i:i + 512]
            interp[j] = np.asarray(up(down(jnp.asarray(hr[j]))))
    return interp, hr


def validation_psnr(params, spec, scale: int = 2):
    """Held-out butterfly at ``scale``: VDSR-refined vs plain bicubic."""
    import jax.numpy as jnp
    from PIL import Image

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.eval.metrics import psnr
    from libsrcnn_tpu.models import vdsr
    from libsrcnn_tpu.ops import color, resize

    img = np.asarray(Image.open(
        "/root/reference/Pictures/butterfly.png").convert("RGB"))
    hr_y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
    s = scale
    hr_y = hr_y[:hr_y.shape[0] // s * s, :hr_y.shape[1] // s * s]
    h, w = hr_y.shape
    lr_y = resize.resize_plane(jnp.asarray(hr_y), h // s, w // s,
                               FilterType.BICUBIC)
    bic = resize.resize_plane(lr_y, h, w, FilterType.BICUBIC)
    sr = np.asarray(vdsr.forward_hr(params, bic, spec))
    return psnr(sr, hr_y), psnr(np.clip(np.asarray(bic), 0, 255), hr_y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--patch", type=int, default=36,
                    help="patch size (must be divisible by 2, 3 and 4)")
    ap.add_argument("--pool", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--ch", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--content-scales", default="",
                    help="comma-separated extra content zooms for the "
                         "pool (e.g. '0.7,0.5'); empty = shipped recipe")
    ap.add_argument("--corpus", choices=("base", "extended"),
                    default="extended",
                    help="base = round-3 3-photo corpus; extended adds "
                         "the curated in-container textures (tools/corpus.py)")
    ap.add_argument("--base-frac", type=float, default=0.0,
                    help="fraction of patches forced to the base photos "
                         "(0 = uniform over all planes)")
    ap.add_argument("--lane-pack", type=int, default=0,
                    help="train through the lane-packed formulation "
                         "(ops/packed_conv.py; 0 = direct convs; 4 = "
                         "the packing's ch=32 phase count)")
    ap.add_argument("--out", default=os.path.abspath(WEIGHTS_OUT))
    args = ap.parse_args(argv)

    import jax
    import optax

    from libsrcnn_tpu.models import vdsr
    from libsrcnn_tpu.train import trainer

    spec = vdsr.VDSRSpec(depth=args.depth, ch=args.ch)
    images = corpus_images(extended=args.corpus == "extended")
    print(f"corpus: {len(images)} images, butterfly held out; "
          f"model {spec.name}", flush=True)
    cscales = tuple(float(f) for f in args.content_scales.split(",") if f)
    interp_pool, hr_pool = build_pair_pool(images, args.pool, args.patch,
                                           args.seed, cscales,
                                           args.base_frac)
    print(f"pool: {args.pool} same-size pairs {args.patch}^2, "
          f"scales {SCALES} mixed", flush=True)

    params = vdsr.init_params(jax.random.key(args.seed), spec)
    n_params = sum(int(np.prod(v.shape)) for v in params.values())
    print(f"params: {n_params}")
    # VDSR recipe: high lr + gradient clipping (the residual path keeps
    # early training stable; clipping guards the deep stack)
    schedule = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    t = trainer.Trainer(params=params, forward=vdsr.make_loss_forward(
        spec, lane_pack=max(args.lane_pack, 1)))
    t.optimizer = optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adam(schedule))
    t.opt_state = t.optimizer.init(t.params)

    rng = np.random.default_rng(args.seed + 1)
    best = (-1.0, None, -1)

    losses = []
    for step in range(1, args.steps + 1):
        idx = rng.integers(args.pool, size=args.batch)
        losses.extend(t.fit([(interp_pool[idx], hr_pool[idx])]))
        if step % args.eval_every == 0 or step == args.steps:
            vals = [validation_psnr(t.params, spec, s) for s in SCALES]
            mean_sr = float(np.mean([v[0] for v in vals]))
            mark = ""
            if mean_sr > best[0]:
                best = (mean_sr, jax.tree.map(np.asarray, t.params), step)
                mark = " *"
                # persist the best-so-far immediately: a run that dies
                # must still leave its best checkpoint on disk
                np.savez(args.out + ".part", **best[1],
                         meta_depth=np.int32(spec.depth),
                         meta_ch=np.int32(spec.ch),
                         meta_step=np.int32(step),
                         meta_val_psnr=np.float32(mean_sr))
            detail = "  ".join(
                f"x{s} {v[0]:.2f}({v[0] - v[1]:+.2f})"
                for s, v in zip(SCALES, vals))
            print(f"step {step}: loss "
                  f"{np.mean(losses[-args.eval_every:]):.2f}  butterfly "
                  f"{detail}{mark}", flush=True)

    mean_sr, params_np, step = best
    assert params_np is not None
    print(f"best @ step {step}: mean butterfly PSNR {mean_sr:.2f} dB")
    np.savez(args.out, **params_np,
             meta_depth=np.int32(spec.depth), meta_ch=np.int32(spec.ch),
             meta_step=np.int32(step), meta_val_psnr=np.float32(mean_sr))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
