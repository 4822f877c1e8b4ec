#!/usr/bin/env python3
"""Train the shipped FSRCNN x2 weights.

The reference ships only the SRCNN 9-1-5 weights (`convdata.h`); FSRCNN is
the framework's beyond-reference model family and its weights are trained
here, with the framework's own components end to end: the reference-exact
Mitchell-bicubic resampler (ops.resize) builds the LR/HR pairs, the JPEG
color transform (ops.color) extracts Y, and train.Trainer runs the sharded
step.  The degradation model therefore matches inference exactly.

Corpus: castle.jpg from the reference repo plus scikit-learn's two sample
photos (china.jpg, flower.jpg) -- small but sufficient for a 12.5k-param
model.  butterfly.png is HELD OUT and used as the validation image; the
checkpoint with the best butterfly PSNR is written.

Run (CPU, ~10 min at the default 6000 steps):
    JAX_PLATFORMS=cpu python tools/train_fsrcnn.py
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WEIGHTS_OUT = os.path.join(os.path.dirname(__file__), "..", "libsrcnn_tpu",
                           "models", "weights", "fsrcnn_x2.npz")


def corpus_images(extended: bool = False) -> list[np.ndarray]:
    """Training images as RGB u8 (butterfly is held out for validation).

    ``extended=True`` adds the curated in-container texture set (see
    tools/corpus.py) -- ~50x the pixel count of the 3 base photos."""
    import corpus

    return corpus.corpus_images(extended=extended)


def dihedral_variants(y: np.ndarray) -> list[np.ndarray]:
    """All 8 flip/rotation variants of a plane (standard SR augmentation)."""
    out = []
    for k in range(4):
        r = np.rot90(y, k)
        out.append(r)
        out.append(r[:, ::-1])
    return [np.ascontiguousarray(v) for v in out]


def build_patch_pool(images, n_patches: int, patch: int, scale: int,
                     seed: int = 0, base_frac: float = 0.0):
    """Pre-generate (lr [N,p,p], hr [N,s*p,s*p]) with batched downscale."""
    import jax

    # one-time host work: the pool resizes run on the CPU (each distinct
    # shape would be a device compile; the CPU does the math in ms)
    with jax.default_device(jax.devices("cpu")[0]):
        return _build_patch_pool_on(images, n_patches, patch, scale, seed,
                                    base_frac)


def _build_patch_pool_on(images, n_patches, patch, scale, seed,
                         base_frac=0.0):
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.ops import color, resize

    planes = []
    n_base_planes = 0
    for i, img in enumerate(images):
        y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
        planes.extend(dihedral_variants(y))
        if i < 3:   # tools/corpus.py lists the base photos first
            n_base_planes = len(planes)

    rng = np.random.default_rng(seed)
    sp = patch * scale
    hr = np.empty((n_patches, sp, sp), np.float32)
    for i in range(n_patches):
        # base_frac > 0: force that fraction of patches onto the base
        # photos -- an unweighted draw from the extended corpus is ~95%
        # textures and floods the natural-photo gradient signal (the
        # same knob as tools/train_vdsr.py)
        if base_frac > 0.0 and rng.random() < base_frac:
            y = planes[rng.integers(n_base_planes)]
        else:
            y = planes[rng.integers(len(planes))]
        r = rng.integers(y.shape[0] - sp + 1)
        c = rng.integers(y.shape[1] - sp + 1)
        hr[i] = y[r:r + sp, c:c + sp]

    down = jax.jit(jax.vmap(functools.partial(
        resize.resize_plane, dst_h=patch, dst_w=patch,
        filter_type=FilterType.BICUBIC)))
    lr = np.empty((n_patches, patch, patch), np.float32)
    for i in range(0, n_patches, 512):
        lr[i:i + 512] = np.asarray(down(jnp.asarray(hr[i:i + 512])))
    return lr, hr


def validation_psnr(params, spec):
    """PSNR on held-out butterfly: FSRCNN vs classical bicubic x2."""
    import jax.numpy as jnp
    from PIL import Image

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.eval.metrics import psnr
    from libsrcnn_tpu.models import fsrcnn
    from libsrcnn_tpu.ops import color, resize

    img = np.asarray(Image.open(
        "/root/reference/Pictures/butterfly.png").convert("RGB"))
    hr_y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
    s = spec.scale
    hr_y = hr_y[:hr_y.shape[0] // s * s, :hr_y.shape[1] // s * s]
    h, w = hr_y.shape
    lr_y = resize.resize_plane(jnp.asarray(hr_y), h // s, w // s,
                               FilterType.BICUBIC)
    sr = np.asarray(fsrcnn.forward_lr(params, lr_y, spec))
    bic = np.asarray(resize.resize_plane(lr_y, h, w, FilterType.BICUBIC))
    return psnr(sr, hr_y), psnr(np.clip(bic, 0, 255), hr_y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--patch", type=int, default=24, help="LR patch size")
    ap.add_argument("--pool", type=int, default=8192, help="patch pool size")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=2,
                    help="upscale factor (weights file is per-scale)")
    ap.add_argument("--corpus", choices=("base", "extended"),
                    default="extended",
                    help="base = round-3 3-photo corpus; extended adds "
                         "the curated in-container textures (tools/corpus.py)")
    ap.add_argument("--base-frac", type=float, default=0.5,
                    help="fraction of patches forced to the base photos "
                         "(0 = uniform over all planes; ignored for "
                         "--corpus=base)")
    ap.add_argument("--out", default=None,
                    help="output npz (default: shipped fsrcnn_x{scale}.npz)")
    ap.add_argument("--init-from", default=None,
                    help="npz checkpoint to fine-tune from instead of a "
                         "fresh init (meta_* keys ignored; the written "
                         "meta_step is cumulative, and the starting "
                         "checkpoint seeds the best-so-far so the output "
                         "never regresses below it)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.abspath(
            WEIGHTS_OUT.replace("_x2", f"_x{args.scale}"))

    import jax
    import jax.numpy as jnp
    import optax

    from libsrcnn_tpu.models import fsrcnn
    from libsrcnn_tpu.train import trainer

    spec = fsrcnn.FSRCNNSpec(scale=args.scale)
    images = corpus_images(extended=args.corpus == "extended")
    print(f"corpus: {len(images)} images "
          f"({sum(i.shape[0] * i.shape[1] for i in images) / 1e6:.2f} MP), "
          f"butterfly held out")
    base_frac = args.base_frac if args.corpus == "extended" else 0.0
    lr_pool, hr_pool = build_patch_pool(images, args.pool, args.patch,
                                        spec.scale, args.seed, base_frac)
    print(f"pool: {args.pool} patches {args.patch}->{args.patch * spec.scale}")

    base_step = 0
    if args.init_from:
        ck = np.load(args.init_from)
        params = {k: ck[k] for k in ck.files if not k.startswith("meta_")}
        base_step = int(ck["meta_step"]) if "meta_step" in ck.files else 0
    else:
        params = fsrcnn.init_params(jax.random.key(args.seed), spec)
    # cosine decay stabilizes the deconv layer late in training
    schedule = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    t = trainer.Trainer(params=params, forward=fsrcnn.make_loss_forward(spec))
    t.optimizer = optax.adam(schedule)
    t.opt_state = t.optimizer.init(t.params)

    rng = np.random.default_rng(args.seed + 1)
    best = (-1.0, None, -1)
    if args.init_from:
        p0, _ = validation_psnr(params, spec)
        best = (p0, jax.tree.map(np.asarray, params), 0)
        print(f"init from {args.init_from}: butterfly {p0:.2f} dB "
              f"@ cumulative step {base_step}", flush=True)

    def batches():
        for _ in range(args.steps):
            idx = rng.integers(args.pool, size=args.batch)
            yield lr_pool[idx], hr_pool[idx]

    it = batches()
    losses = []
    for step in range(1, args.steps + 1):
        losses.extend(t.fit([next(it)]))
        if step % args.eval_every == 0 or step == args.steps:
            p_sr, p_bic = validation_psnr(t.params, spec)
            mark = ""
            if p_sr > best[0]:
                best = (p_sr, jax.tree.map(np.asarray, t.params), step)
                mark = " *"
                np.savez(args.out + ".part", **best[1],
                         meta_scale=np.int32(spec.scale),
                         meta_d=np.int32(spec.d), meta_s=np.int32(spec.s),
                         meta_m=np.int32(spec.m),
                         meta_step=np.int32(base_step + step),
                         meta_val_psnr=np.float32(p_sr))
            print(f"step {step}: loss {np.mean(losses[-args.eval_every:]):.2f}"
                  f"  butterfly PSNR {p_sr:.2f} dB (bicubic {p_bic:.2f}){mark}",
                  flush=True)

    p_sr, params_np, step = best
    assert params_np is not None
    _, p_bic = validation_psnr(params_np, spec)
    print(f"best @ step {step}: {p_sr:.2f} dB vs bicubic {p_bic:.2f} dB "
          f"({p_sr - p_bic:+.2f})")
    np.savez(args.out, **params_np,
             meta_scale=np.int32(spec.scale), meta_d=np.int32(spec.d),
             meta_s=np.int32(spec.s), meta_m=np.int32(spec.m),
             meta_step=np.int32(base_step + step),
             meta_val_psnr=np.float32(p_sr))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
