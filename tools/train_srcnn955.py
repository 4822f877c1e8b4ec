#!/usr/bin/env python3
"""Train the shipped SRCNN 9-5-5 head (the ``srcnn955`` model family).

Dong et al. (ECCV 2014 / PAMI 2015) rate the 9-5-5 variant above the
9-1-5 the reference bakes into `convdata.h`; this trains one on the
framework's own components, exactly like the other families: the
reference-exact Mitchell-bicubic resampler builds the degraded inputs,
the JPEG color transform extracts Y, train.Trainer runs the step.  The
family is HR-domain (refines the ALREADY-INTERPOLATED plane), so pairs
are same-size (interp, hr) patches with the x2/x3/x4 degradations mixed
-- one checkpoint serves every factor, as the reference's own single
weight set does.

Corpus and held-out protocol match the other trainers: the extended
in-container corpus trains (tools/corpus.py), butterfly validates, the
best-butterfly checkpoint ships.

Run (on the GPU or, slower, the CPU):
    python tools/train_srcnn955.py
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from train_fsrcnn import corpus_images  # noqa: E402
from train_vdsr import SCALES, build_pair_pool  # noqa: E402

WEIGHTS_OUT = os.path.join(os.path.dirname(__file__), "..", "libsrcnn_tpu",
                           "models", "weights", "srcnn955.npz")


def validation_psnr(params, spec, scale: int = 2):
    """Held-out butterfly at ``scale``: 9-5-5-refined vs plain bicubic."""
    import jax.numpy as jnp
    from PIL import Image

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.eval.metrics import psnr
    from libsrcnn_tpu.models import srcnn_generic
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
    sr = np.asarray(srcnn_generic.forward_hr(params, bic, spec))
    return psnr(sr, hr_y), psnr(np.clip(np.asarray(bic), 0, 255), hr_y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--patch", type=int, default=36,
                    help="patch size (must be divisible by 2, 3 and 4)")
    ap.add_argument("--pool", type=int, default=16384)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--f2", type=int, default=5, help="layer-2 kernel (5 or 3)")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", choices=("base", "extended"),
                    default="extended")
    ap.add_argument("--base-frac", type=float, default=0.5,
                    help="fraction of patches forced to the base photos "
                         "(the held-out validation is a natural photo; "
                         "uniform draw from the extended corpus is 95% "
                         "textures and floods the gradient signal)")
    ap.add_argument("--out", default=os.path.abspath(WEIGHTS_OUT))
    args = ap.parse_args(argv)

    import jax
    import optax

    from libsrcnn_tpu.models import srcnn_generic
    from libsrcnn_tpu.train import trainer

    spec = srcnn_generic.ModelSpec(f2=args.f2)
    images = corpus_images(extended=args.corpus == "extended")
    print(f"corpus: {len(images)} images "
          f"({sum(i.shape[0] * i.shape[1] for i in images) / 1e6:.1f} MP), "
          f"butterfly held out; model {spec.name} "
          f"({spec.param_count()} params)", flush=True)
    interp_pool, hr_pool = build_pair_pool(images, args.pool, args.patch,
                                           args.seed,
                                           base_frac=args.base_frac)
    print(f"pool: {args.pool} same-size pairs {args.patch}^2, "
          f"scales {SCALES} mixed", flush=True)

    params = srcnn_generic.init_params(jax.random.key(args.seed), spec)
    # no residual path in this family: warm up the lr, then cosine-decay
    # (plain SRCNN trains slower than VDSR -- the identity must be learned)
    warmup = min(200, max(1, args.steps // 10))
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1),
        end_value=args.lr * 0.02)
    t = trainer.Trainer(params=params,
                        forward=srcnn_generic.make_loss_forward(spec))
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
                np.savez(args.out + ".part", **best[1],
                         meta_f1=np.int32(spec.f1), meta_n1=np.int32(spec.n1),
                         meta_f2=np.int32(spec.f2), meta_n2=np.int32(spec.n2),
                         meta_f3=np.int32(spec.f3),
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
             meta_f1=np.int32(spec.f1), meta_n1=np.int32(spec.n1),
             meta_f2=np.int32(spec.f2), meta_n2=np.int32(spec.n2),
             meta_f3=np.int32(spec.f3),
             meta_step=np.int32(step), meta_val_psnr=np.float32(mean_sr))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
