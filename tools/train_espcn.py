#!/usr/bin/env python3
"""Train the shipped ESPCN x2 weights.

Same regime as tools/train_fsrcnn.py (whose corpus/pool/validation helpers
are reused): the framework's own Mitchell-bicubic resampler builds the
LR/HR pairs, butterfly.png is held out for validation, and the checkpoint
with the best butterfly PSNR is written.

Run (CPU, ~10 min at the default 6000 steps):
    JAX_PLATFORMS=cpu python tools/train_espcn.py
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WEIGHTS_OUT = os.path.join(os.path.dirname(__file__), "..", "libsrcnn_tpu",
                           "models", "weights", "espcn_x2.npz")


def validation_psnr(params, spec):
    """PSNR on held-out butterfly: ESPCN vs classical bicubic x2."""
    import jax.numpy as jnp
    from PIL import Image

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.eval.metrics import psnr
    from libsrcnn_tpu.models import espcn
    from libsrcnn_tpu.ops import color, resize

    img = np.asarray(Image.open(
        "/root/reference/Pictures/butterfly.png").convert("RGB"))
    hr_y = np.asarray(color.rgb_to_ycbcr(jnp.asarray(img))[0])
    s = spec.scale
    hr_y = hr_y[:hr_y.shape[0] // s * s, :hr_y.shape[1] // s * s]
    h, w = hr_y.shape
    lr_y = resize.resize_plane(jnp.asarray(hr_y), h // s, w // s,
                               FilterType.BICUBIC)
    sr = np.asarray(espcn.forward_lr(params, lr_y, spec))
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
    ap.add_argument("--corpus", choices=("base", "extended"),
                    default="extended",
                    help="base = round-3 3-photo corpus; extended adds "
                         "the curated in-container textures (tools/corpus.py)")
    ap.add_argument("--base-frac", type=float, default=0.5,
                    help="fraction of patches forced to the base photos "
                         "(0 = uniform over all planes; ignored for "
                         "--corpus=base)")
    ap.add_argument("--scale", type=int, default=2,
                    help="upscale factor (weights file is per-scale)")
    ap.add_argument("--out", default=None,
                    help="output npz (default: shipped espcn_x{scale}.npz)")
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
    import optax

    import train_fsrcnn as shared
    from libsrcnn_tpu.models import espcn
    from libsrcnn_tpu.train import trainer

    spec = espcn.ESPCNSpec(scale=args.scale)
    images = shared.corpus_images(extended=args.corpus == "extended")
    print(f"corpus: {len(images)} images "
          f"({sum(i.shape[0] * i.shape[1] for i in images) / 1e6:.2f} MP), "
          f"butterfly held out")
    base_frac = args.base_frac if args.corpus == "extended" else 0.0
    lr_pool, hr_pool = shared.build_patch_pool(images, args.pool, args.patch,
                                               spec.scale, args.seed,
                                               base_frac)
    print(f"pool: {args.pool} patches {args.patch}->{args.patch * spec.scale}")

    base_step = 0
    if args.init_from:
        ck = np.load(args.init_from)
        params = {k: ck[k] for k in ck.files if not k.startswith("meta_")}
        base_step = int(ck["meta_step"]) if "meta_step" in ck.files else 0
    else:
        params = espcn.init_params(jax.random.key(args.seed), spec)
    schedule = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    t = trainer.Trainer(params=params, forward=espcn.make_loss_forward(spec))
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
                         meta_f1=np.int32(spec.f1),
                         meta_f2=np.int32(spec.f2),
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
             meta_scale=np.int32(spec.scale), meta_f1=np.int32(spec.f1),
             meta_f2=np.int32(spec.f2), meta_step=np.int32(base_step + step),
             meta_val_psnr=np.float32(p_sr))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
