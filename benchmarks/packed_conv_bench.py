#!/usr/bin/env python3
"""A/B: VDSR interior stack direct vs lane-packed (ops/packed_conv.py).

The ch=32 stack has 32 output channels; packing p=4 output columns into
the channel dimension trades (p+kw-1)/kw = 2x zero-fill MACs for a 4x
wider output -- whether that pays on the GPU is what this measures
(ROADMAP D3).

Interleaved rounds in one process, so drift hits every variant alike:

  python benchmarks/packed_conv_bench.py --size 2048 --depth 16
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048, help="HR plane H=W")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--ch", type=int, default=32)
    ap.add_argument("--packs", default="1,2,4,8")
    ap.add_argument("--precision", default="DEFAULT",
                    choices=("DEFAULT", "HIGHEST", "both"))
    ap.add_argument("--frames", type=int, default=4, help="stream length")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from libsrcnn_tpu.models import vdsr

    spec = vdsr.VDSRSpec(depth=args.depth, ch=args.ch)
    params = vdsr.init_params(jax.random.key(0), spec)
    rng = np.random.default_rng(0)
    planes = [jax.device_put(jnp.asarray(
        rng.uniform(0, 255, (args.size, args.size)).astype(np.float32)))
        for _ in range(args.frames)]
    mp = args.size * args.size / 1e6

    precisions = (["DEFAULT", "HIGHEST"] if args.precision == "both"
                  else [args.precision])
    packs = [int(p) for p in args.packs.split(",")]
    fns = {}
    for prec_name in precisions:
        prec = getattr(lax.Precision, prec_name)
        for p in packs:
            fns[(prec_name, p)] = jax.jit(
                lambda y, prec=prec, p=p: vdsr.forward_hr(
                    params, y, spec, precision=prec, lane_pack=p))

    def sync(x):
        jax.block_until_ready(x)

    for key, fn in fns.items():
        out = fn(planes[0])
        sync(out)
        ref = fns[(key[0], packs[0])](planes[0])
        sync(ref)
        d = float(jnp.max(jnp.abs(out - ref)))
        print(f"warm {key}: max|diff vs p={packs[0]}| = {d:.4g}", flush=True)

    acc = {k: [] for k in fns}
    for r in range(args.rounds):
        for key, fn in fns.items():
            t0 = time.perf_counter()
            for f in planes:
                out = fn(f)
            sync(out)
            dt = (time.perf_counter() - t0) / args.frames * 1000.0
            acc[key].append(dt)
    print(f"\nvdsr-d{args.depth}c{args.ch} @ {args.size}^2, "
          f"{args.frames}-frame streams, best of {args.rounds}:")
    for key, ts in acc.items():
        best = min(ts)
        print(f"  prec={key[0]:7s} p={key[1]}: {best:7.2f} ms "
              f"({mp / best * 1000:6.1f} MP/s)  runs={['%.1f' % t for t in ts]}")


if __name__ == "__main__":
    main()
