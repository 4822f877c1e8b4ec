"""The fused srcnn kernel against the XLA conv stack, per tier, on the GPU.

Two levels, each timed on the device with ``jax.block_until_ready``
(median of ``--iters`` calls after a warm-up call):

* ``conv``: the Y-plane conv stack alone -- ``fused_conv.forward_y`` at
  each tier against ``models/srcnn.forward_y`` with f32 and with bf16
  weights -- plus the kernel's tile / warp / f32-dot variants;
* ``e2e``: the whole pass, u8 frame in and u8 frame out, through
  ``pipeline.run_pass`` with ``use_pallas`` True and False per tier, at
  x2 1024^2 -> 2048^2 and 1080p -> 4K.

Every line names the card.  Run:  python -m benchmarks.kernel_vs_xla
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import time

import numpy as np
import jax
import jax.numpy as jnp

from libsrcnn_tpu import SRCNNConfig, pipeline
from libsrcnn_tpu.kernels import fused_conv
from libsrcnn_tpu.models import srcnn


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, iters: int) -> float:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def conv_level(iters: int, size: int):
    y = jnp.asarray(np.random.default_rng(0).uniform(
        0, 255, (size, size)).astype(np.float32))
    p32 = srcnn.load_params()
    p16 = srcnn.load_params(jnp.bfloat16)
    xla32 = jax.jit(lambda v: srcnn.forward_y(p32, v))
    xla16 = jax.jit(lambda v: srcnn.forward_y(p16, v))
    ref = np.asarray(xla32(y))
    rows = [("xla f32 HIGHEST", lambda: xla32(y)),
            ("xla bf16 weights", lambda: xla16(y))]

    def fused(tier, **kw):
        return lambda: fused_conv._fused(y, p32, tier=tier, **kw)

    for tier in fused_conv.TIERS:
        rows.append((f"fused {tier}", fused(tier)))
    for tile, nw in (((8, 32), 4), ((8, 32), 8), ((4, 64), 4),
                     ((16, 16), 4), ((2, 64), 4)):
        for tier in ("float32", "bfloat16_fast"):
            rows.append((f"fused {tier} tile={tile} warps={nw}",
                         fused(tier, tile=tile, num_warps=nw)))
    for name, alg in (("tf32x3", jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3),
                      ("bf16x6", jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6)):
        # a jit of its own, traced while EXACT_DOT names the candidate
        fn = jax.jit(functools.partial(fused_conv._fused.__wrapped__,
                                       tier="float32", interpret=False))

        def run(alg=alg, fn=fn):
            old = fused_conv.EXACT_DOT
            fused_conv.EXACT_DOT = alg
            try:
                return fn(y, p32)
            finally:
                fused_conv.EXACT_DOT = old
        rows.append((f"fused float32 dot={name}", run))
    for name, fn in rows:
        try:
            ms = _time_ms(fn, iters)
            d = float(np.abs(np.asarray(fn()) - ref).max())
            print(json.dumps({"level": "conv", "size": size, "what": name,
                              "ms": ms, "maxdiff_vs_xla_f32": d}),
                  flush=True)
        except Exception as e:  # a variant the compiler refuses
            print(json.dumps({"level": "conv", "what": name,
                              "error": f"{type(e).__name__}: {e}"[:400]}),
                  flush=True)


def e2e_level(iters: int):
    rng = np.random.default_rng(1)
    scenes = {"x2 1024->2048": (rng.integers(0, 256, (1024, 1024, 3),
                                             np.uint8), 2.0),
              "1080p->4K": (rng.integers(0, 256, (1080, 1920, 3),
                                         np.uint8), 2.0)}
    for scene, (img, scale) in scenes.items():
        dev = jax.device_put(img)
        for tier in ("float32", "bfloat16", "bfloat16_fast", "int8"):
            for use_pallas in ((True, False) if tier != "int8"
                               else (False,)):
                cfg = SRCNNConfig(compute_dtype=tier, use_pallas=use_pallas)
                params = pipeline.load_model_params(cfg, scale)
                ms = _time_ms(lambda: pipeline.run_pass(dev, params, scale,
                                                        cfg), iters)
                mp = img.shape[0] * img.shape[1] * scale * scale / 1e6
                print(json.dumps({"level": "e2e", "scene": scene,
                                  "tier": tier, "use_pallas": use_pallas,
                                  "ms": ms, "out_MP_per_s": mp / ms * 1e3}),
                      flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--level", choices=("conv", "e2e", "both"),
                    default="both")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--size", type=int, default=2048)
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        raise SystemExit("kernel_vs_xla measures the GPU; no GPU found")
    d = jax.devices()[0]
    print(json.dumps({"card": _card(), "platform": d.platform,
                      "kind": d.device_kind, "count": len(jax.devices()),
                      "jax": jax.__version__}), flush=True)
    if args.level in ("conv", "both"):
        conv_level(args.iters, args.size)
    if args.level in ("e2e", "both"):
        e2e_level(args.iters)


if __name__ == "__main__":
    main()
