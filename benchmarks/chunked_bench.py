#!/usr/bin/env python3
"""Out-of-core chunked-path benchmark: wall time, transfer floor, overlap.

The chunked path's cost model has two independent terms:

* **device compute** per band (the same kernel bench.py measures), and
* **host<->device transfer**: u8 source rows up, u8 result + conv rows
  down -- the whole point of the path is that these stream at O(band).

This benchmark reports the two terms separately:

* measured host<->device bandwidth (device_put + fetch of a calibration
  buffer, same process),
* the stream's transfer floor = total bytes / that bandwidth,
* measured wall time at inflight_bands=1 (serial) vs 2 (overlapped),
* overlap efficiency = floor(transfer) / wall -- how close the stream
  runs to hiding ALL device compute behind the unavoidable transfers.

Usage: python benchmarks/chunked_bench.py [--size 2048] [--scale 2]
       [--band 512] [--tier bfloat16_fast]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--band", type=int, default=512)
    ap.add_argument("--tier", default="bfloat16_fast")
    ap.add_argument("--model", default="srcnn",
                    help="srcnn|fsrcnn|espcn|vdsr|srcnn955 (family tiers "
                         "are float32/bfloat16)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig, upscale_chunked
    from libsrcnn_tpu import pipeline

    if args.model != "srcnn" and args.tier not in ("float32", "bfloat16"):
        # family tiers are float32/bfloat16; downgrade the srcnn default
        print(f"note: tier {args.tier} is srcnn-only -> bfloat16")
        args.tier = "bfloat16"
    cfg = SRCNNConfig(compute_dtype=args.tier, model=args.model,
                      lane_pack=False if args.model != "srcnn" else None,
                      use_pallas=(None if args.tier == "float32"
                                  or args.model != "srcnn" else True))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (args.size, args.size, 3), np.uint8)
    params = pipeline.load_model_params(cfg, args.scale)

    # calibrate host<->device bandwidth with a 16 MB u8 round trip
    cal = rng.integers(0, 256, (16 << 20,), np.uint8)
    dev = jax.device_put(jnp.asarray(cal))
    jax.block_until_ready(dev)
    t0 = time.perf_counter()
    dev = jax.block_until_ready(jax.device_put(jnp.asarray(cal)))
    up = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(dev)
    down = time.perf_counter() - t0
    bw_up = cal.nbytes / up / 1e6
    bw_down = cal.nbytes / down / 1e6
    print(f"transfer calibration: up {bw_up:.0f} MB/s, down {bw_down:.0f} MB/s")

    dst = int(args.size * args.scale)
    out_mp = dst * dst / 1e6
    up_bytes = img.nbytes          # (+ band halo overlap, ~1%)
    down_bytes = dst * dst * 3 + dst * dst   # out u8 + conv u8
    floor_s = up_bytes / (bw_up * 1e6) + down_bytes / (bw_down * 1e6)
    print(f"{args.size}^2 -> {dst}^2 ({out_mp:.1f} MP out), band {args.band}, "
          f"tier {args.tier}, model {args.model}")
    print(f"transfer floor: {floor_s * 1000:.0f} ms "
          f"({up_bytes / 1e6:.0f} MB up + {down_bytes / 1e6:.0f} MB down)")

    for depth in (1, 2, 4):
        # warmup (compiles both band shapes)
        upscale_chunked(img, args.scale, cfg, band_rows=args.band,
                        params=params, inflight_bands=depth)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            upscale_chunked(img, args.scale, cfg, band_rows=args.band,
                            params=params, inflight_bands=depth)
            times.append(time.perf_counter() - t0)
        wall = float(np.median(times))
        print(f"inflight={depth}: wall {wall * 1000:7.0f} ms  "
              f"{out_mp / wall:6.1f} MP/s  "
              f"transfer-floor ratio {wall / floor_s:4.2f}x")


if __name__ == "__main__":
    main()
