#!/usr/bin/env python3
"""Device trace of a full model-zoo pipeline pass: per-op breakdown.

Traces `pipeline.run_pass` for any family with ``jax.profiler`` and sums
the device plane's events by name, so each conv stack's time can be read
per op.

Run (on the GPU):
  python benchmarks/trace_model.py --model espcn --size 1024 --dtype bfloat16
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def report(trace_dir: str, iters: int, out_mp: float) -> None:
    """Per-op device time from the trace's first GPU plane: every event
    on its lines, grouped by name, per iteration."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                        recursive=True)
    pd = ProfileData.from_file(path)
    dev = next((p for p in pd.planes if p.name.startswith("/device:GPU")),
               None)
    if dev is None:
        raise SystemExit("no GPU device plane in the trace")
    ops = collections.defaultdict(lambda: [0.0, 0])
    total_ns = 0.0
    for line in dev.lines:
        for e in line.events:
            ops[e.name][0] += e.duration_ns
            ops[e.name][1] += 1
            total_ns += e.duration_ns
    total_ms = total_ns / iters / 1e6
    print(f"\nper-iteration device event total: {total_ms:.3f} ms "
          f"({out_mp / (total_ms / 1e3):.0f} output MP/s device-side)")
    print(f"{'op':48s} {'ms/iter':>8s} {'%':>6s} {'count':>6s}")
    for name, (ns, cnt) in sorted(ops.items(), key=lambda kv: -kv[1][0]):
        ms = ns / iters / 1e6
        if ms >= 0.005:
            print(f"{name[:48]:48s} {ms:8.3f} {100 * ns / total_ns:5.1f}% "
                  f"{cnt // iters:6d}")


def capture(model: str, size: int, scale: float, dtype: str,
            iters: int, lane_pack, use_pallas: bool = False) -> tuple[str, float]:
    import jax
    import tempfile

    from libsrcnn_tpu import SRCNNConfig, pipeline

    cfg = SRCNNConfig(model=model, compute_dtype=dtype,
                      use_pallas=use_pallas, lane_pack=lane_pack)
    params = pipeline.load_model_params(cfg, scale)
    rng = np.random.default_rng(0)
    imgs = [jax.device_put(rng.integers(0, 256, (size, size, 3), np.uint8))
            for _ in range(iters)]

    jax.block_until_ready(pipeline.run_pass(imgs[0], params, scale, cfg))

    tmp = tempfile.mkdtemp(prefix=f"srcnn_trace_{model}_")
    with jax.profiler.trace(tmp):
        for im in imgs:
            out = pipeline.run_pass(im, params, scale, cfg)
        jax.block_until_ready(out)
    o = out[0]
    return tmp, o.shape[0] * o.shape[1] / 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="espcn")
    ap.add_argument("--size", type=int, default=1024, help="input H=W")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16", "bfloat16_fast"))
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--pallas", action="store_true",
                    help="srcnn only: trace the FULL pipeline through the "
                         "fused kernel (resize gather -> kernel -> "
                         "merge) instead of the XLA conv stack")
    ap.add_argument("--lane-pack", default="auto",
                    choices=("auto", "0", "1"),
                    help="'1' traces the lane-packed conv formulation; "
                         "'auto' follows the config default (direct)")
    args = ap.parse_args()

    lane_pack = {"auto": None, "0": False, "1": True}[args.lane_pack]
    trace_dir, out_mp = capture(args.model, args.size, args.scale,
                                args.dtype, args.iters, lane_pack,
                                args.pallas)
    print(f"trace: {trace_dir}")
    report(trace_dir, args.iters, out_mp)


if __name__ == "__main__":
    main()
