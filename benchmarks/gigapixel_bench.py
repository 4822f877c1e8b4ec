#!/usr/bin/env python3
"""ONE true gigapixel frame through the out-of-core chunked path, on the GPU.

The chunked design claims O(band) device memory for frames that cannot
fit as monolithic device arrays (SURVEY.md §5's long-context analog);
until round 5 the largest measured frame was 2048²→4096² (67 MB out).
This runs a REAL ≥1-gigapixel source (default 32768² = 1.07 GP, tiled
from the corpus photos with deterministic flips) through
`chunked.upscale_chunked` at the EXACT tier and:

* records wall time, output MP/s, the host<->device transfer floor (so
  the wall number reads honestly), and peak device memory;
* verifies sampled output strips against `tests/oracle.py` -- the
  loop-level reference replica -- at ≤1 u8 LSB: one strip at the true
  top edge (border-clamp semantics), one spanning an interior band seam
  (the cut whose invariance is the path's core claim), one at the
  bottom edge.  The oracle resize is re-expressed as a k-vectorized
  strip (same f64 accumulation order, bit-identical sums) because the
  per-row loop would take hours at this width.

Run (on the GPU):  python benchmarks/gigapixel_bench.py [--side 32768]
                  [--band 512] [--strip-rows 64]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, os.path.join(__file__.rsplit("/", 2)[0], "tests"))


def synth_gigapixel(side: int) -> np.ndarray:
    """Tile the corpus photos into a [side, side, 3] u8 frame with
    deterministic flips (periodicity broken so band seams see varied
    content)."""
    from PIL import Image

    base = np.asarray(Image.open(
        "/root/reference/Pictures/castle.jpg").convert("RGB"))
    bh, bw = base.shape[:2]
    out = np.empty((side, side, 3), np.uint8)
    for r0 in range(0, side, bh):
        for c0 in range(0, side, bw):
            t = base
            if (r0 // bh + c0 // bw) % 2:
                t = t[:, ::-1]
            if (r0 // bh) % 2:
                t = t[::-1]
            out[r0:r0 + bh, c0:c0 + bw] = t[:min(bh, side - r0),
                                            :min(bw, side - c0)]
    return out


# --- k-vectorized strip oracle (bit-identical to tests/oracle.py) ----------

def _resize_axis0_strip(plane: np.ndarray, dst: int, ft, u0: int, u1: int):
    """Rows [u0, u1) of oracle._resize_axis0(plane, dst, ft): same
    ascending-k f64 accumulation with the same in-bounds skip, vectorized
    across u instead of looped -- identical sums per row."""
    from libsrcnn_tpu.ops.weights_table import contribution_table

    src = plane.shape[0]
    left, w = contribution_table(ft, dst, src)
    left = np.asarray(left)[u0:u1]
    w = np.asarray(w)[u0:u1]
    acc = np.zeros((u1 - u0, plane.shape[1]), np.float64)
    for k in range(w.shape[1]):
        i = left + k
        ok = i < src
        rows = plane[np.minimum(i, src - 1)].astype(np.float64)
        contrib = w[:, k][:, None] * rows
        acc[ok] += contrib[ok]
    return acc.astype(np.float32)


def oracle_strip(img: np.ndarray, scale: float, r0: int, r1: int,
                 params: dict):
    """Final-RGB u8 rows [r0, r1) of oracle.do_srcnn(img, scale) without
    materializing the full-resolution planes."""
    import oracle
    from libsrcnn_tpu.config import FilterType, chroma_filter

    h, w = img.shape[:2]
    dst_w = int(np.float32(w) * np.float32(scale))
    dst_h = int(np.float32(h) * np.float32(scale))
    ft = FilterType.BICUBIC
    cf = chroma_filter(ft)
    planes = oracle.rgb_to_ycbcr(img)

    # conv stack halo: 4 (conv1) + 2 (conv3 on c2) rows each side, except
    # at true image edges where the oracle's own border semantics apply
    ry0, ry1 = max(0, r0 - 6), min(dst_h, r1 + 6)

    def resize_strip(plane, u0, u1, filt):
        # oracle.resize_plane upscale order: vertical (axis0) first, then
        # horizontal via transpose -- reproduced here on the strip
        vert = _resize_axis0_strip(plane, dst_h, filt, u0, u1)
        return _resize_axis0_strip(vert.T, dst_w, filt, 0, dst_w).T

    y_strip = resize_strip(planes[0], ry0, ry1, ft)
    y_sr = oracle.srcnn_y(y_strip, params)[r0 - ry0:r0 - ry0 + (r1 - r0)]
    chroma = [resize_strip(planes[c], r0, r1, cf)
              for c in range(1, img.shape[-1])]
    merged = np.stack([y_sr, *chroma])
    return oracle.ycbcr_to_rgb(merged), np.floor(y_sr).astype(np.uint8)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=32768)
    ap.add_argument("--band", type=int, default=512)
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--strip-rows", type=int, default=64)
    ap.add_argument("--skip-verify", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig, upscale_chunked
    from libsrcnn_tpu.models.srcnn import _load_npz

    dev = jax.devices()[0]
    print(f"device: {dev.platform}", flush=True)

    t0 = time.perf_counter()
    img = synth_gigapixel(args.side)
    print(f"source: {img.shape} = "
          f"{img.shape[0] * img.shape[1] / 1e9:.2f} GP u8 "
          f"({img.nbytes / 1e9:.1f} GB host), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # host<->device bandwidth calibration (same method as chunked_bench)
    cal = np.zeros((32 << 20,), np.uint8)
    t0 = time.perf_counter()
    d = jax.device_put(cal)
    d.block_until_ready()
    up_bw = cal.nbytes / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    np.asarray(d)
    down_bw = cal.nbytes / (time.perf_counter() - t0)
    del d
    print(f"transfer calibration: up {up_bw / 1e6:.1f} MB/s, "
          f"down {down_bw / 1e6:.1f} MB/s", flush=True)

    cfg = SRCNNConfig(compute_dtype="float32")  # exact tier: oracle-gated
    t0 = time.perf_counter()
    out, conv = upscale_chunked(img, args.scale, cfg, band_rows=args.band)
    wall = time.perf_counter() - t0
    out_gp = out.shape[0] * out.shape[1] / 1e9
    in_b = img.nbytes
    out_b = out.nbytes + conv.nbytes
    floor = in_b / up_bw + out_b / down_bw
    try:
        stats = dev.memory_stats() or {}
    except Exception:
        stats = {}
    peak = stats.get("peak_bytes_in_use")
    print(f"chunked x{args.scale} exact: out {out.shape} = {out_gp:.2f} GP "
          f"in {wall:.1f} s = {1e3 * out_gp / wall:.1f} MP/s wall "
          f"(transfer floor {floor:.1f} s = {100 * floor / wall:.0f}% of "
          f"wall)", flush=True)
    if peak:
        print(f"peak device memory: {peak / 1e6:.0f} MB", flush=True)

    verified = None
    if not args.skip_verify:
        params = _load_npz()
        dst_h = out.shape[0]
        seam = (dst_h // 2 // args.band) * args.band
        strips = [(0, args.strip_rows),
                  (seam - args.strip_rows // 2, seam + args.strip_rows // 2),
                  (dst_h - args.strip_rows, dst_h)]
        verified = []
        for r0, r1 in strips:
            t0 = time.perf_counter()
            o_rgb, o_conv = oracle_strip(img, args.scale, r0, r1, params)
            d_rgb = int(np.abs(out[r0:r1].astype(np.int16)
                               - o_rgb.astype(np.int16)).max())
            d_conv = int(np.abs(conv[r0:r1].astype(np.int16)
                                - o_conv.astype(np.int16)).max())
            verified.append((r0, r1, d_rgb, d_conv))
            print(f"oracle strip rows [{r0}, {r1}): maxdiff rgb {d_rgb} "
                  f"conv {d_conv} (computed in "
                  f"{time.perf_counter() - t0:.0f} s)", flush=True)
        worst = max(max(v[2], v[3]) for v in verified)
        print("PASS gigapixel oracle gate (<=1 LSB)" if worst <= 1
              else f"FAIL gigapixel oracle gate: maxdiff {worst}",
              flush=True)

    rec = {
        "bench": "gigapixel_chunked",
        "source_gp": round(img.shape[0] * img.shape[1] / 1e9, 2),
        "out_gp": round(out_gp, 2),
        "tier": "exact",
        "band_rows": args.band,
        "wall_s": round(wall, 1),
        "mp_per_s_wall": round(1e3 * out_gp / wall, 1),
        "transfer_floor_s": round(floor, 1),
        "peak_device_mb": round(peak / 1e6) if peak else None,
        "oracle_strips_max_lsb": (max(max(v[2], v[3]) for v in verified)
                                  if verified else None),
    }
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
