#!/usr/bin/env python3
"""Print a scaling report: mesh sweep + per-stage halo traffic accounting.

Two parts, neither a device time:

1. a mesh sweep of the tiled pipeline on whatever devices JAX has --
   on the virtual CPU mesh it validates the mechanics and shows where
   per-shard overhead appears (CPU timings are labeled as such), plus the
   GSPMD spatial path for comparison;
2. ANALYTIC per-device exchanged bytes for every communicating stage of
   `parallel.tiled.upscale_tiled` (derived from the halo widths in the
   code), against the per-device conv FLOPs.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/scaling_report.py
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def axis_halo(fw: float, dst: int, src: int) -> int:
    scale = dst / src
    width = fw / scale if scale < 1.0 else fw
    return int(math.ceil(width)) + 1


def halo_accounting(h: int, w: int, scale: float, rows: int, cols: int,
                   d: int = 3):
    """Per-device bytes exchanged per stage of upscale_tiled (pallas body),
    and the per-device useful conv FLOPs, for one [h,w,d] u8 frame."""
    dst_h, dst_w = int(h * scale), int(w * scale)
    B = 4  # f32 planes on the wire
    fw_y, fw_c = 2.0, 1.0  # bicubic Y, bilinear chroma (default policy)

    stages = []
    # resize pass 1 (vertical for upscale): halo rows of the SOURCE plane
    hv_y = axis_halo(fw_y, dst_h, h)
    hv_c = axis_halo(fw_c, dst_h, h)
    bytes_v = 2 * (hv_y + (d - 1) * hv_c) * (w // cols) * B
    stages.append(("resize-vertical (row axis)", bytes_v,
                   f"2 sides x (Y:{hv_y} + {d-1}x chroma:{hv_c}) src rows "
                   f"x {w//cols} local cols"))
    # resize pass 2 (horizontal): halo cols of the vertically-resized plane
    hh_y = axis_halo(fw_y, dst_w, w)
    hh_c = axis_halo(fw_c, dst_w, w)
    bytes_h = 2 * (hh_y + (d - 1) * hh_c) * (dst_h // rows) * B
    stages.append(("resize-horizontal (col axis)", bytes_h,
                   f"2 sides x (Y:{hh_y} + {d-1}x chroma:{hh_c}) src cols "
                   f"x {dst_h//rows} local rows"))
    # conv stage, fused pallas body: ONE 6 px exchange of the resized Y
    halo = 6
    conv_rows = 2 * halo * (dst_w // cols) * B
    conv_cols = 2 * halo * (dst_h // rows + 2 * halo) * B
    stages.append(("conv halo rows (row axis)", conv_rows,
                   f"2 sides x {halo} rows x {dst_w//cols} local cols"))
    stages.append(("conv halo cols (col axis)", conv_cols,
                   f"2 sides x {halo} cols x {dst_h//rows}+{2*halo} rows"))
    # XLA two-exchange body for comparison (4 px Y in + 2 px of 32 planes)
    xla_bytes = (2 * 4 * (dst_w // cols) + 2 * 4 * (dst_h // rows + 8)) * B \
        + 32 * (2 * 2 * (dst_w // cols) + 2 * 2 * (dst_h // rows + 4)) * B

    flops = 2 * (dst_h // rows) * (dst_w // cols) * (81 * 64 + 64 * 32 + 800)
    return dst_h, dst_w, stages, xla_bytes, flops


def mesh_sweep(size=256, scale=2.0):
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig, upscale
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.parallel import tiled, sharding
    from libsrcnn_tpu.parallel.mesh import make_mesh

    params = srcnn.load_params()
    cfg = SRCNNConfig()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (size, size, 3), np.uint8)

    def t(fn, n=3):
        r = fn()
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / n * 1000

    rows_out = []
    base = None
    for rows, cols in ((1, 1), (2, 1), (2, 2), (4, 2)):
        n = rows * cols
        if n > len(jax.devices()):
            continue
        mesh = make_mesh({"data": 1, "row": rows, "col": cols},
                         jax.devices()[:n])
        ms = t(lambda: tiled.upscale_tiled(img, params, scale, cfg, mesh))
        gs = t(lambda: sharding.upscale_spatial(jnp.asarray(img), params,
                                                scale, cfg, mesh))
        if base is None:
            base = ms
        rows_out.append((rows, cols, ms, base / ms, gs))
    return size, rows_out


def stage_pipeline_report(h=256, w=256, scale=2.0, n_frames=8, d=3):
    """Mechanics timing + analytic accounting for parallel/stages.py."""
    import jax

    from libsrcnn_tpu import SRCNNConfig, pipeline
    from libsrcnn_tpu.parallel import stages
    from libsrcnn_tpu.parallel.mesh import make_mesh

    cfg = SRCNNConfig()
    params = pipeline.load_model_params(cfg)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n_frames, h, w, d), np.uint8)

    def t(fn, n=3):
        r = fn()
        jax.block_until_ready(r)
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        return (time.perf_counter() - t0) / n * 1000

    rows = []
    for s in (2, 4):
        mesh = make_mesh({"stage": s, "rest": len(jax.devices()) // s})
        ms = t(lambda: stages.upscale_pipelined(frames, params, scale, cfg,
                                                mesh))
        rows.append((s, ms))

    dst_h, dst_w = int(h * scale), int(w * scale)
    C = 64 + d - 1
    step_bytes = C * dst_h * dst_w * 4
    # per-output-pixel MACs per atomic stage (resize ~16 taps x d planes)
    atom_macs = (16 * d, 81 * 64, 64 * 32, 25 * 32)
    return rows, n_frames, step_bytes, atom_macs


def main():
    import jax

    size, sweep = mesh_sweep()
    stage_rows, n_frames, step_bytes, atom_macs = stage_pipeline_report()
    h = w = 2048
    scale = 2.0
    rows, cols = 4, 2
    dst_h, dst_w, stages, xla_bytes, flops = halo_accounting(
        h, w, scale, rows, cols)
    total = sum(b for _, b, _ in stages)

    print(f"""# Scaling report — multi-device mechanics and halo traffic

Mesh sweep on {jax.devices()[0].device_kind} devices, plus analytic
exchanged bytes.  No line below is a GPU time unless the sweep ran on GPUs.

## 1. Mesh sweep, tiled pipeline ({size}x{size} -> x{2.0})

On a virtual CPU mesh the timings share one socket -- they validate
MECHANICS (all shapes produce bit-identical output, see
tests/test_tiled.py) and expose per-shard overhead, but say nothing of
inter-device links or per-device speed.  GSPMD column =
`parallel.sharding.upscale_spatial` (XLA-partitioned convs) on the same
mesh, for the explicit-vs-GSPMD comparison.

| mesh | tiled ms | speedup | GSPMD spatial ms |
|---|---|---|---|""")
    for r, c, ms, sp, gs in sweep:
        print(f"| {r}x{c} | {ms:.1f} | {sp:.2f}x | {gs:.1f} |")

    print(f"""
On one CPU socket the virtual mesh cannot show real speedup (all "devices"
share the same ALUs); the value of the sweep is that shard count does not
change results and per-shard overhead stays flat.  The GSPMD path carries
consistently higher dispatch cost at equal correctness, which is why
`upscale_tiled` (explicit shard_map + single-exchange fused kernel) is the
recommended multi-device path.

## 2. Analytic exchanged bytes per device — upscale_tiled, {h}x{w} x2 on a {rows}x{cols} mesh

Derived from the halo widths in parallel/tiled.py + parallel/halo.py
(fused-kernel body, single 6 px exchange).  f32 planes on the wire.

| stage | bytes/device | derivation |
|---|---|---|""")
    for name, b, why in stages:
        print(f"| {name} | {b:,} | {why} |")
    print(f"""| **total (fused body)** | **{total:,}** | |
| two-exchange XLA body, conv stage only | {xla_bytes:,} | 4 px Y + 2 px x 32 conv2 planes |

The single-exchange fused body moves {xla_bytes / (sum(b for n_, b, _ in stages if 'conv' in n_)):.1f}x
less conv-stage traffic than the two-exchange XLA body.

## 3. Communication : compute ratio

Per-device useful conv FLOPs at this config: {flops / 1e9:.2f} GFLOP.
Per-device exchanged bytes: {total / 1e6:.3f} MB.

That is {flops / total:,.0f} FLOP per exchanged byte.  The exchange time
and the conv time on the GPUs are not measured here; the ratio is what
bounds the exchange's share once they are (ROADMAP S7).

## 4. Pipeline-stage path (`parallel/stages.upscale_pipelined`)

Mechanics on the virtual CPU mesh ({n_frames} frames 256^2 -> x2,
bit-identical to per-frame single-device output, tests/test_stages.py):
""")
    print("| stages | clip ms |")
    print("|---|---|")
    for s, ms in stage_rows:
        print(f"| {s} | {ms:.1f} |")
    macs = atom_macs
    tot = sum(macs)
    s1 = macs[0] + macs[1]
    print(f"""
Analytic model (why this path is for memory locality, not throughput):

- **Bytes per hand-off**: the packed [{66}, H', W'] f32 carry = \
{step_bytes / 1e6:.1f} MB
  per step at 512^2 output — set by the widest boundary (conv1's 64
  planes + chroma); every step ships it once to the next device.
- **Bubble**: a clip of N frames takes N+S-1 steps -> (S-1)/(N+S-1)
  idle fraction (S=4, N=8: 27%; amortizes to 0 for long streams).
- **Stage imbalance is the binding ceiling**: per-pixel MACs split
  resize+conv1 {s1:,} / conv2 {macs[2]:,} / conv3 {macs[3]:,}
  ({100 * s1 / tot:.0f}% / {100 * macs[2] / tot:.0f}% / \
{100 * macs[3] / tot:.0f}%), so the steady-state speedup of ANY grouping
  is bounded by the conv1 stage at ~{tot / s1:.2f}x regardless of S.

Data parallelism has no such ceiling, which is why `upscale_batch` /
`serve.upscale_frames` remain the throughput paths; the pipeline's win
is per-device memory (one stage's weights + one activation buffer) for
steady-frame streaming on memory-tight devices.
""")


if __name__ == "__main__":
    main()
