#!/usr/bin/env python3
"""Benchmark suite: per-stage, per-path and scaling measurements.

``bench.py`` at the repo root prints the single headline JSON line the
driver records; this suite gives the full picture:

* ``--paths``    XLA vs fused-kernel conv stack per srcnn tier
* ``--sizes``    throughput across frame sizes
* ``--stages``   color/resize vs conv vs merge breakdown
* ``--batch``    batched video frames per dispatch
* ``--scaling``  tiled-pipeline mesh sweep (on CPU this validates
                 mechanics, not performance; run on the GPUs for
                 efficiency numbers)

All timings use stream dispatch ending in ``jax.block_until_ready``.
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

BASELINE_MP_S = 0.174


def _sync(x):
    import jax

    jax.block_until_ready(x)


def _time(fn, n=6):
    r = fn()
    _sync(r)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    _sync(r)
    return (time.perf_counter() - t0) / n * 1000.0


def bench_paths(size=1024, scale=2.0):
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig
    from libsrcnn_tpu import pipeline

    rng = np.random.default_rng(0)
    img = jax.device_put(jnp.asarray(rng.integers(0, 256, (size, size, 3), np.uint8)))
    out_mp = (size * scale) ** 2 / 1e6
    rows = []
    for name, cfg in [
        ("xla-f32", SRCNNConfig(use_pallas=False)),
        ("xla-bf16", SRCNNConfig(use_pallas=False,
                                 compute_dtype="bfloat16")),
        ("xla-int8", SRCNNConfig(compute_dtype="int8")),
        ("fused-f32", SRCNNConfig(use_pallas=True)),
        ("fused-bf16", SRCNNConfig(use_pallas=True,
                                   compute_dtype="bfloat16")),
        ("fused-bf16-fast", SRCNNConfig(use_pallas=True,
                                        compute_dtype="bfloat16_fast")),
    ]:
        params = jax.device_put(pipeline.load_model_params(cfg, scale))
        ms = _time(lambda: pipeline.run_pass(img, params, scale, cfg))
        rows.append((name, ms, out_mp / (ms / 1000)))
    print(f"paths @{size}->{int(size*scale)}:")
    for name, ms, mps in rows:
        print(f"  {name:14s} {ms:8.1f} ms  {mps:8.1f} MP/s  "
              f"({mps/BASELINE_MP_S:.0f}x CPU reference)")


def bench_sizes(scale=2.0):
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu import pipeline

    params = jax.device_put(srcnn.load_params())
    cfg = SRCNNConfig()
    rng = np.random.default_rng(0)
    print("sizes (float32 tier, auto path):")
    for size in (256, 512, 1024, 2048):
        img = jax.device_put(jnp.asarray(
            rng.integers(0, 256, (size, size, 3), np.uint8)))
        ms = _time(lambda: pipeline.run_pass(img, params, scale, cfg))
        mp = (size * scale) ** 2 / 1e6
        print(f"  {size:5d} -> {int(size*scale):5d}: {ms:8.1f} ms  "
              f"{mp/(ms/1000):8.1f} MP/s")


def bench_stages(size=1024, scale=2.0):
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu.config import FilterType
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.kernels import fused_conv
    from libsrcnn_tpu.ops import color, resize

    params = jax.device_put(srcnn.load_params())
    rng = np.random.default_rng(0)
    img = jax.device_put(jnp.asarray(rng.integers(0, 256, (size, size, 3), np.uint8)))
    dst = int(size * scale)

    @jax.jit
    def stage_resize(img):
        planes = color.rgb_to_ycbcr(img)
        return [resize.resize_plane(planes[c], dst, dst,
                FilterType.BICUBIC if c == 0 else FilterType.BILINEAR)
                for c in range(3)]

    planes = stage_resize(img)
    conv = jax.jit(fused_conv.forward_y)  # the float32 tier
    y = planes[0]

    @jax.jit
    def stage_merge(p):
        return color.ycbcr_to_rgb(jnp.stack(p, 0))

    print(f"stages @{size}->{dst}:")
    print(f"  color+resize {_time(lambda: stage_resize(img)):8.1f} ms")
    print(f"  conv (fused) {_time(lambda: conv(params, y)):8.1f} ms")
    print(f"  merge        {_time(lambda: stage_merge(planes)):8.1f} ms")


def bench_batch(size=512, scale=2.0, batches=(1, 4, 8)):
    """NOTE: unlike the other benchmarks, this measures the EAGER API
    including full device->host output transfer.  Compute-side
    throughput is what bench_paths/bench_sizes report."""
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu.serve import upscale_frames
    from libsrcnn_tpu.models import srcnn

    params = srcnn.load_params()
    rng = np.random.default_rng(0)
    print(f"batched video @{size} x{scale} (incl. device->host transfer):")
    for b in batches:
        frames = rng.integers(0, 256, (b, size, size, 3), np.uint8)
        upscale_frames(frames, scale, params=params)  # warm
        t0 = time.perf_counter()
        upscale_frames(frames, scale, params=params)
        dt = time.perf_counter() - t0
        mp = b * (size * scale) ** 2 / 1e6
        print(f"  batch {b:2d}: {dt*1000:8.1f} ms  {mp/dt:8.1f} MP/s")


def bench_batch_device(scale=2.0, sizes=(256, 512), batches=(1, 4, 8, 16),
                       dtype="float32"):
    """Small-frame serving throughput with DEVICE-RESIDENT outputs: one
    vmapped dispatch per clip (serve._batch_pass), stream-timed with one
    final sync -- measures the device, not the host transfer that
    bench_batch includes.  This is the number that shows batched dispatch
    recovering small-frame throughput.
    ``dtype`` selects the srcnn compute tier (float32 / bfloat16 /
    bfloat16_fast)."""
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig, serve
    from libsrcnn_tpu import pipeline as _pl

    cfg = SRCNNConfig(compute_dtype=dtype)
    params = jax.device_put(_pl.load_model_params(cfg, scale))
    rng = np.random.default_rng(0)
    print(f"batched serving, device-resident outputs (x{scale}, {dtype}):")
    for size in sizes:
        for b in batches:
            clips = [jax.device_put(jnp.asarray(rng.integers(
                0, 256, (b, size, size, 3), np.uint8))) for _ in range(4)]

            def run():
                last = None
                for c in clips:
                    last = serve._batch_pass(c, params, scale, cfg)
                return last

            ms = _time(run, n=4) / len(clips)
            mp = b * (size * scale) ** 2 / 1e6
            print(f"  {size:4d}^2 batch {b:2d}: {ms:8.1f} ms/clip  "
                  f"{mp / (ms / 1e3):8.1f} MP/s")

    # the zoo families in the same batched-serving scenario (bf16
    # throughput tier -- their serving mode; vdsr is the case that
    # matters, clip upscaling is where its quality tier gets used)
    from libsrcnn_tpu import pipeline

    size, b = 512, 8
    print(f"  zoo families @{size}^2 batch {b} (bf16 tier):")
    for model in ("fsrcnn", "espcn", "vdsr"):
        mcfg = SRCNNConfig(model=model, compute_dtype="bfloat16")
        mparams = {k: (v if k == "__spec__" else jax.device_put(v))
                   for k, v in pipeline.load_model_params(mcfg, scale).items()}
        clips = [jax.device_put(jnp.asarray(rng.integers(
            0, 256, (b, size, size, 3), np.uint8))) for _ in range(4)]

        def run_fam():
            last = None
            for c in clips:
                last = serve._batch_pass(c, mparams, scale, mcfg)
            return last

        ms = _time(run_fam, n=4) / len(clips)
        mp = b * (size * scale) ** 2 / 1e6
        print(f"    {model:8s}: {ms:8.1f} ms/clip  "
              f"{mp / (ms / 1e3):8.1f} MP/s")


def bench_models(size=1024, scale=2.0):
    """Model-zoo throughput: the three families end-to-end at the same
    output size.  The LR families (fsrcnn/espcn) convolve at INPUT
    resolution, so their FLOPs are scale^2 lower than SRCNN's."""
    import jax
    import jax.numpy as jnp

    from libsrcnn_tpu import SRCNNConfig, pipeline

    rng = np.random.default_rng(0)
    img = jax.device_put(jnp.asarray(
        rng.integers(0, 256, (size, size, 3), np.uint8)))
    out_mp = (size * scale) ** 2 / 1e6
    print(f"model zoo, {size}^2 -> x{scale} end-to-end; per tier "
          f"direct vs lane-packed convs (ops/packed_conv.py):")
    print(f"  {'':8s}  {'exact f32':>22s} {'+pack':>10s}"
          f"  {'bf16':>22s} {'+pack':>10s}")
    for model in ("srcnn", "fsrcnn", "espcn", "vdsr"):
        line = f"  {model:8s}"
        for dtype in ("float32", "bfloat16"):
            for pack in (False, True):
                if pack and model == "srcnn":
                    line += f" {'(gated)':>10s}"
                    continue
                cfg = SRCNNConfig(model=model, compute_dtype=dtype,
                                  lane_pack=pack)
                params = {k: (v if k == "__spec__" else jax.device_put(v))
                          for k, v in
                          pipeline.load_model_params(cfg, scale).items()}
                ms = _time(lambda: pipeline.run_pass(img, params, scale,
                                                     cfg))
                if pack:
                    line += f" {ms:6.1f} ms({out_mp / (ms / 1e3):4.0f})"
                else:
                    line += (f"  {ms:8.1f} ms "
                             f"{out_mp / (ms / 1e3):8.1f} MP/s")
        print(line, flush=True)


def bench_scaling(scale=2.0):
    import jax

    from libsrcnn_tpu import SRCNNConfig
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.parallel import upscale_tiled
    from libsrcnn_tpu.parallel.mesh import make_mesh

    n = len(jax.devices())
    params = srcnn.load_params()
    cfg = SRCNNConfig()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (256, 256, 3), np.uint8)
    print(f"tiled-pipeline mesh sweep ({n} devices, "
          f"{jax.devices()[0].device_kind}):")
    base = None
    shapes = [(1, 1)]
    if n >= 2:
        shapes.append((2, 1))
    if n >= 4:
        shapes.append((2, 2))
    if n >= 8:
        shapes.append((4, 2))
    for rows, cols in shapes:
        mesh = make_mesh({"data": 1, "row": rows, "col": cols},
                         jax.devices()[: rows * cols])
        ms = _time(lambda: upscale_tiled(img, params, scale, cfg, mesh), n=3)
        if base is None:
            base = ms
        eff = base / ms / (rows * cols) * 100
        print(f"  {rows}x{cols}: {ms:8.1f} ms  speedup {base/ms:5.2f}x  "
              f"efficiency {eff:5.1f}%")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = set(a.lstrip("-") for a in argv) or {"paths"}
    if "all" in which:
        which = {"paths", "sizes", "stages", "batch", "batch-device",
                 "models", "scaling"}
    if "paths" in which:
        bench_paths()
    if "sizes" in which:
        bench_sizes()
    if "stages" in which:
        bench_stages()
    if "batch" in which:
        bench_batch()
    if "batch-device" in which:
        bench_batch_device()
    if "batch-device-fast" in which:
        bench_batch_device(dtype="bfloat16_fast")
    if "models" in which:
        bench_models()
    if "scaling" in which:
        bench_scaling()
    return 0


if __name__ == "__main__":
    sys.exit(main())
