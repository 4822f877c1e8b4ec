#!/usr/bin/env python3
"""Drive a REAL video end-to-end on the GPU: mp4 in -> upscaled mp4 out.

The reference's only interactive surface is a stills test app
(`test.cpp:653-672`); this measures the framework's video answer on the
device, not on synthetic batched frames:

* **cli path** -- exactly what ``srcnn-tpu-video clip.mp4 --bf16-fast``
  runs: OpenCV decode -> batched device dispatch -> VideoSink encode.
* **ring path** -- the native-runtime shape: a producer thread decodes
  into the C SPSC FrameRing (`native/srcnn_host.cpp:163-230`), the
  device feeder consumes via ``VideoUpscaler.stream_from_ring`` (one
  frame in flight), frames re-encode incrementally.

Also times decode-only and encode-only so the bottleneck (decode vs
device vs encode) is attributed, and prints one JSON line for the
perf records.

Run (on the GPU):  python benchmarks/video_e2e.py [--frames 192] [--size 640x360]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def make_clip(path: str, n_frames: int, w: int, h: int, fps: float = 24.0):
    """Synthesize a test mp4: a panning crop over castle.jpg (real photo
    statistics, deterministic)."""
    import cv2
    from PIL import Image

    src = np.asarray(Image.open(
        "/root/reference/Pictures/castle.jpg").convert("RGB"))
    sh, sw = src.shape[:2]
    assert sh >= h and sw >= w, (src.shape, (h, w))
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for i in range(n_frames):
            t = i / max(1, n_frames - 1)
            r0 = int((sh - h) * (0.5 - 0.5 * np.cos(2 * np.pi * t)) / 2)
            c0 = int((sw - w) * t)
            vw.write(src[r0:r0 + h, c0:c0 + w, ::-1])  # RGB -> BGR
    finally:
        vw.release()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workdir", default="/tmp/srcnn_video_e2e")
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    from libsrcnn_tpu import serve
    from libsrcnn_tpu.config import SRCNNConfig
    from libsrcnn_tpu.io import video
    from libsrcnn_tpu.io.native import FrameRing, available

    os.makedirs(args.workdir, exist_ok=True)
    src = os.path.join(args.workdir, "clip.mp4")
    make_clip(src, args.frames, w, h)
    print(f"clip: {src} {w}x{h} x{args.frames} frames", flush=True)

    # -- decode-only floor --------------------------------------------------
    t0 = time.perf_counter()
    frames = list(video.iter_video(src))
    t_dec = time.perf_counter() - t0
    n = len(frames)
    print(f"decode-only: {n} frames in {t_dec:.2f} s = {n / t_dec:.1f} fps",
          flush=True)

    cfg = SRCNNConfig(compute_dtype="bfloat16_fast")

    # -- cli path (what `srcnn-tpu-video clip.mp4 --bf16-fast` runs) -------
    dst_cli = os.path.join(args.workdir, "clip_cli.mp4")
    t0 = time.perf_counter()
    n_cli = video.upscale_video(src, dst_cli, args.scale, cfg, args.batch)
    t_cli = time.perf_counter() - t0
    # first call pays the one-off compile; a second run
    # on the warm cache is the steady-state number
    t0 = time.perf_counter()
    n_cli = video.upscale_video(src, dst_cli, args.scale, cfg, args.batch)
    t_cli_warm = time.perf_counter() - t0
    print(f"cli path: {n_cli} frames, cold {t_cli:.2f} s "
          f"({n_cli / t_cli:.1f} fps), warm {t_cli_warm:.2f} s "
          f"({n_cli / t_cli_warm:.1f} fps)", flush=True)

    # -- native-ring path ---------------------------------------------------
    ring_fps = None
    if available():
        up = serve.VideoUpscaler(args.scale, cfg)
        dst_ring = os.path.join(args.workdir, "clip_ring.mp4")
        # warm the compile for the single-frame path
        np.asarray(up.stream(iter([frames[0]])).__next__())

        ring = FrameRing(frame_bytes=h * w * 3, nslots=16)
        done = threading.Event()

        def produce():
            for f in video.iter_video(src):
                while not ring.push(f):
                    time.sleep(0.0005)
            done.set()

        t0 = time.perf_counter()
        prod = threading.Thread(target=produce)
        prod.start()
        sink = video.VideoSink(dst_ring, video.video_fps(src))
        n_ring = 0
        try:
            for out in up.stream_from_ring(ring, (h, w, 3),
                                           stop=done.is_set):
                sink.write(out)
                n_ring += 1
        finally:
            sink.close()
            prod.join()
            ring.close()
        t_ring = time.perf_counter() - t0
        ring_fps = n_ring / t_ring
        print(f"ring path: {n_ring} frames in {t_ring:.2f} s = "
              f"{ring_fps:.1f} fps", flush=True)
    else:
        print("ring path: native library not built (make -C native)",
              flush=True)

    # -- encode-only floor --------------------------------------------------
    outs = list(video.iter_video(dst_cli))
    t0 = time.perf_counter()
    sink = video.VideoSink(os.path.join(args.workdir, "enc_only.mp4"), 24.0)
    for f in outs:
        sink.write(f)
    sink.close()
    t_enc = time.perf_counter() - t0
    print(f"encode-only ({outs[0].shape[1]}x{outs[0].shape[0]}): "
          f"{len(outs) / t_enc:.1f} fps", flush=True)

    rec = {
        "bench": "video_e2e",
        "clip": f"{w}x{h}x{n}",
        "scale": args.scale,
        "tier": "bfloat16_fast",
        "decode_fps": round(n / t_dec, 1),
        "cli_fps_warm": round(n_cli / t_cli_warm, 1),
        "cli_fps_cold": round(n_cli / t_cli, 1),
        "ring_fps": round(ring_fps, 1) if ring_fps else None,
        "encode_fps": round(len(outs) / t_enc, 1),
    }
    floors = {"decode": rec["decode_fps"], "encode": rec["encode_fps"]}
    dev = rec["ring_fps"] or rec["cli_fps_warm"]
    rec["bottleneck"] = ("device" if dev < min(floors.values())
                        else min(floors, key=floors.get))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
