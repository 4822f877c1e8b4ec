"""Video and animated-image frame I/O for the serving layer.

The reference is a stills library (one `ProcessSRCNN` per image,
`/root/reference/src/test.cpp:653-672`); this module rounds out the
framework's video story across two codec tiers:

* animations (GIF/APNG/WebP) -- PIL, decoded fully (they are small);
* real video containers (.mp4/.avi/.mov/.mkv/.webm/.m4v) -- OpenCV's
  ffmpeg backend, STREAMED: frames are decoded, pushed through the
  batched device path, and re-encoded incrementally, so memory stays
  O(batch), not O(video).

Either tier can feed either sink (gif -> mp4 transcodes, mp4 -> gif
works for short clips).  Real deployments with hardware decoders can
bypass this module and feed :func:`serve.stream_from_ring` directly.
"""

from __future__ import annotations

import os

from collections.abc import Iterator

import numpy as np

#: extensions routed to the OpenCV (ffmpeg) codec tier
VIDEO_EXTS = frozenset({".mp4", ".m4v", ".mov", ".avi", ".mkv", ".webm"})

#: encoder fourcc by output extension (cv2's build here lacks H.264
#: encode -- mp4v/XVID/VP8 are the portable software encoders; WebM
#: muxing accepts only VP8/VP9/AV1)
_FOURCC = {".mp4": "mp4v", ".m4v": "mp4v", ".mov": "mp4v",
           ".avi": "XVID", ".mkv": "XVID", ".webm": "VP80"}


def is_video(path: str) -> bool:
    """True when ``path``'s container belongs to the OpenCV tier."""
    return os.path.splitext(path)[1].lower() in VIDEO_EXTS


def _cv2():
    try:
        import cv2
    except ImportError as e:  # pragma: no cover - cv2 is baked in here
        raise RuntimeError(
            "video containers (.mp4/.avi/...) need OpenCV; re-encode as "
            "GIF/WebP for the PIL tier or install opencv-python") from e
    return cv2


def iter_video(path: str) -> Iterator[np.ndarray]:
    """Stream [H, W, 3] RGB u8 frames from a video container."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot decode video {path!r}")
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            yield np.ascontiguousarray(bgr[:, :, ::-1])
    finally:
        cap.release()


def video_fps(path: str) -> float:
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS))
    finally:
        cap.release()
    return fps if fps > 0 else 25.0


class VideoSink:
    """Incremental video encoder; opens on the first frame (the writer
    needs the output geometry, which only the first upscaled frame
    knows)."""

    def __init__(self, path: str, fps: float):
        self._path = path
        self._fps = fps
        self._writer = None
        self.frames = 0

    def write(self, rgb: np.ndarray) -> None:
        cv2 = _cv2()
        if self._writer is None:
            h, w = rgb.shape[:2]
            ext = os.path.splitext(self._path)[1].lower()
            fourcc = cv2.VideoWriter_fourcc(*_FOURCC.get(ext, "mp4v"))
            self._writer = cv2.VideoWriter(self._path, fourcc, self._fps,
                                           (w, h))
            if not self._writer.isOpened():
                raise ValueError(f"cannot open encoder for {self._path!r}")
        self._writer.write(np.asarray(rgb, np.uint8)[:, :, ::-1])
        self.frames += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def read_frames(path: str) -> tuple[list[np.ndarray], int | list[int]]:
    """Decode an (optionally animated) image file.

    Returns ``(frames, duration_ms)``: a list of [H, W, 3] u8 arrays and
    the per-frame display duration -- an int when uniform (0 for
    stills), else the per-frame list (GIFs may give every frame its own
    delay; collapsing to frame 0's would retime the animation).
    """
    from PIL import Image, ImageSequence

    im = Image.open(path)
    frames, durations = [], []
    for f in ImageSequence.Iterator(im):
        durations.append(int(f.info.get("duration", 0) or 0))
        frames.append(np.asarray(f.convert("RGB")))
    if len(set(durations)) <= 1:
        return frames, (durations[0] if durations else 0)
    return frames, durations


def write_frames(path: str, frames: list[np.ndarray],
                 duration_ms: int | list[int] = 0) -> None:
    """Encode frames to ``path``; animated when more than one frame (the
    format follows the extension: .gif/.webp/.png/...).  ``duration_ms``
    may be a per-frame list (PIL supports it natively)."""
    from PIL import Image

    ims = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    if len(ims) == 1:
        ims[0].save(path)
    else:
        ims[0].save(path, save_all=True, append_images=ims[1:],
                    duration=duration_ms or 40, loop=0)


def upscale_video(src: str, dst: str, scale: float = 2.0,
                  config=None, batch: int | None = 8) -> int:
    """Upscale every frame of ``src`` into ``dst``; returns frame count.

    ``batch`` groups frames into one vmapped device dispatch each (the
    small-frame throughput path, PERF.md); ``batch=None`` streams frame
    by frame through :class:`VideoUpscaler` (lowest latency).  Source
    and destination containers are independent: animations decode via
    PIL, video files stream via OpenCV (see module docstring).
    """
    from ..config import DEFAULT_CONFIG
    from .. import pipeline, serve

    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1 or None, got {batch}")
    config = config or DEFAULT_CONFIG
    if is_video(src):
        source: Iterator[np.ndarray] = iter_video(src)
        fps = video_fps(src)            # float: 29.97 stays 29.97
        duration: int | list[int] = int(round(1000.0 / fps))
    else:
        frames, duration = read_frames(src)
        if not frames:
            raise ValueError(f"no frames decoded from {src}")
        source = iter(frames)
        # zero-duration stills/animations get write_frames' 40 ms
        # default; variable-duration animations map to their mean rate
        mean_ms = (float(np.mean(duration)) if isinstance(duration, list)
                   else float(duration))
        fps = 1000.0 / (mean_ms or 40)

    def upscaled() -> Iterator[np.ndarray]:
        from itertools import islice

        if batch:
            # load once; per-batch loads would re-upload the weights
            # on every clip
            params = pipeline.load_model_params(config, scale)
            while True:
                clip = list(islice(source, batch))
                if not clip:
                    return
                yield from serve.upscale_frames(np.stack(clip), scale,
                                                config, params=params)
        else:
            up = serve.VideoUpscaler(scale, config)
            yield from up.stream(source)

    if is_video(dst):
        sink = VideoSink(dst, fps)
        try:
            for f in upscaled():
                sink.write(f)
        finally:
            sink.close()
        if sink.frames == 0:
            raise ValueError(f"no frames decoded from {src}")
        return sink.frames
    outs = list(upscaled())
    if not outs:
        raise ValueError(f"no frames decoded from {src}")
    write_frames(dst, outs, duration)
    return len(outs)


def main(argv=None) -> int:
    """``srcnn-tpu-video in.gif [out.gif] --scale=F --model=M`` CLI."""
    import sys

    from ..config import FilterType, SRCNNConfig
    from ..cli import _auto_name
    from ..utils.tick import get_tick_count

    argv = sys.argv[1:] if argv is None else argv
    src = dst = None
    scale, model, filt, batch = 2.0, "srcnn", FilterType.BICUBIC, 8
    dtype = "float32"
    ensemble = False
    for arg in argv:
        if arg.startswith("--scale="):
            scale = float(arg[8:])
        elif arg.startswith("--model="):
            model = arg[8:]
        elif arg.startswith("--filter="):
            filt = FilterType(int(arg[9:]))
        elif arg.startswith("--batch="):
            batch = int(arg[8:]) or None
        elif arg == "--bf16":
            dtype = "bfloat16"
        elif arg == "--bf16-fast":
            dtype = "bfloat16_fast"  # srcnn only: fastest single-pass tier
        elif arg == "--ensemble":
            ensemble = True
        elif arg.startswith("--"):
            raise SystemExit(f"unknown option: {arg}")
        elif src is None:
            src = arg
        elif dst is None:
            dst = arg
    if src is None:
        raise SystemExit("usage: srcnn-tpu-video <in.(gif|mp4|avi|...)> "
                         "[out] --scale=F "
                         "--model=srcnn|fsrcnn|espcn|vdsr|srcnn955 "
                         "--filter=0..4 --batch=N --bf16 --bf16-fast "
                         "--ensemble")
    if dst is None:
        # keep the source container for animations and videos (_auto_name
        # picks .png, which would silently re-wrap a GIF as APNG)
        root, ext = os.path.splitext(src)
        dst = (f"{root}_resized{ext}"
               if ext.lower() in (".gif", ".webp", ".apng") or is_video(src)
               else _auto_name(src, "resized"))
    cfg = SRCNNConfig(filter=filt, model=model, compute_dtype=dtype,
                      self_ensemble=ensemble)
    t0 = get_tick_count()
    n = upscale_video(src, dst, scale, cfg, batch)
    print(f"{dst}: {n} frames, took {get_tick_count() - t0} ms")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
