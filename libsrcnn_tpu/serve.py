"""Streaming / batched serving: video frames through the device pipeline.

The reference processes one still image per `ProcessSRCNN` call; this
module is the production-serving layer this framework adds:

* :class:`VideoUpscaler` -- double-buffered streaming loop: while the device
  runs frame t, the host feeds frame t+1 (device dispatch is async), with
  optional native :class:`~libsrcnn_tpu.io.native.FrameRing` ingestion so a
  decoder thread never blocks on the device.
* :func:`upscale_frames` -- batched eager API over [N, H, W, D] clips,
  optionally sharded over a device mesh's ``data`` axis.
"""

from __future__ import annotations

import functools

from collections.abc import Iterable, Iterator

import numpy as np
import jax
import jax.numpy as jnp

from .config import DEFAULT_CONFIG, SRCNNConfig
from . import pipeline


def _reject_step_scale(config: SRCNNConfig) -> None:
    """The serve paths run ONE pass per frame; silently skipping the
    reference's chained-x2 step-scale recipe (`libsrcnn.cpp:980-1061`)
    would produce different pixels than api.upscale with the same
    config, so reject it explicitly (use api.upscale per frame)."""
    if config.step_scale:
        raise ValueError(
            "step_scale is not supported by the serving paths (they "
            "dispatch one pass per frame); call api.upscale per frame "
            "for chained-x2 semantics")


def upscale_frames(frames: np.ndarray, scale: float = 2.0,
                   config: SRCNNConfig = DEFAULT_CONFIG,
                   params: dict | None = None, mesh=None) -> np.ndarray:
    """Upscale a [N, H, W, D] u8 clip; with ``mesh`` the batch is sharded
    over the ``data`` axis (see parallel/sharding.upscale_batch)."""
    _reject_step_scale(config)
    if params is None:
        params = pipeline.load_model_params(config, scale)
    if mesh is not None:
        import dataclasses

        from .parallel import sharding

        if config.self_ensemble:
            # the flip ensemble is just a 4x batch: shard the variants
            # over the data axis like any other frames, unflip+average
            # on the host (identical math to _ensemble_body, so this
            # path is bit-identical to the single-device ensemble)
            base = dataclasses.replace(config, self_ensemble=False)
            f = np.asarray(frames)
            n, h, w, d = f.shape
            variants = np.stack(
                [f, f[:, :, ::-1], f[:, ::-1], f[:, ::-1, ::-1]],
                axis=1).reshape(4 * n, h, w, d)
            out, _ = sharding.upscale_batch(
                jnp.asarray(np.ascontiguousarray(variants)), params,
                float(scale), base, mesh)
            o = np.asarray(out).reshape(n, 4, *out.shape[1:])
            back = np.stack([o[:, 0], o[:, 1][:, :, ::-1],
                             o[:, 2][:, ::-1], o[:, 3][:, ::-1, ::-1]],
                            axis=1)
            return np.rint(back.astype(np.float32).mean(axis=1)
                           ).astype(np.uint8)
        out, _ = sharding.upscale_batch(jnp.asarray(frames), params,
                                        float(scale), config, mesh)
        return np.asarray(out)
    # single device: one vmapped dispatch for the whole clip (per-frame
    # dispatch overhead dominates at small frame sizes)
    if config.self_ensemble:
        out, _ = _ensemble_pass(jnp.asarray(frames), params, float(scale),
                                config, batched=True)
    else:
        out, _ = _batch_pass(jnp.asarray(frames), params, float(scale),
                             config)
    return np.asarray(out)


def _pass_geometry(frames, params, scale: float, config: SRCNNConfig):
    """Shared prologue of the compiled passes: resolve the output
    geometry, split the model spec, and build the static key used by the
    compile caches.  Returns (params, static_key) where static_key is
    (h, w, d, dst_h, dst_w, filter, use_pallas, dtype, model, spec,
    lane_pack)."""
    from .ops import resize as _resize

    h, w, d = frames.shape[-3:]
    dst_w, dst_h = _resize.scaled_size(w, h, scale)
    params, spec = pipeline.prepare_model_params(config, params, h, w,
                                                 dst_h, dst_w, scale)
    return params, (h, w, d, dst_h, dst_w, int(config.filter),
                    pipeline.resolve_pallas(config.use_pallas,
                                            config.compute_dtype),
                    config.compute_dtype, config.model, spec,
                    pipeline.resolve_lane_pack(config.lane_pack,
                                               config.model))


def _single_pass_body(dst_h, dst_w, filter_type, use_pallas, dtype,
                      model, spec, lane_pack=False):
    """The (img, params) pass body with every static bound -- the one
    place the _single_pass kwargs are spelled out for the serve paths."""
    return functools.partial(pipeline._single_pass, dst_h=dst_h,
                             dst_w=dst_w, filter_type=filter_type,
                             use_pallas=use_pallas, compute_dtype=dtype,
                             model=model, fsrcnn_spec=spec,
                             lane_pack=lane_pack)


def _batch_pass(frames, params, scale: float, config: SRCNNConfig):
    params, key = _pass_geometry(frames, params, scale, config)
    return _compiled_batch(*key)(frames, params)


def _ensemble_body(img, params, *, body):
    """Flip self-ensemble of one frame, entirely on device: the 4 flip
    variants through a vmapped single pass, unflipped and averaged in f32
    before the u8 cast (jnp.round == np.rint, ties-to-even)."""
    v = jnp.stack([img, img[:, ::-1], img[::-1], img[::-1, ::-1]])
    outs, convs = jax.vmap(body, in_axes=(0, None))(v, params)

    def unflip_mean(a):
        back = jnp.stack([a[0], a[1][:, ::-1], a[2][::-1], a[3][::-1, ::-1]])
        return jnp.round(jnp.mean(back.astype(jnp.float32), axis=0)
                         ).astype(jnp.uint8)

    return unflip_mean(outs), unflip_mean(convs)


@functools.lru_cache(maxsize=32)
def _compiled_ensemble(h, w, d, dst_h, dst_w, filter_type, use_pallas, dtype,
                       model="srcnn", spec=None, lane_pack=False,
                       batched=False):
    body = _single_pass_body(dst_h, dst_w, filter_type, use_pallas, dtype,
                             model, spec, lane_pack)
    fn = functools.partial(_ensemble_body, body=body)
    if batched:
        fn = jax.vmap(fn, in_axes=(0, None))
    return jax.jit(fn)


def _ensemble_pass(frames, params, scale: float, config: SRCNNConfig,
                   batched: bool = False):
    """(frame [H,W,D] or clip [N,H,W,D]) -> flip-ensembled (out, conv),
    one device dispatch covering all 4 variants (x all frames)."""
    params, key = _pass_geometry(frames, params, scale, config)
    return _compiled_ensemble(*key, batched)(frames, params)


@functools.lru_cache(maxsize=32)
def _compiled_batch(h, w, d, dst_h, dst_w, filter_type, use_pallas, dtype,
                    model="srcnn", spec=None, lane_pack=False):
    body = _single_pass_body(dst_h, dst_w, filter_type, use_pallas, dtype,
                             model, spec, lane_pack)
    return jax.jit(jax.vmap(body, in_axes=(0, None)))


class VideoUpscaler:
    """Streaming upscaler: overlaps host frame feed with device compute.

    >>> up = VideoUpscaler(scale=2.0)
    >>> for out in up.stream(frame_iter):
    ...     sink(out)
    """

    def __init__(self, scale: float = 2.0,
                 config: SRCNNConfig = DEFAULT_CONFIG,
                 params: dict | None = None):
        _reject_step_scale(config)
        self.scale = float(scale)
        self.config = config
        self.params = (params if params is not None
                       else pipeline.load_model_params(config, scale))

    #: transient device errors are retried this many times per frame before
    #: propagating (a pre-empted or reset device can drop a dispatch; the
    #: reference has no failure handling at all, SURVEY.md section 5)
    max_retries: int = 2
    #: first retry waits this long; each subsequent retry doubles it
    retry_backoff_s: float = 0.05

    def _run_one(self, frame: np.ndarray, sync: bool = False):
        import logging
        import time

        import jax

        last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                if self.config.self_ensemble:
                    out = _ensemble_pass(jnp.asarray(frame), self.params,
                                         self.scale, self.config)[0]
                else:
                    out = pipeline.run_pass(jnp.asarray(frame), self.params,
                                            self.scale, self.config)[0]
                # sync=True materializes INSIDE the retry scope, so async
                # execution failures (which dispatch alone never raises)
                # are retried too -- the slow path; stream() keeps the
                # fast path async and only falls back here on error
                return np.asarray(out) if sync else out
            except jax.errors.JaxRuntimeError as e:
                # Deterministic failures (tracing/lowering problems surface
                # as TypeError/ValueError, not JaxRuntimeError) are not
                # retried; runtime errors from a pre-empted or reset device
                # are worth re-dispatching after a short backoff.
                last_err = e
                if attempt < self.max_retries:
                    wait = self.retry_backoff_s * (2 ** attempt)
                    logging.getLogger(__name__).warning(
                        "device error on frame dispatch (attempt %d/%d), "
                        "retrying in %.2fs: %s", attempt + 1,
                        self.max_retries, wait, e)
                    time.sleep(wait)
        raise last_err

    def stream(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Yield upscaled frames; keeps one frame in flight on the device
        (dispatch is async, so the host prepares frame t+1 while the device
        processes frame t)."""
        pending = None
        for frame in frames:
            cur = self._run_one(frame)
            if pending is not None:
                yield self._materialize(*pending)
            pending = (frame, cur)
        if pending is not None:
            yield self._materialize(*pending)

    def _materialize(self, frame: np.ndarray, result) -> np.ndarray:
        """Device -> host fetch with the retry policy: dispatch is async,
        so a dropped execution raises HERE, not in _run_one -- re-run the
        frame synchronously through the retry loop in that case."""
        import jax

        try:
            return np.asarray(result)
        except jax.errors.JaxRuntimeError:
            return self._run_one(frame, sync=True)

    def stream_from_ring(self, ring, frame_shape: tuple[int, int, int],
                         stop=lambda: False) -> Iterator[np.ndarray]:
        """Consume u8 frames from a native FrameRing (producer thread pushes
        raw buffers); yields upscaled frames until ``stop()`` and the ring
        drains."""
        h, w, d = frame_shape

        def gen():
            import time

            while True:
                buf = ring.pop()
                if buf is None:
                    if stop() and len(ring) == 0:
                        return
                    time.sleep(0.001)
                    continue
                yield buf.reshape(h, w, d)

        yield from self.stream(gen())
