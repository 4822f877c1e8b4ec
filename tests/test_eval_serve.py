"""eval runner, profiling utils, serving layer, distributed helpers."""

import os
import threading

import numpy as np
import pytest

from PIL import Image

from libsrcnn_tpu.config import FilterType
from libsrcnn_tpu.eval.runner import evaluate_image, evaluate_dir, main as eval_main
from libsrcnn_tpu.serve import VideoUpscaler, upscale_frames
from libsrcnn_tpu.utils.profiling import StageTimer, flops_estimate, sync
from libsrcnn_tpu import upscale


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def _butterfly_full():
    """The reference's 256x256 butterfly picture, as committed in the
    goldens archive."""
    return np.load(GOLDENS)["in_butterfly_full"]


@pytest.fixture(scope="module")
def butterfly():
    img = _butterfly_full()
    return img[64:192, 64:192]  # 128x128 crop keeps tests fast


def test_srcnn_beats_interp_on_butterfly():
    img = _butterfly_full()
    r = evaluate_image(img, 2.0, FilterType.BICUBIC, name="butterfly")
    assert r.psnr_srcnn > r.psnr_interp, (r.psnr_srcnn, r.psnr_interp)
    assert r.ssim_srcnn > 0.8


def test_eval_size_truncation_edge():
    """427 rows at x4: an integer-scale eval must crop to the multiple
    (grid-aligned round trip) instead of crashing or silently comparing a
    misaligned fractional upscale; fractional requests stay legal."""
    img = np.random.default_rng(8).integers(0, 256, (427, 64, 3), np.uint8)
    r = evaluate_image(img, 4.0, FilterType.BICUBIC, name="edge")
    r_pre = evaluate_image(img[:424], 4.0, FilterType.BICUBIC, name="pre")
    assert r.psnr_srcnn == r_pre.psnr_srcnn  # crop == pre-cropped input
    r_frac = evaluate_image(img, 2.5, FilterType.BICUBIC, name="frac")
    assert np.isfinite(r_frac.psnr_srcnn) and np.isfinite(r_frac.psnr_interp)


def test_eval_dir_and_cli(tmp_path, butterfly, capsys):
    from libsrcnn_tpu.io import save_png

    save_png(str(tmp_path / "a.png"), butterfly)
    results = evaluate_dir(str(tmp_path), 2.0)
    assert len(results) == 1 and results[0].name == "a.png"
    rc = eval_main([str(tmp_path), "--scale=2", "--filter=bicubic"])
    assert rc == 0
    assert "mean PSNR gain" in capsys.readouterr().out


def test_upscale_frames_matches_single(butterfly):
    clip = np.stack([butterfly[:32, :32], butterfly[32:64, :32]])
    out = upscale_frames(clip, 2.0)
    assert out.shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(out[0], upscale(clip[0], 2.0))


def test_upscale_frames_lr_families(butterfly):
    """Batched serving works for every model family, matching the
    single-image API (which loads the same shipped weights)."""
    from libsrcnn_tpu import SRCNNConfig

    clip = np.stack([butterfly[:32, :32], butterfly[32:64, :32]])
    for model in ("fsrcnn", "espcn"):
        cfg = SRCNNConfig(model=model)
        out = upscale_frames(clip, 2.0, cfg)
        assert out.shape == (2, 64, 64, 3)
        np.testing.assert_array_equal(out[0], upscale(clip[0], 2.0, cfg))


def test_upscale_frames_fast_tier_matches_single(butterfly):
    """Batched serving carries the bfloat16_fast tier, matching the
    single-image API at the same tier (bit-identical: same kernel mode,
    same per-pixel reduction order); the ensemble combo also composes."""
    from libsrcnn_tpu import SRCNNConfig

    clip = np.stack([butterfly[:32, :32], butterfly[32:64, :32]])
    cfg = SRCNNConfig(compute_dtype="bfloat16_fast", use_pallas=True)
    out = upscale_frames(clip, 2.0, cfg)
    np.testing.assert_array_equal(out[0], upscale(clip[0], 2.0, cfg))
    ens = SRCNNConfig(compute_dtype="bfloat16_fast", use_pallas=True,
                      self_ensemble=True)
    oute = upscale_frames(clip, 2.0, ens)
    np.testing.assert_array_equal(oute[0], upscale(clip[0], 2.0, ens))


def test_video_stream(butterfly):
    frames = [butterfly[i:i + 24, :24] for i in range(0, 72, 24)]
    up = VideoUpscaler(scale=2.0)
    outs = list(up.stream(iter(frames)))
    assert len(outs) == 3
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, upscale(f, 2.0))


def test_video_stream_from_ring(butterfly):
    from libsrcnn_tpu.io import native

    if not native.available():
        pytest.skip("native library not built")
    frame = np.ascontiguousarray(butterfly[:16, :16])
    ring = native.FrameRing(frame.nbytes, 8)
    done = threading.Event()

    def producer():
        for _ in range(5):
            while not ring.push(frame):
                pass
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    up = VideoUpscaler(scale=2.0)
    outs = list(up.stream_from_ring(ring, frame.shape, stop=done.is_set))
    t.join()
    assert len(outs) == 5
    np.testing.assert_array_equal(outs[0], upscale(frame, 2.0))
    ring.close()


def test_validate_params():
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.utils.checks import validate_params

    p = srcnn.load_params()
    validate_params(p)
    bad = dict(p)
    del bad["w3"]
    with pytest.raises(ValueError, match="missing"):
        validate_params(bad)
    bad2 = dict(p)
    bad2["b1"] = np.full((64,), np.nan)
    with pytest.raises(ValueError, match="non-finite"):
        validate_params(bad2)
    bad3 = dict(p)
    bad3["w1"] = np.zeros((9, 9, 64, 1))
    with pytest.raises(ValueError, match="expected"):
        validate_params(bad3)


def test_stream_retries_transient_errors(butterfly, monkeypatch):
    import jax

    from libsrcnn_tpu import pipeline

    up = VideoUpscaler(scale=2.0)
    real = pipeline.run_pass
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise jax.errors.JaxRuntimeError("transient device loss")
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "run_pass", flaky)
    outs = list(up.stream(iter([butterfly[:16, :16]])))
    assert len(outs) == 1 and calls["n"] == 2


def test_stream_retry_exhaustion_propagates(butterfly, monkeypatch):
    import jax

    from libsrcnn_tpu import pipeline

    up = VideoUpscaler(scale=2.0)
    up.retry_backoff_s = 0.0  # keep the test fast
    calls = {"n": 0}

    def dead(*a, **kw):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("device gone")

    monkeypatch.setattr(pipeline, "run_pass", dead)
    with pytest.raises(jax.errors.JaxRuntimeError, match="device gone"):
        list(up.stream(iter([butterfly[:16, :16]])))
    assert calls["n"] == up.max_retries + 1


def test_stage_timer():
    import jax.numpy as jnp

    t = StageTimer()
    with t.stage("x") as box:
        box["out"] = jnp.ones((8, 8)) * 2
    rep = t.report()
    assert "x" in rep and "ms" in rep
    sync(None)  # no-op on empty


def test_flops_estimate():
    assert flops_estimate(2048, 2048) == 2048 * 2048 * 2 * (81 * 64 + 64 * 32 + 800)


def test_distributed_helpers():
    from libsrcnn_tpu.parallel import distributed

    distributed.initialize(num_processes=1)  # no-op path
    mesh = distributed.global_mesh(data=2, col=1)
    assert mesh.shape["data"] == 2 and mesh.shape["row"] == 4
    assert distributed.process_local_batch(8) == 8
    with pytest.raises(ValueError):
        distributed.global_mesh(data=3)


def test_profiler_trace(tmp_path):
    import jax.numpy as jnp

    from libsrcnn_tpu.utils.profiling import trace

    with trace(str(tmp_path)):
        float(jnp.sum(jnp.ones((16, 16))))
    import os

    assert any(os.scandir(str(tmp_path)))  # trace artifacts written


def test_train_cli_with_mesh(tmp_path, butterfly):
    from libsrcnn_tpu.io import save_png
    from libsrcnn_tpu.train import cli as tcli

    save_png(str(tmp_path / "img.png"), butterfly[:48, :48])
    ck = str(tmp_path / "ck.npz")
    rc = tcli.main([str(tmp_path), "--steps=2", "--batch=8", "--patch=16",
                    "--mesh=2,2,2", f"--ckpt={ck}"])
    assert rc == 0
    import os

    assert os.path.exists(ck)


def test_eval_step_scale_mode():
    """The eval runner can score the reference's chained-x2 step-scale
    recipe; at x4 it must produce a finite, different result from the
    single-pass row (they share the interp baseline)."""
    img = np.random.default_rng(13).integers(0, 256, (64, 48, 3), np.uint8)
    a = evaluate_image(img, 4.0, FilterType.BICUBIC, name="p")
    b = evaluate_image(img, 4.0, FilterType.BICUBIC, name="s",
                       step_scale=True)
    assert np.isfinite(b.psnr_srcnn)
    assert b.psnr_interp == a.psnr_interp
    assert b.psnr_srcnn != a.psnr_srcnn


def test_self_ensemble_identity_on_constant_input():
    """A constant image is invariant under flips AND under the resampler
    (whose half-pixel center convention is otherwise not
    flip-equivariant), so all 4 ensemble variants are identical and the
    average must equal the plain output exactly -- pins the flip/unflip
    bookkeeping (a sign error would shift pixels and break equality on
    the conv map's border response)."""
    from libsrcnn_tpu import SRCNNConfig, upscale

    img = np.full((14, 10, 3), 137, np.uint8)
    a, ca = upscale(img, 2.0, return_conv_map=True)
    b, cb = upscale(img, 2.0, SRCNNConfig(self_ensemble=True),
                    return_conv_map=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)


def test_self_ensemble_improves_butterfly(butterfly):
    """The flip ensemble must beat the plain pass on the held-out
    butterfly (measured +2.8 dB for srcnn; assert a safe margin)."""
    from libsrcnn_tpu import SRCNNConfig
    from libsrcnn_tpu.eval.runner import evaluate_image

    a = evaluate_image(butterfly, 2.0, FilterType.BICUBIC, name="p")
    b = evaluate_image(butterfly, 2.0, FilterType.BICUBIC, name="e",
                       self_ensemble=True)
    assert b.psnr_srcnn > a.psnr_srcnn + 1.0


def test_self_ensemble_step_scale_path():
    from libsrcnn_tpu import SRCNNConfig, upscale

    img = np.random.default_rng(15).integers(0, 256, (12, 10, 3), np.uint8)
    out = upscale(img, 4.0, SRCNNConfig(self_ensemble=True, step_scale=True))
    assert out.shape == (48, 40, 3) and out.dtype == np.uint8


def test_self_ensemble_through_serving():
    """The batched clip path, the streaming VideoUpscaler, AND the
    mesh-sharded batch path honor self_ensemble and agree exactly with
    the per-frame api result (the mesh path shards the 4 flip variants
    over the data axis like any other frames)."""
    import jax

    from libsrcnn_tpu import SRCNNConfig, serve, upscale
    from libsrcnn_tpu.parallel.mesh import make_mesh

    cfg = SRCNNConfig(self_ensemble=True)
    frames = np.random.default_rng(16).integers(
        0, 256, (2, 12, 10, 3), np.uint8)
    ref = np.stack([upscale(f, 2.0, cfg) for f in frames])

    clip = serve.upscale_frames(frames, 2.0, cfg)
    np.testing.assert_array_equal(clip, ref)

    vu = serve.VideoUpscaler(2.0, cfg)
    streamed = np.stack(list(vu.stream(list(frames))))
    np.testing.assert_array_equal(streamed, ref)

    mesh = make_mesh({"data": 4, "row": 1, "col": 1}, jax.devices()[:4])
    sharded = serve.upscale_frames(frames, 2.0, cfg, mesh=mesh)
    np.testing.assert_array_equal(sharded, ref)


def test_eval_rational_scale_alignment():
    """x2.5 = 5/2: the eval must crop ground truth to a multiple of 5 so
    BOTH dims recover with the exact factor -- without it the uniform-
    scale pipeline samples a misaligned grid that penalizes sharp model
    output far more than the blurry interp baseline (seen as vdsr
    'losing' 3 dB on detail-rich content under the old protocol)."""
    img = np.random.default_rng(17).integers(0, 256, (67, 44, 3), np.uint8)
    r = evaluate_image(img, 2.5, FilterType.BICUBIC, name="frac")
    r_pre = evaluate_image(img[:65, :40], 2.5, FilterType.BICUBIC,
                           name="pre")
    assert r.psnr_srcnn == r_pre.psnr_srcnn
    # a genuinely irrational-ish factor still runs through the eps path
    r_odd = evaluate_image(img, 1.37, FilterType.BICUBIC, name="odd")
    assert np.isfinite(r_odd.psnr_srcnn)


def test_eval_fractional_lr_size_is_exact(monkeypatch):
    """scale=2.2 on a 110-wide image must synthesize a 50-px LR plane:
    float division truncates (110/2.2 = 49.999... in double) and would
    silently misalign the grid the rational crop just aligned."""
    from libsrcnn_tpu import api

    captured = {}
    real = api.upscale

    def spy(lr, s, cfg=None, **kw):
        captured["lr_shape"] = np.asarray(lr).shape
        return real(lr, s, cfg, **kw)

    monkeypatch.setattr(api, "upscale", spy)
    hr = np.random.default_rng(13).integers(0, 256, (110, 110, 3), np.uint8)
    r = evaluate_image(hr, 2.2, name="t")
    assert captured["lr_shape"] == (50, 50, 3), captured
    assert np.isfinite(r.psnr_srcnn) and np.isfinite(r.psnr_interp)


def test_eval_runner_empty_dir_errors(tmp_path):
    with pytest.raises(SystemExit, match="no images"):
        eval_main([str(tmp_path)])


def test_serve_rejects_step_scale():
    from libsrcnn_tpu.config import SRCNNConfig

    cfg = SRCNNConfig(step_scale=True)
    frames = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="step_scale"):
        upscale_frames(frames, 4.0, cfg)
    with pytest.raises(ValueError, match="step_scale"):
        VideoUpscaler(4.0, cfg)


def test_stream_retries_async_materialization_failure(butterfly,
                                                      monkeypatch):
    """Async dispatch means a dropped execution raises at the device->
    host fetch, not in _run_one: the stream must re-run that frame
    through the retry loop instead of propagating."""
    import jax

    from libsrcnn_tpu import pipeline as pl
    from libsrcnn_tpu import serve

    frame = butterfly[:16, :16]
    up = VideoUpscaler(2.0)
    up.retry_backoff_s = 0.0
    real = pl.run_pass
    calls = {"n": 0}

    class Poisoned:
        def __array__(self, dtype=None, copy=None):
            raise jax.errors.JaxRuntimeError("simulated dropped execution")

    def flaky(img, params, scale, cfg):
        calls["n"] += 1
        if calls["n"] == 1:
            return (Poisoned(), None)
        return real(img, params, scale, cfg)

    monkeypatch.setattr(pl, "run_pass", flaky)
    outs = list(up.stream(iter([frame])))
    assert calls["n"] == 2  # poisoned dispatch + one successful retry
    from libsrcnn_tpu import upscale as still

    np.testing.assert_array_equal(outs[0], still(frame, 2.0))


def test_stages_rejects_non_f32():
    import jax

    from libsrcnn_tpu import SRCNNConfig, pipeline
    from libsrcnn_tpu.parallel.mesh import make_mesh
    from libsrcnn_tpu.parallel.stages import upscale_pipelined

    mesh = make_mesh({"stage": 4, "rest": 2})
    cfg = SRCNNConfig(compute_dtype="bfloat16")
    params = pipeline.load_model_params(SRCNNConfig(), 2.0)
    frames = np.zeros((4, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="f32 only"):
        upscale_pipelined(frames, params, 2.0, cfg, mesh)
