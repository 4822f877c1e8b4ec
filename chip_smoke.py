#!/usr/bin/env python3
"""Drive the SRCNN pipeline once on the GPU at full size, phase by phase,
each phase checked against a plain reference on the same card.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

One card:

1. golden gate -- the 29 configs of tests/goldens/goldens.npz through
   ``upscale`` on the auto path, <=1 u8 LSB and SSIM >= 0.999 against
   the reference binary's output and conv map;
2. full-width srcnn -- x2 1024^2 -> 2048^2 through ``upscale`` at every
   tier and through the ``process_srcnn`` shim, against the XLA f32
   stack at ``Precision.HIGHEST`` (``use_pallas=False``);
3. serving -- ``upscale_frames`` on 16 frames at 512^2 and
   ``VideoUpscaler.stream`` on 4 frames 1080p -> 4K, bit-equal to
   per-frame ``upscale``;
4. zoo -- one 512^2 frame through each shipped family at float32 (against
   the family's own stack at HIGHEST) and bfloat16 (SSIM vs float32);
5. out-of-core -- ``upscale_chunked`` bit-identical to ``upscale`` at
   every tier it serves, and for the families;
6. training -- three ``Trainer.fit`` steps on goldens patches: the loss
   is finite and falls.

Four cards (meshes {"data":1,"row":2,"col":2} and {"data":4,"row":1,
"col":1}): ``upscale_tiled``, ``halo.forward_y_tiled``,
``sharding.upscale_batch`` / ``upscale_spatial``,
``stages.upscale_pipelined`` and the dp/sp/tp ``Trainer``, each against the
same call on one card.

Any failed check exits non-zero.  The card's name and power limit and each
phase's bound, measured value and time are printed; the last line is one
JSON object naming the device as JAX reports it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "goldens.npz")


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


try:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    import libsrcnn_tpu as lt
    from libsrcnn_tpu import SRCNNConfig, FilterType, pipeline
    from libsrcnn_tpu.eval import psnr, ssim
except ImportError as e:
    fail(f"cannot import the program ({e}); run from a checkout")


def check(ok: bool, what: str) -> None:
    if not ok:
        fail(f"FAILED: {what}")


def report(phase: str, what: str, value, bound: str, ok: bool, t0: float):
    print(f"[{phase}] {what}: {value} (bound {bound}) "
          f"{'ok' if ok else 'FAILED'} {time.perf_counter() - t0:.2f}s",
          flush=True)
    check(ok, f"{phase} {what}: {value} against {bound}")


def on_gpu(x) -> bool:
    return all(d.platform == "gpu" for d in x.devices())


def maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max())


def frame(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth frame with texture (random bytes would be all-noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
    img = base[..., None] + rng.normal(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# one card
# --------------------------------------------------------------------------

def phase_goldens(z):
    t0 = time.perf_counter()
    cases = [m.split(",") for m in z["meta"]]
    check(len(cases) == 29, f"29 golden configs, found {len(cases)}")
    worst_d, worst_s = 0, 1.0
    for key, name, mult, filt, step, _ in cases:
        cfg = SRCNNConfig(filter=FilterType(int(filt)),
                          step_scale=bool(int(step)))
        out, conv = lt.upscale(z[f"in_{name}"], float(mult), cfg,
                               return_conv_map=True)
        d = max(maxdiff(out, z[f"out_{key}"]), maxdiff(conv, z[f"conv_{key}"]))
        s = ssim(out, z[f"out_{key}"])
        check(d <= 1 and s >= 0.999, f"golden {key}: maxdiff {d} ssim {s}")
        worst_d, worst_s = max(worst_d, d), min(worst_s, s)
    report("1 goldens", f"29/29 configs, worst u8 diff / SSIM",
           f"{worst_d} / {worst_s:.6f}", "<=1 / >=0.999", True, t0)


def phase_full_width(img):
    t0 = time.perf_counter()
    ref_cfg = SRCNNConfig(use_pallas=False)
    ref_out, ref_conv = pipeline.run_pass(jnp.asarray(img),
                                          pipeline.load_model_params(ref_cfg),
                                          2.0, ref_cfg)
    check(on_gpu(ref_out), "reference output lives on the GPU")
    ref_out, ref_conv = np.asarray(ref_out), np.asarray(ref_conv)
    report("2 full-width", "XLA f32 HIGHEST reference 1024^2 -> 2048^2",
           ref_out.shape, "(2048, 2048, 3)", ref_out.shape == (2048, 2048, 3),
           t0)
    outs = {}
    for tier in ("float32", "bfloat16", "bfloat16_fast", "int8"):
        t0 = time.perf_counter()
        cfg = SRCNNConfig(compute_dtype=tier)
        dev_out, _ = pipeline.run_pass(jnp.asarray(img),
                                       pipeline.load_model_params(cfg), 2.0,
                                       cfg)
        check(on_gpu(dev_out), f"{tier} output lives on the GPU")
        out, conv = lt.upscale(img, 2.0, cfg, return_conv_map=True)
        outs[tier] = out
        path = ("fused kernel" if pipeline.resolve_pallas(None, tier)
                else "XLA")
        if tier == "float32":
            d = max(maxdiff(out, ref_out), maxdiff(conv, ref_conv))
            report("2 full-width", f"upscale {tier} ({path}) vs reference, "
                   "RGB and conv map max u8 diff", d, "<=1", d <= 1, t0)
        elif tier == "int8":
            p = psnr(out, outs["float32"])
            report("2 full-width", f"upscale {tier} ({path}) PSNR vs exact",
                   f"{p:.2f} dB", ">=38 dB", p >= 38.0, t0)
        else:
            s = ssim(out, outs["float32"])
            report("2 full-width", f"upscale {tier} ({path}) SSIM vs exact",
                   f"{s:.6f}", ">=0.99", s >= 0.99, t0)
    t0 = time.perf_counter()
    lt.configure_filter_srcnn(FilterType.BICUBIC, False)
    rc, ob, cb = lt.process_srcnn(img.tobytes(), img.shape[1], img.shape[0],
                                  3, 2.0)
    check(rc == 0, f"process_srcnn rc {rc}")
    d = max(maxdiff(ob.reshape(ref_out.shape), ref_out),
            maxdiff(cb.reshape(ref_conv.shape), ref_conv))
    report("2 full-width", "process_srcnn (default float32 tier) vs "
           "reference, max u8 diff", d, "<=1", d <= 1, t0)


def phase_serving():
    from libsrcnn_tpu.serve import VideoUpscaler, upscale_frames

    t0 = time.perf_counter()
    clip = np.stack([frame(512, 512, 100 + i) for i in range(16)])
    out = upscale_frames(clip, 2.0)
    d = max(maxdiff(out[i], lt.upscale(clip[i], 2.0)) for i in range(16))
    report("3 serving", "upscale_frames 16 x 512^2 vs per-frame upscale, "
           "max u8 diff", d, "==0", d == 0, t0)
    t0 = time.perf_counter()
    frames = [frame(1080, 1920, 200 + i) for i in range(4)]
    outs = list(VideoUpscaler(scale=2.0).stream(iter(frames)))
    check(len(outs) == 4 and outs[0].shape == (2160, 3840, 3),
          "stream yields four 2160x3840 frames")
    d = max(maxdiff(o, lt.upscale(f, 2.0)) for o, f in zip(outs, frames))
    report("3 serving", "VideoUpscaler.stream 4 x 1080p -> 4K vs per-frame "
           "upscale, max u8 diff", d, "==0", d == 0, t0)


def _family_reference(model: str, img, params):
    """The family's own stack at HIGHEST, with the pipeline's color and
    resize around it, written out by hand."""
    from libsrcnn_tpu.config import chroma_filter
    from libsrcnn_tpu.ops import color, resize

    mod = pipeline._lr_family(model)
    spec = params["__spec__"]
    p = {k: v for k, v in params.items() if k != "__spec__"}
    planes = color.rgb_to_ycbcr(jnp.asarray(img))
    h, w = img.shape[:2]
    bic = FilterType.BICUBIC
    hi = jax.lax.Precision.HIGHEST
    if model in pipeline.LR_FAMILIES:
        y = mod.forward_lr(p, planes[0], spec, precision=hi)
    else:
        y = mod.forward_hr(p, resize.resize_plane(planes[0], 2 * h, 2 * w,
                                                  bic), spec, precision=hi)
    rest = [resize.resize_plane(planes[c], 2 * h, 2 * w, chroma_filter(bic))
            for c in (1, 2)]
    return np.asarray(color.ycbcr_to_rgb(jnp.stack([y, *rest])))


def phase_zoo():
    img = frame(512, 512, 300)
    for model in ("fsrcnn", "espcn", "vdsr", "srcnn955"):
        t0 = time.perf_counter()
        f32 = SRCNNConfig(model=model)
        params = pipeline.load_model_params(f32, 2.0)
        out32 = lt.upscale(img, 2.0, f32)
        ref = _family_reference(model, img, params)
        d = maxdiff(out32, ref)
        report("4 zoo", f"{model} float32 vs its stack at HIGHEST, max u8 "
               "diff", d, "<=1", d <= 1, t0)
        t0 = time.perf_counter()
        out16 = lt.upscale(img, 2.0, SRCNNConfig(model=model,
                                                 compute_dtype="bfloat16"))
        s = ssim(out16, out32)
        report("4 zoo", f"{model} bfloat16 SSIM vs float32", f"{s:.6f}",
               ">=0.99", s >= 0.99, t0)


def phase_chunked():
    img = frame(1024, 1024, 400)
    for tier in ("float32", "bfloat16", "bfloat16_fast"):
        t0 = time.perf_counter()
        cfg = SRCNNConfig(compute_dtype=tier)
        ref, refc = lt.upscale(img, 2.0, cfg, return_conv_map=True)
        out, conv = lt.upscale_chunked(img, 2.0, cfg, band_rows=384)
        d = max(maxdiff(out, ref), maxdiff(conv, refc))
        path = ("fused kernel, pad_mode=halo"
                if pipeline.resolve_pallas(None, tier) else "XLA")
        report("5 chunked", f"srcnn {tier} ({path}) 1024^2 x2 in 384-row "
               "bands vs upscale, max u8 diff", d, "==0", d == 0, t0)
    small = frame(256, 256, 401)
    for model, tier, ens in (("vdsr", "float32", False),
                             ("vdsr", "bfloat16", False),
                             ("srcnn", "float32", True),
                             ("fsrcnn", "float32", False),
                             ("espcn", "bfloat16", False)):
        t0 = time.perf_counter()
        cfg = SRCNNConfig(model=model, compute_dtype=tier,
                          self_ensemble=ens)
        ref = lt.upscale(small, 2.0, cfg)
        out, _ = lt.upscale_chunked(small, 2.0, cfg, band_rows=96)
        d = maxdiff(out, ref)
        tag = f"{model}{' +ensemble' if ens else ''} {tier}"
        if model != "srcnn" and tier == "bfloat16":
            # the families' bfloat16 tier is XLA convs at DEFAULT (TF32),
            # whose algorithm XLA picks per shape: bands are not
            # bit-identical on the GPU (PERF.md, ROADMAP R1)
            s = ssim(out, ref)
            report("5 chunked", f"{tag} 256^2 x2 in 96-row bands vs upscale, "
                   f"max u8 diff {d}, SSIM", f"{s:.6f}", ">=0.999",
                   s >= 0.999, t0)
            continue
        report("5 chunked", f"{tag} 256^2 x2 in 96-row bands vs upscale, "
               "max u8 diff", d, "==0", d == 0, t0)


def phase_training(z):
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.train.data import make_patch_batch
    from libsrcnn_tpu.train.trainer import Trainer

    t0 = time.perf_counter()
    batch = make_patch_batch([z["in_butterfly_full"]], 32, patch=64, seed=0)
    # fine-tuning the shipped weights on one batch: three steps must
    # lower its loss
    losses = Trainer(params=srcnn.load_params(),
                     learning_rate=1e-5).fit([batch] * 3)
    ok = bool(np.all(np.isfinite(losses))) and losses[-1] < losses[0]
    report("6 training", "Trainer.fit 3 steps, 32 x 64^2 patches: losses",
           [round(v, 3) for v in losses], "finite and falling", ok, t0)


def one_card():
    z = np.load(GOLDENS)
    phase_goldens(z)
    phase_full_width(frame(1024, 1024, 1))
    phase_serving()
    phase_zoo()
    phase_chunked()
    phase_training(z)


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def shards_on_own_cards(x, n: int) -> bool:
    devs = [s.device for s in x.addressable_shards]
    return len(devs) == n and len(set(devs)) == n


def four_cards():
    from libsrcnn_tpu.kernels import fused_conv
    from libsrcnn_tpu.models import srcnn
    from libsrcnn_tpu.parallel import halo, sharding, upscale_pipelined
    from libsrcnn_tpu.parallel import upscale_tiled
    from libsrcnn_tpu.parallel.mesh import make_mesh
    from libsrcnn_tpu.train.data import make_patch_batch
    from libsrcnn_tpu.train.trainer import Trainer

    devs = jax.devices()[:4]
    check(len(devs) == 4, f"four cards, found {len(jax.devices())}")
    spatial = make_mesh({"data": 1, "row": 2, "col": 2}, devs)
    data = make_mesh({"data": 4, "row": 1, "col": 1}, devs)
    img = frame(1080, 1920, 500)

    for tier in ("float32", "bfloat16", "bfloat16_fast"):
        t0 = time.perf_counter()
        cfg = SRCNNConfig(compute_dtype=tier)
        params = pipeline.load_model_params(cfg)
        one, one_c = pipeline.run_pass(jnp.asarray(img), params, 2.0, cfg)
        out, conv = upscale_tiled(img, params, 2.0, cfg, spatial)
        check(shards_on_own_cards(out, 4), "tiled output on 4 cards")
        d = max(maxdiff(out, one), maxdiff(conv, one_c))
        report("4-card tiled", f"upscale_tiled {tier} 1080p -> 4K, 2x2 vs "
               "one card, max u8 diff", d, "==0", d == 0, t0)

    y = jnp.asarray(np.random.default_rng(2).uniform(
        0, 255, (2048, 2048)).astype(np.float32))
    p32 = srcnn.load_params()
    for tier in ("float32", "bfloat16", "bfloat16_fast"):
        t0 = time.perf_counter()
        if pipeline.resolve_pallas(None, tier):
            ref = fused_conv.forward_y(p32, y, tier=tier)
        else:
            ref = srcnn.forward_y(p32, y)
        out = halo.forward_y_tiled(p32, y, spatial, compute_dtype=tier)
        check(shards_on_own_cards(out, 4), "halo output on 4 cards")
        d = float(np.abs(np.asarray(out) - np.asarray(ref)).max())
        report("4-card halo", f"forward_y_tiled {tier} 2048^2, 2x2 vs one "
               "card, max abs diff", d, "==0", d == 0.0, t0)

    t0 = time.perf_counter()
    clip = np.stack([frame(512, 512, 600 + i) for i in range(16)])
    cfg = SRCNNConfig()
    params = pipeline.load_model_params(cfg)
    out, conv = sharding.upscale_batch(jnp.asarray(clip), params, 2.0, cfg,
                                       data)
    check(shards_on_own_cards(out, 4), "batch output on 4 cards")
    d = max(maxdiff(out[i], lt.upscale(clip[i], 2.0)) for i in range(16))
    report("4-card batch", "upscale_batch 16 x 512^2, data=4 vs one card, "
           "max u8 diff", d, "==0", d == 0, t0)

    for model, bound in (("srcnn", 0), ("fsrcnn", 1)):
        t0 = time.perf_counter()
        cfg = SRCNNConfig(model=model, use_pallas=False)
        params = pipeline.load_model_params(cfg, 2.0)
        one, _ = pipeline.run_pass(jnp.asarray(img), params, 2.0, cfg)
        out, _ = sharding.upscale_spatial(jnp.asarray(img), params, 2.0, cfg,
                                          spatial)
        check(shards_on_own_cards(out, 4), "spatial output on 4 cards")
        d = maxdiff(out, one)
        report("4-card spatial", f"upscale_spatial {model} 1080p -> 4K, 2x2 "
               "GSPMD vs one card, max u8 diff", d, f"<={bound}", d <= bound,
               t0)

    t0 = time.perf_counter()
    stages = make_mesh({"stage": 4}, devs)
    frames = np.stack([frame(512, 512, 700 + i) for i in range(4)])
    cfg = SRCNNConfig(use_pallas=False)
    params = pipeline.load_model_params(cfg)
    out, _ = upscale_pipelined(frames, params, 2.0, cfg, stages)
    d = max(maxdiff(out[i], lt.upscale(frames[i], 2.0, cfg))
            for i in range(4))
    report("4-card stages", "upscale_pipelined 4 stages, 4 x 512^2 vs one "
           "card, max u8 diff", d, "==0", d == 0, t0)

    z = np.load(GOLDENS)
    batch = make_patch_batch([z["in_butterfly_full"]], 16, patch=64, seed=0)
    one = Trainer(params=srcnn.load_params(), learning_rate=1e-5).fit(
        [batch])[0]
    for name, mesh in (("sp 2x2 (filters replicated over col)", spatial),
                       ("dp 4", data)):
        t0 = time.perf_counter()
        loss = Trainer(params=srcnn.load_params(), learning_rate=1e-5,
                       mesh=mesh).fit([batch])[0]
        rel = abs(loss - one) / abs(one)
        report("4-card train", f"Trainer step {name} loss {loss:.6f} vs one "
               f"card {one:.6f}, relative diff", f"{rel:.2e}", "<=1e-4",
               rel <= 1e-4, t0)


def main() -> int:
    four = "--four-cards" in sys.argv[1:]
    if jax.default_backend() != "gpu":
        fail(f"no GPU: JAX's backend is {jax.default_backend()!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"jax {jax.__version__}", flush=True)
    t0 = time.perf_counter()
    if four:
        four_cards()
    else:
        one_card()
    print(f"all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": 4 if four else len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
