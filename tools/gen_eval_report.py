#!/usr/bin/env python3
"""Generate EVAL.md: model-zoo quality report on the available corpus.

Protocol (standard SR evaluation, eval/runner.py): downscale each
ground-truth image by 1/s with the framework's reference-exact bicubic,
super-resolve back with each model family, and report PSNR/SSIM against
the ground truth next to the classical-interpolation baseline.

Corpus: the reference repo's sample images (butterfly.png, castle.jpg)
plus scikit-learn's two sample photos -- the same held-out/train split as
tools/train_fsrcnn.py uses (butterfly + castle are NOT in the LR
families' training corpus; china/flower are, and are marked).

Run (CPU is fine):
    JAX_PLATFORMS=cpu python tools/gen_eval_report.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUT = os.path.join(os.path.dirname(__file__), "..", "EVAL.md")


def corpus() -> list[tuple[str, str, np.ndarray]]:
    """(name, train-status, rgb u8) tuples."""
    from PIL import Image

    items = [
        ("butterfly.png", "held out", "/root/reference/Pictures/butterfly.png"),
        ("castle.jpg", "trained on*", "/root/reference/Pictures/castle.jpg"),
    ]
    try:
        import sklearn

        img_dir = os.path.join(os.path.dirname(sklearn.__file__),
                               "datasets", "images")
        items += [("china.jpg", "trained on*", os.path.join(img_dir, "china.jpg")),
                  ("flower.jpg", "trained on*", os.path.join(img_dir, "flower.jpg"))]
    except ImportError:
        pass
    rows = [(n, t, np.asarray(Image.open(p).convert("RGB")))
            for n, t, p in items if os.path.exists(p)]
    # additional NEVER-trained-on images (tools/corpus.py reserves them):
    # grace_hopper + two labmaze faces, so every quality claim rests on
    # >= 3 held-out measurements, not butterfly alone
    import corpus as _corpus

    rows += [(n, "held out", img) for n, img in _corpus.eval_holdout_images()]
    return rows


def shipped_scales(family: str) -> list[int]:
    wdir = os.path.join(os.path.dirname(__file__), "..", "libsrcnn_tpu",
                        "models", "weights")
    return sorted(int(f.split("_x")[1].split(".")[0])
                  for f in os.listdir(wdir)
                  if f.startswith(family + "_x") and f.endswith(".npz"))


def main() -> int:
    from libsrcnn_tpu.eval.runner import evaluate_image

    images = corpus()
    rows = []
    # x2.5 rows exercise the fractional factors only the HR-domain
    # models (srcnn, vdsr) can serve -- no integer crop, f32-truncated
    # sizes, exactly the reference's arbitrary-multiply semantics
    models = [("srcnn", [2, 2.5, 3, 4])]
    for fam in ("fsrcnn", "espcn"):
        s = shipped_scales(fam)
        if s:
            models.append((fam, s))
    wdir = os.path.join(os.path.dirname(__file__), "..", "libsrcnn_tpu",
                        "models", "weights")
    if os.path.exists(os.path.join(wdir, "srcnn955.npz")):
        # Dong et al.'s higher-rated 9-5-5 head (scale-agnostic, HR-domain)
        models.append(("srcnn955", [2, 2.5, 3, 4]))
    if os.path.exists(os.path.join(wdir, "vdsr.npz")):
        models.append(("vdsr", [2, 2.5, 3, 4]))  # scale-agnostic checkpoint

    # the reference's own recipe for factors beyond x2 is step-scale
    # (chained x2 passes, `libsrcnn.cpp:980-1061`); report it next to the
    # single-pass srcnn rows it is meant to replace
    models.insert(1, ("srcnn+step", [3, 4]))
    # the flip self-ensemble tier (4x compute for free quality) on the
    # parity model and the quality flagship
    models.insert(2, ("srcnn+ens", [2, 3, 4]))
    if any(m == "vdsr" for m, _ in models):
        models.append(("vdsr+ens", [2, 3, 4]))

    for model, scales in models:
        fam, step, ens = model, False, False
        if model.endswith("+step"):
            fam, step = model[:-5], True
        elif model.endswith("+ens"):
            fam, ens = model[:-4], True
        for s in scales:
            for name, status, img in images:
                r = evaluate_image(img, float(s), name=name, model=fam,
                                   step_scale=step, self_ensemble=ens)
                rows.append((model, s, name, status, r))
                print(f"{model} x{s} {name}: interp {r.psnr_interp:.2f}/"
                      f"{r.ssim_interp:.4f}  model {r.psnr_srcnn:.2f}/"
                      f"{r.ssim_srcnn:.4f}  gain {r.psnr_gain:+.2f} dB",
                      flush=True)

    lines = [
        "# EVAL — model-zoo quality report",
        "",
        "PSNR (dB) / SSIM against ground truth; LR inputs synthesized with",
        "the framework's reference-exact bicubic downscale "
        "(`eval/runner.py` protocol,",
        "the standard SR evaluation the reference itself never automates —",
        "SURVEY.md §4). `interp` = classical bicubic upscale baseline.",
        "Generated by `tools/gen_eval_report.py`; regenerate after retraining.",
        "",
        "**Dataset limitation**: the standard SR benchmark sets "
        "(Set5/Set14, SURVEY.md",
        "§4/§6) cannot be fetched — this container has no network egress "
        "and no",
        "skimage/pooch. The corpus below is every usable in-container "
        "image; drop a",
        "dataset directory in and `eval/runner.py` ingests it the moment "
        "one exists.",
        "",
        "`*` the shipped trained families (fsrcnn/espcn/vdsr/srcnn955) saw "
        "ONLY",
        "castle/china/flower during training (base corpus; the final "
        "round-4/5",
        "schedules dropped the texture set). Every `held out` "
        "row is",
        "genuinely unseen: butterfly, matplotlib's grace_hopper, and two "
        "labmaze",
        "faces reserved by `tools/corpus.py:EVAL_HOLDOUT_TEXTURES` "
        "(excluded from",
        "`corpus_images(extended=True)` permanently).",
        "The srcnn rows use the reference's own pre-trained 9-1-5 weights",
        "(trained on none of these — an external checkpoint from 2014).",
        "",
        "| model | scale | image | split | interp PSNR/SSIM | model "
        "PSNR/SSIM | gain |",
        "|---|---|---|---|---|---|---|",
    ]
    for model, s, name, status, r in rows:
        lines.append(
            f"| {model} | x{s} | {name} | {status} | "
            f"{r.psnr_interp:.2f} / {r.ssim_interp:.4f} | "
            f"{r.psnr_srcnn:.2f} / {r.ssim_srcnn:.4f} | "
            f"{r.psnr_gain:+.2f} dB |")

    lines += [
        "",
        "Reading the table: SRCNN's shipped weights were trained for ≤×2",
        "(reference README), so its ×3/×4 gains shrink — matching the",
        "reference's own behavior. `srcnn+step` is the reference's",
        "step-scale recipe for exactly this case (chained ×2 passes,",
        "`libsrcnn.cpp:980-1061`): measured, it is WORSE than single-pass",
        "at ×3/×4 — each pass re-sharpens the previous pass's artifacts",
        "through a u8 round-trip. The reference never quantified this (it",
        "has no automated evaluation, SURVEY.md §4); this framework's",
        "answer to >×2 factors is the model zoo below. The LR families",
        "carry per-scale heads and keep their gains at higher factors on",
        "in-domain content; the four held-out images (butterfly,",
        "grace_hopper, two reserved labmaze faces) are the honest",
        "numbers.  One instructive held-out regression: on the very",
        "smooth wall_purple face (interp already 33-38 dB) the learned",
        "models can LOSE to bicubic (srcnn955 ×2 −5.7 dB) — texture",
        "hallucination hurts near-flat content; bicubic or vdsr+ens are",
        "the right tools there.",
        "VDSR is one scale-agnostic checkpoint (mixed ×2/×3/×4 training)",
        "refining the interpolated plane; the ×2.5 rows measure the",
        "fractional factors only the HR-domain models can serve (the",
        "per-scale LR heads cannot — their exact-scale contract raises).",
        "`+ens` rows are the flip self-ensemble",
        "(`SRCNNConfig(self_ensemble=True)`): 4 flip variants in one",
        "batched device dispatch, averaged — 4× compute for a free",
        "quality bump; srcnn gains the most because the 2014 checkpoint's",
        "artifacts are strongly direction-biased and flipping cancels",
        "them.",
        "",
    ]
    with open(os.path.abspath(OUT), "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {os.path.abspath(OUT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
