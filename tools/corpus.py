#!/usr/bin/env python3
"""Training corpus assembly from IN-CONTAINER image sources.

The environment has no egress, so DIV2K/T91/Set5 cannot be fetched; the
round-3 corpus was 3 photos (castle + scikit-learn's china/flower,
~1.1 MP), and a wider VDSR overfit on it.  This
module breaks that wall with what the container actually ships:

* **Base photos** (3): `/root/reference/Pictures/castle.jpg` plus
  scikit-learn's bundled `china.jpg`/`flower.jpg` -- the round-3 corpus.
* **labmaze textures** (~89 files, 1024x1024 each): DeepMind Lab's
  wall/floor/sky game textures bundled with the `labmaze` wheel --
  photographic surface textures (brick, concrete, metal, clouds) with
  dense high-frequency detail, exactly the statistics SR training needs.
  Curated by Y-plane gradient energy: flat color fills and near-empty
  sky faces train nothing and are dropped.

`scipy.datasets.face()/ascent()` were evaluated and are NOT available:
scipy's data files are fetched via `pooch`, which is not installed
(verified: ImportError), so the module import succeeds but every loader
raises.  matplotlib's grace_hopper.jpg was measured a regression in
round 3 and stays out.

butterfly.png remains HELD OUT everywhere (validation only).
"""

from __future__ import annotations

import glob
import os

import numpy as np

#: minimum mean |gradient| of the Y plane for a texture to qualify --
#: below this the image is a flat fill / empty sky face with no texture
#: statistics to learn from (measured range in the set: 0.0 .. 15.9)
MIN_DETAIL = 1.0

def _labmaze_files() -> list[str]:
    try:
        import labmaze
    except ImportError:
        return []
    return sorted(glob.glob(os.path.join(os.path.dirname(labmaze.__file__),
                                         "assets", "**", "*.png"),
                            recursive=True))


def _y_detail(rgb: np.ndarray) -> float:
    """Mean absolute gradient of the (approximate) luma plane."""
    y = rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    return float(np.abs(np.diff(y, axis=0)).mean()
                 + np.abs(np.diff(y, axis=1)).mean())


def base_images() -> list[np.ndarray]:
    """The round-3 photo corpus (castle + sklearn china/flower)."""
    from PIL import Image

    paths = ["/root/reference/Pictures/castle.jpg"]
    try:
        import sklearn

        img_dir = os.path.join(os.path.dirname(sklearn.__file__),
                               "datasets", "images")
        for name in ("china.jpg", "flower.jpg"):
            p = os.path.join(img_dir, name)
            if os.path.exists(p):
                paths.append(p)
    except ImportError:
        pass
    return [np.asarray(Image.open(p).convert("RGB")) for p in paths
            if os.path.exists(p)]


#: textures reserved for EVALUATION (tools/gen_eval_report.py) and
#: excluded from the training corpus forever -- quality claims need
#: held-out measurements beyond the single butterfly.
#: One high-detail and one mid-detail face, fixed by name.
EVAL_HOLDOUT_TEXTURES = ("style_01/floor_light_m.png",
                         "style_02/wall_purple_d.png")


def eval_holdout_images() -> list[tuple[str, np.ndarray]]:
    """(name, rgb u8) images NEVER seen by any trainer: matplotlib's
    grace_hopper photo (kept out of training since round 3) and the
    two reserved labmaze faces (center-cropped to 512^2 to keep eval
    runtime sane)."""
    from PIL import Image

    out = []
    try:
        import matplotlib

        p = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                         "sample_data", "grace_hopper.jpg")
        if os.path.exists(p):
            out.append(("grace_hopper.jpg",
                        np.asarray(Image.open(p).convert("RGB"))))
    except ImportError:
        pass
    import warnings

    for f in _labmaze_files():
        tail = f.split("assets/")[-1] if "assets/" in f else os.path.basename(f)
        if tail in EVAL_HOLDOUT_TEXTURES:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                rgb = np.asarray(Image.open(f).convert("RGB"))
            h, w = rgb.shape[:2]
            r0, c0 = (h - 512) // 2, (w - 512) // 2
            out.append(("labmaze/" + tail.replace("/", "_"),
                        rgb[r0:r0 + 512, c0:c0 + 512]))
    return out


def texture_images(min_detail: float = MIN_DETAIL,
                   limit: int | None = None) -> list[np.ndarray]:
    """Curated labmaze textures as RGB u8, detail-richest first (the
    :data:`EVAL_HOLDOUT_TEXTURES` are excluded -- they are eval-only)."""
    from PIL import Image

    files = [f for f in _labmaze_files()
             if (f.split("assets/")[-1] if "assets/" in f
                 else os.path.basename(f)) not in EVAL_HOLDOUT_TEXTURES]
    scored = []
    import warnings

    for f in files:
        try:
            with warnings.catch_warnings():
                # palettized-with-transparency decode warning is benign:
                # we flatten to RGB either way
                warnings.simplefilter("ignore", UserWarning)
                rgb = np.asarray(Image.open(f).convert("RGB"))
        except Exception:
            continue
        d = _y_detail(rgb)
        if d >= min_detail:
            scored.append((d, f, rgb))
    scored.sort(key=lambda t: -t[0])
    if limit is not None:
        scored = scored[:limit]
    return [rgb for _, _, rgb in scored]


def corpus_images(extended: bool = True,
                  limit_textures: int | None = None) -> list[np.ndarray]:
    """The training corpus (butterfly always held out).

    ``extended=False`` reproduces the round-3 3-photo corpus;
    ``extended=True`` (default) adds the curated labmaze textures.
    """
    images = base_images()
    if extended:
        images += texture_images(limit=limit_textures)
    return images


if __name__ == "__main__":
    imgs = corpus_images()
    mp = sum(i.shape[0] * i.shape[1] for i in imgs) / 1e6
    print(f"extended corpus: {len(imgs)} images, {mp:.1f} MP "
          f"(base {len(base_images())} photos + "
          f"{len(imgs) - len(base_images())} curated textures)")
