#!/usr/bin/env python3
"""Build the int8-quantized SRCNN parameter pack.

Post-training quantization of the reference 9-1-5 weights
(`convdata.h` via models/weights/srcnn_915.npz) for the int8 tier
(models/srcnn_int8.forward_y):

* weights: symmetric per-output-channel int8 (conv1/conv2) and
  per-tensor (conv3, single output channel);
* activations: the conv1/conv2 outputs are requantized to int8 with
  per-channel scales CALIBRATED here (max |activation| over a small
  image set), and each layer's per-channel activation scale is FOLDED
  into the NEXT layer's weights before those are quantized -- the
  standard trick that keeps per-channel activation ranges while the
  contraction sees a single int8 tensor;
* the conv1 input is the resized Y plane in [0, 255], so its scale is
  the fixed 255/127.

The dequant/bias/ReLU/requant chain between layers is FOLDED into one
fused-multiply-add per layer: with dequant scale d, bias b and requant
scale r (=127/a), ``clip(round(relu(acc*d + b) * r), 0, 127)`` equals
``clip(round(acc*(d*r) + b*r), 0, 127)`` (r > 0, and the clip's lower
bound subsumes the ReLU) -- so the pack ships s = d*r and t = b*r and
the int8 stack runs a single FMA + round + clip per activation element.

Outputs ``libsrcnn_tpu/models/weights/srcnn_915_int8.npz`` with
kernel-layout arrays:
  w1q int8 [81,64], s1 f32 [64] (h1 codes = clip(round(acc*s1+t1))), t1
  w2q int8 [64,32], s2 f32 [32], t2
  w3q int8 [25,32] (tap-major k=5*dx+dy), d3 f32 [1], b3 (f32 output:
  acc*d3 + b3)

Run: JAX_PLATFORMS=cpu python tools/calibrate_int8.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: safety margin on calibrated activation maxima: unseen images may run
#: slightly hotter; values beyond the range saturate (clip) rather than wrap
MARGIN = 1.05

CALIB_IMAGES = (
    "/root/reference/Pictures/butterfly.png",
    "/root/reference/Pictures/castle.jpg",
)


def _calib_set():
    from PIL import Image

    imgs = []
    for p in CALIB_IMAGES:
        if os.path.exists(p):
            imgs.append(np.asarray(Image.open(p).convert("RGB")))
    rng = np.random.default_rng(0)
    imgs.append(rng.integers(0, 256, (96, 96, 3), np.uint8))  # noise
    g = np.linspace(0, 255, 96, dtype=np.float32)
    imgs.append(np.stack(np.broadcast_arrays(g[:, None], g[None, :],
                                             g[::-1, None]),
                         -1).astype(np.uint8))  # gradients
    return imgs


def calibrate() -> tuple[np.ndarray, np.ndarray]:
    """Per-channel |max| of the conv1 (64) and conv2 (32) activations over
    the calibration set, exact f32 path."""
    from libsrcnn_tpu import api

    a1 = np.zeros(64)
    a2 = np.zeros(32)
    for img in _calib_set():
        for scale in (2.0, 3.0):
            planes = api.debug_intermediates(img, scale)
            for c in range(64):
                a1[c] = max(a1[c], np.abs(planes[f"conv1_{c}"]).max())
            for c in range(32):
                a2[c] = max(a2[c], np.abs(planes[f"conv2_{c}"]).max())
    # dead channels (all-zero activations) get scale 1 to avoid div-by-zero
    a1 = np.where(a1 < 1e-6, 1.0, a1 * MARGIN)
    a2 = np.where(a2 < 1e-6, 1.0, a2 * MARGIN)
    return a1, a2


def quantize(a1: np.ndarray, a2: np.ndarray) -> dict[str, np.ndarray]:
    from libsrcnn_tpu.models import srcnn

    p = {k: np.asarray(v, np.float64) for k, v in srcnn.load_params().items()}

    def q(w, s):
        return np.clip(np.round(w / s), -127, 127).astype(np.int8)

    sx = 255.0 / 127.0
    w1 = p["w1"].reshape(81, 64)
    s1 = np.abs(w1).max(axis=0) / 127.0
    w1q = q(w1, s1)

    # fold conv1's per-channel activation scale a1/127 into w2's rows
    w2 = p["w2"].reshape(64, 32) * (a1[:, None] / 127.0)
    s2 = np.abs(w2).max(axis=0) / 127.0
    w2q = q(w2, s2)

    # conv3 tap-major [25, 32], taps k = 5*dx + dy (kernel layout,
    # fused_conv.forward_y); fold conv2's activation scale into channels
    w3 = p["w3"][:, :, :, 0].transpose(1, 0, 2).reshape(25, 32)
    w3 = w3 * (a2[None, :] / 127.0)
    s3 = np.abs(w3).max() / 127.0
    w3q = q(w3, s3)

    r1 = 127.0 / a1
    r2 = 127.0 / a2
    d1 = sx * s1
    return {
        "w1q": w1q,
        "s1": (d1 * r1).astype(np.float32),
        "t1": (p["b1"] * r1).astype(np.float32),
        "w2q": w2q,
        "s2": (s2 * r2).astype(np.float32),
        "t2": (p["b2"] * r2).astype(np.float32),
        "w3q": w3q, "d3": np.float32([s3]),
        "b3": p["b3"].reshape(1).astype(np.float32),
        "a1": a1.astype(np.float32), "a2": a2.astype(np.float32),
    }


def main() -> None:
    a1, a2 = calibrate()
    pack = quantize(a1, a2)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "libsrcnn_tpu", "models", "weights",
                       "srcnn_915_int8.npz")
    np.savez_compressed(out, **pack)
    print(f"wrote {out}")
    print(f"a1 range [{a1.min():.1f}, {a1.max():.1f}]  "
          f"a2 range [{a2.min():.1f}, {a2.max():.1f}]")
    for k, v in pack.items():
        print(f"  {k:4s} {v.dtype} {v.shape}")


if __name__ == "__main__":
    main()
