"""The srcnn compute-tier ladder: one flag, four speed/exactness points.

The three float tiers run the same fused kernel; only the dots change
(kernels/fused_conv._mm, measured story in PERF.md):

  float32        exact -- f32-accurate dots; this is the tier the golden
                 gate holds to <=1 u8 LSB vs the reference binary (the
                 library default).
  bfloat16       activations split hi+lo into TWO bf16 dots against bf16
                 weights; only weight rounding remains.
  bfloat16_fast  ONE bf16 dot per conv -- adds activation rounding.
  int8           quantized draft -- XLA int8 convs, no fused kernel.

``use_pallas=True`` is set explicitly so the ladder is demonstrated on
every backend: on CPU the kernel runs in interpreter mode (slow but
numerically the same -- without the flag, CPU would take the XLA path
where the two bf16 tiers are the same computation).  Run on the GPU for
the speed column to mean something.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

from libsrcnn_tpu import SRCNNConfig, upscale
from libsrcnn_tpu.eval import psnr, ssim

rng = np.random.default_rng(0)
y, x = np.mgrid[0:96, 0:96]
img = np.stack([
    (127 + 90 * np.sin(x / 9.0) * np.cos(y / 13.0)),
    (127 + 80 * np.cos((x + y) / 11.0)),
    (127 + 70 * np.sin(x * y / 700.0)),
], -1).clip(0, 255).astype(np.uint8)

exact = upscale(img, 2.0, SRCNNConfig(use_pallas=True))
print(f"{'tier':15s} {'ms':>8s} {'max u8':>7s} {'PSNR':>7s} {'SSIM':>8s}"
      f"   (vs the exact tier)")
for tier in ("float32", "bfloat16", "bfloat16_fast", "int8"):
    cfg = SRCNNConfig(compute_dtype=tier, use_pallas=True)
    out = upscale(img, 2.0, cfg)  # warm / compile
    t0 = time.perf_counter()
    out = upscale(img, 2.0, cfg)
    ms = (time.perf_counter() - t0) * 1e3
    d = int(np.abs(out.astype(int) - exact.astype(int)).max())
    print(f"{tier:15s} {ms:8.1f} {d:7d} {psnr(out, exact):7.2f} "
          f"{ssim(out, exact):8.5f}")
