"""Still-image upscaling: the reference workflow, in JAX.

Usage: python examples/01_upscale_image.py [image.png] [scale]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import libsrcnn_tpu as lt
from libsrcnn_tpu.io import load_image, save_png

path = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/Pictures/butterfly.png"
scale = float(sys.argv[2]) if len(sys.argv) > 2 else 2.0

img = load_image(path)
print(f"input {img.shape[1]}x{img.shape[0]}, scale x{scale}")

# default: bicubic + SRCNN on the Y channel (the exact f32 tier)
out, conv_map = lt.upscale(img, scale, return_conv_map=True)
save_png("out_srcnn.png", out)
save_png("out_convmap.png", conv_map)

# classical-filter variants
for ft in (lt.FilterType.LANCZOS3, lt.FilterType.NEAREST):
    alt = lt.upscale(img, scale, lt.SRCNNConfig(filter=ft))
    save_png(f"out_{ft.name.lower()}.png", alt)

# step-scale: big factors as chained x2 passes (better for the 2x-trained net)
if scale > 2:
    stepped = lt.upscale(img, scale, lt.SRCNNConfig(step_scale=True))
    save_png("out_stepscale.png", stepped)

# bf16 throughput tier (SSIM >= 0.99 vs the exact tier)
fast = lt.upscale(img, scale, lt.SRCNNConfig(compute_dtype="bfloat16"))
diff = np.abs(out.astype(int) - fast.astype(int)).max()
print(f"bf16 mode max u8 diff vs exact: {diff}")
print("wrote out_*.png")
