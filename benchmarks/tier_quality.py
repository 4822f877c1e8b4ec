#!/usr/bin/env python3
"""Quality of the throughput tiers vs the exact tier, end-to-end.

Runs the FULL pipeline (u8 RGB -> color -> resize -> convs -> merge -> u8)
on real golden inputs and reports, per tier, the u8 deviation from the
exact (golden-gated) tier: max |diff|, PSNR, SSIM.  This is the number the
headline benchmark's ">=0.99 SSIM" claim rests on, measured rather than
asserted.

Run on the GPU:  python benchmarks/tier_quality.py
(also works on CPU -- the Pallas kernel runs in interpreter mode there).
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> None:
    import jax

    from libsrcnn_tpu import SRCNNConfig, pipeline
    from libsrcnn_tpu.eval import metrics
    from libsrcnn_tpu.models import srcnn

    z = np.load(sys.path[0] + "/tests/goldens/goldens.npz")
    inputs = {
        "butterfly256": z["in_butterfly_full"],
        "castle96": z["in_castle96"],
        "noise33": z["in_noise33"],
    }
    tiers = ["bfloat16", "bfloat16_fast"]

    # use_pallas=True explicitly: the tier ladder lives in the fused
    # kernel's GEMM modes; on CPU the default would resolve to the XLA
    # path, where both bf16 tiers are the same computation (the kernel
    # runs in interpreter mode on CPU -- slow, but it measures the modes
    # this tool exists to measure)
    for name, img in inputs.items():
        for scale in (2.0, 3.0):
            exact_cfg = SRCNNConfig(use_pallas=True)
            params = jax.device_put(srcnn.load_params())
            exact = np.asarray(
                pipeline.run_pass(img, params, scale, exact_cfg)[0])
            for tier in tiers:
                cfg = SRCNNConfig(compute_dtype=tier, use_pallas=True)
                tp = jax.device_put(pipeline.load_model_params(cfg, scale))
                try:
                    out = np.asarray(
                        pipeline.run_pass(img, tp, scale, cfg)[0])
                except ValueError as e:
                    print(f"{name} x{scale} {tier}: skipped ({e})")
                    continue
                d = np.abs(out.astype(np.int32) - exact.astype(np.int32))
                psnr = metrics.psnr(out, exact)
                ssim = metrics.ssim(out, exact)
                print(f"{name:13s} x{scale:.0f} {tier:14s} "
                      f"max {int(d.max()):2d} u8   mean {d.mean():.4f}   "
                      f"PSNR {psnr:6.2f} dB   SSIM {ssim:.6f}")


if __name__ == "__main__":
    main()
