"""Pipeline-stage parallelism: stream a clip through the SRCNN stack
split across a ``stage`` mesh axis (GPipe-style schedule).

Each device owns a contiguous group of stages (resize -> conv1 -> conv2 ->
conv3+merge) and frames flow through in N+S-1 systolic steps, one
``ppermute`` activation hand-off per step.  Use this when per-chip memory
(one stage's weights + one activation buffer) matters more than raw
throughput -- see SCALING.md section 4 for the trade.  Run locally on the
virtual CPU mesh:

  JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/06_pipelined_stages.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from libsrcnn_tpu import SRCNNConfig, pipeline, upscale
from libsrcnn_tpu.parallel import make_mesh
from libsrcnn_tpu.parallel.stages import upscale_pipelined

n = len(jax.devices())
n_stages = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
assert n_stages > 1, "need >=2 devices for a pipeline"
mesh = make_mesh({"stage": n_stages, "rest": n // n_stages})
print(f"{n} devices -> {n_stages}-stage pipeline")

cfg = SRCNNConfig()
params = pipeline.load_model_params(cfg)
frames = np.random.default_rng(0).integers(0, 256, (6, 48, 64, 3), np.uint8)

out, conv = upscale_pipelined(frames, params, 2.0, cfg, mesh)
print(f"clip {frames.shape} -> {np.asarray(out).shape} "
      f"in {frames.shape[0]} + {n_stages - 1} pipeline steps")

ref0 = upscale(frames[0], 2.0, cfg)
assert np.array_equal(np.asarray(out)[0], ref0), "not bit-identical!"
print("bit-identical to the single-device pipeline")
