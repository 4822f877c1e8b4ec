"""Gigapixel-style tiled upscale over a device mesh.

On a multi-chip slice this shards one big frame spatially with explicit
explicit halo exchange at every stage; on a single machine run it against the
virtual CPU mesh:

  JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/04_multichip_tiled.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

from libsrcnn_tpu import SRCNNConfig, upscale
from libsrcnn_tpu.models import srcnn
from libsrcnn_tpu.parallel import make_mesh, upscale_tiled

n = len(jax.devices())
rows = 4 if n >= 8 else (2 if n >= 2 else 1)
cols = 2 if n >= 8 else 1
mesh = make_mesh({"data": 1, "row": rows, "col": cols},
                 jax.devices()[: rows * cols])
print(f"{n} devices -> mesh row={rows} col={cols}")

params = srcnn.load_params()
img = np.random.default_rng(0).integers(0, 256, (64 * rows, 96 * cols, 3),
                                        np.uint8)
out, conv = upscale_tiled(img, params, 2.0, SRCNNConfig(), mesh)
print(f"tiled output {np.asarray(out).shape}")

ref = upscale(img, 2.0)
diff = np.abs(np.asarray(out).astype(int) - ref.astype(int)).max()
print(f"vs single-device pipeline: max u8 diff {diff}")
assert diff <= 1
