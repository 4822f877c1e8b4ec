"""libsrcnn_tpu -- a single-image super-resolution framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
rageworx/libsrcnn (SRCNN 9-1-5 super-resolution with classical
interpolation upscaling): the whole pipeline is one jitted XLA program
per shape, the srcnn conv stack can run as a fused Pallas (Triton)
kernel on the GPU, and large frames / batches shard across a device mesh
with explicit halo exchange.
"""

import os as _os
import pathlib as _pathlib

# Persistent XLA compilation cache.  JAX_COMPILATION_CACHE_DIR, when set,
# is JAX's own setting and is left alone; otherwise the cache lives at a
# fixed directory inside the checkout (git-ignored), so a second process
# on the same checkout finds what the first compiled.  Opt out with
# LIBSRCNN_TPU_NO_CACHE=1.
if not (_os.environ.get("LIBSRCNN_TPU_NO_CACHE")
        or _os.environ.get("JAX_COMPILATION_CACHE_DIR")):
    import jax as _jax

    if not _jax.config.jax_compilation_cache_dir:
        _jax.config.update(
            "jax_compilation_cache_dir",
            str(_pathlib.Path(__file__).resolve().parent.parent
                / ".jax_cache"))

from .config import DEFAULT_CONFIG, FilterType, SRCNNConfig
from .api import configure_filter_srcnn, process_srcnn, upscale
from .chunked import upscale_chunked

#: mirrors the reference's version constant era (`libsrcnn.h:34-35`) --
#: behavior parity target is libsrcnn 0.1.10.40.
__version__ = "0.1.0"
REFERENCE_PARITY_VERSION = "0.1.10.40"
SRCNN_VERSION = 0x00010A28  # the reference's numeric macro (`libsrcnn.h:35`)

__all__ = [
    "DEFAULT_CONFIG",
    "FilterType",
    "SRCNNConfig",
    "configure_filter_srcnn",
    "process_srcnn",
    "upscale",
    "upscale_chunked",
    "__version__",
]
