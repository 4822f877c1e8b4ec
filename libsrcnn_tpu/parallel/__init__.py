"""Multi-device execution: device meshes, GSPMD sharding, explicit halo
exchange.

The reference's only parallelism is 15 OpenMP pragmas over pixels/filters
(SURVEY.md section 2.9).  The JAX equivalents:

* batch/data parallelism -- frames sharded over a ``data`` mesh axis
  (:mod:`.sharding`),
* spatial/context parallelism -- one large frame sharded over ``row``/``col``
  axes with replicate-pad halos exchanged between neighbors
  (:mod:`.halo` does this explicitly with ``shard_map`` + ``ppermute``;
  :mod:`.sharding` lets XLA GSPMD insert the halo collectives),
* channel/tensor parallelism -- conv filter dimensions sharded in training
  (:mod:`libsrcnn_tpu.train`),
* pipeline-stage parallelism -- the conv stack split across a ``stage``
  axis, frames streaming through via ``ppermute`` (:mod:`.stages`).
"""

from .mesh import default_mesh, make_mesh  # noqa: F401
from .stages import upscale_pipelined  # noqa: F401
from .tiled import upscale_tiled  # noqa: F401
