"""Training: fine-tune or re-train the SRCNN 9-1-5 stack on device meshes.

The reference has NO training -- its weights are compile-time constants
(SURVEY.md section 5, checkpoint/resume: none).  This framework makes the
model trainable end-to-end: MSE on Y-channel patch pairs synthesized with
the framework's own classical resampler (the SRCNN paper's setup), with
data/spatial/tensor-parallel sharding over a device mesh and orbax-style
npz checkpointing.
"""

from .data import make_patch_batch, synthesize_pair  # noqa: F401
from .trainer import Trainer, loss_fn, train_step  # noqa: F401
