"""Sharded SRCNN training step and a minimal trainer loop.

Parallelism (all via GSPMD annotations on one jitted step):

* **dp** -- batch sharded over the ``data`` mesh axis; XLA all-reduces
  gradients across the devices.
* **sp** -- patch height sharded over ``row`` (spatial parallelism; XLA
  inserts conv halo exchange), useful when training on large tiles.
* **tp** -- conv1/conv2 filter dimensions sharded over ``col`` (tensor
  parallelism for the 64/32-channel dims), on meshes whose ``row`` axis
  is 1: XLA's SPMD partitioner computes a wrong forward pass when the
  patch rows are split over ``row`` and the filters over ``col`` at once
  (every row of the output is off; tests/test_train.py pins the case), so
  on such a mesh the filters stay replicated over ``col``.

The step is a pure (params, opt_state, batch) -> (params, opt_state, loss)
function; checkpointing is plain npz of the params pytree
(:func:`save_checkpoint` / :func:`load_checkpoint`).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import srcnn


def loss_fn(params: dict, lr_y: jnp.ndarray, hr_y: jnp.ndarray,
            forward=None) -> jnp.ndarray:
    """MSE on the Y channel in [0,255] domain, unclamped forward.

    ``forward(params, y, clamp=False)`` defaults to the 9-1-5 model; pass
    e.g. ``models.srcnn_generic.forward_y`` (via functools.partial with a
    ModelSpec) to train other family members."""
    if forward is None:
        forward = srcnn.forward_y
    pred = forward(params, lr_y, clamp=False)
    return jnp.mean((pred - hr_y) ** 2)


def param_shardings(mesh: Mesh, tp_axis: str = "col") -> dict:
    """Tensor-parallel shardings: conv1 output filters and conv2 input
    filters split over ``tp_axis``; everything else replicated."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return {
        "w1": ns(None, None, None, tp_axis),
        "b1": ns(tp_axis),
        "w2": ns(None, None, tp_axis, None),
        "b2": ns(None),
        "w3": ns(None, None, None, None),
        "b3": ns(None),
    }


@functools.partial(jax.jit, static_argnums=(3, 4, 5), donate_argnums=(0, 1))
def train_step(params, opt_state, batch, optimizer, mesh: Mesh | None = None,
               forward=None):
    """One SGD step.  ``batch`` is (lr_y, hr_y) [B, H, W] float32."""
    lr_y, hr_y = batch
    if mesh is not None:
        sh = NamedSharding(mesh, P("data", "row", None))
        lr_y = jax.lax.with_sharding_constraint(lr_y, sh)
        hr_y = jax.lax.with_sharding_constraint(hr_y, sh)

    loss, grads = jax.value_and_grad(loss_fn)(params, lr_y, hr_y, forward)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    if mesh is not None and forward is None and mesh.shape["row"] == 1:
        # tp shardings are 9-1-5 shaped, and not combined with sp (above)
        psh = param_shardings(mesh)
        params = jax.lax.with_sharding_constraint(params, psh)
    return params, opt_state, loss


def save_checkpoint(path: str, params: dict, step: int = 0) -> None:
    """npz checkpoint (the framework's portable format)."""
    np.savez(path, step=np.int64(step),
             **{k: np.asarray(v) for k, v in params.items()})


def load_checkpoint(path: str):
    """Inverse of save_checkpoint for ANY family's param dict (vdsr saves
    in_w/mid_w/..., not the 9-1-5 keys)."""
    z = np.load(path)
    params = {k: jnp.asarray(z[k]) for k in z.files if k != "step"}
    return params, int(z["step"])


def save_checkpoint_orbax(directory: str, params: dict, step: int = 0) -> None:
    """Orbax checkpoint (sharded/async-capable, for multi-host training).

    The reference has no checkpointing at all (weights are compile-time
    constants, SURVEY.md section 5); npz covers single-host use and orbax
    covers pod-scale training where each host writes its shards.
    """
    import orbax.checkpoint as ocp

    with ocp.CheckpointManager(directory) as mgr:
        mgr.save(step, args=ocp.args.StandardSave(params))
        mgr.wait_until_finished()


def load_checkpoint_orbax(directory: str, step: int | None = None):
    import orbax.checkpoint as ocp

    with ocp.CheckpointManager(directory) as mgr:
        step = mgr.latest_step() if step is None else step
        params = mgr.restore(step, args=ocp.args.StandardRestore())
    return {k: jnp.asarray(v) for k, v in params.items()}, int(step)


class Trainer:
    """Minimal training driver: optimizer + sharded step + checkpointing."""

    def __init__(self, params: dict | None = None, learning_rate: float = 1e-4,
                 mesh: Mesh | None = None, seed: int = 0, forward=None):
        self.params = params if params is not None else srcnn.init_params(
            jax.random.key(seed))
        self.optimizer = optax.adam(learning_rate)
        self.opt_state = self.optimizer.init(self.params)
        self.mesh = mesh
        self.forward = forward  # None -> the 9-1-5 model
        self.step = 0

    def fit(self, batches, log_every: int = 0) -> list[float]:
        """Run over an iterable of (lr_y, hr_y) numpy batches."""
        losses = []
        for lr_y, hr_y in batches:
            batch = (jnp.asarray(lr_y), jnp.asarray(hr_y))
            if self.mesh is not None:
                sh = NamedSharding(self.mesh, P("data", "row", None))
                batch = tuple(jax.device_put(b, sh) for b in batch)
            self.params, self.opt_state, loss = train_step(
                self.params, self.opt_state, batch, self.optimizer, self.mesh,
                self.forward)
            self.step += 1
            losses.append(float(loss))
            if log_every and self.step % log_every == 0:
                print(f"step {self.step}: loss {losses[-1]:.4f}")
        return losses
