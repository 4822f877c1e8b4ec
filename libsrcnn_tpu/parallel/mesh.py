"""Device mesh construction helpers."""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axes: dict[str, int], devices=None) -> Mesh:
    """Build a mesh with named axes, e.g. ``make_mesh({"data": 2, "row": 4})``.

    The axis-size product must equal the device count used.
    """
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(list(axes.values())))
    if n != len(devices):
        raise ValueError(f"mesh {axes} needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices).reshape(tuple(axes.values()))
    return Mesh(arr, tuple(axes.keys()))


def default_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A sensible ``(data, row, col)`` mesh for n devices: spatial axes get
    the largest power-of-two split, the remainder goes to data
    parallelism.  The split follows the algorithm only: every card of a
    host reaches every other at the same rate."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    # split n = data * row * col with row/col as close as possible
    row = 2 ** int(math.log2(n) // 2) if n > 1 else 1
    col = 1
    rem = n // row
    if rem % 2 == 0 and rem > 1:
        col = 2
    data = n // (row * col)
    return make_mesh({"data": data, "row": row, "col": col}, devices)
