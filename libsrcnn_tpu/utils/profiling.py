"""Profiling / tracing utilities.

The reference's only observability is a wall-clock ms print
(`test.cpp:653-672`; SURVEY.md section 5 lists tracing as absent).  This
framework provides:

* :func:`trace` -- context manager around ``jax.profiler`` producing a
  Perfetto/TensorBoard trace directory of device execution,
* :class:`StageTimer` -- per-stage wall timing that ends each stage in
  ``jax.block_until_ready``,
* :func:`flops_estimate` -- analytic FLOP count of one pipeline pass, for
  utilization math in benchmarks.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace: ``with trace('/tmp/tb'): run()``.  View with
    TensorBoard or Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(tree) -> None:
    """Wait until every jax array in ``tree`` is computed."""
    import jax

    jax.block_until_ready(tree)


class StageTimer:
    """Accumulate per-stage wall times across iterations.

    The with-block must hand its result to the yielded box (or pass it
    as ``result=``) -- that is what gets sync'd; without it only the
    async DISPATCH is timed:

    >>> t = StageTimer()
    >>> with t.stage("resize") as box:
    ...     box["out"] = resize(...)   # sync'd on exit
    >>> print(t.report())
    """

    def __init__(self):
        self.times: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            sync(box.get("out", result))
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.times.items():
            med = float(np.median(ts)) * 1000
            lines.append(f"{name:20s} {med:8.2f} ms (n={len(ts)})")
        return "\n".join(lines)


def flops_estimate(out_h: int, out_w: int) -> int:
    """FLOPs of one SRCNN pass at the given output size (convs only --
    resize/color are O(pixels) and negligible)."""
    per_pixel = 2 * (81 * 64 + 64 * 32 + 25 * 32)
    return out_h * out_w * per_pixel
