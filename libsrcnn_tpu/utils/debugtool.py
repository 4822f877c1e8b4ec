"""Debug dumps of intermediate float planes as PNGs.

Equivalent of the reference's DEBUG-only `saveImgF32`/`saveImgYCbCr`
(`debugtool.cpp:117-185`): max-normalize a float plane to u8 and write a
grayscale PNG.  The reference's min-detection is broken (`fMin` seeded with
FLT_MIN, `debugtool.cpp:82-95`) so it effectively normalizes by max only --
we implement the sane max-normalization it actually performs.

Hooked from the pipeline via :func:`dump_planes` when
``LIBSRCNN_TPU_DEBUG_DIR`` is set (the analog of the reference's
``-DDEBUG`` dump sites, `libsrcnn.cpp:731-743,800-850`).
"""

from __future__ import annotations

import os

import numpy as np


def normalize_to_u8(plane: np.ndarray) -> np.ndarray:
    """Max-normalize to [0,255] u8 as `debugtool.cpp:96-112` does."""
    plane = np.asarray(plane, dtype=np.float32)
    fmax = float(plane.max()) if plane.size else 0.0
    if fmax <= 0.0:
        return np.zeros(plane.shape, dtype=np.uint8)
    return (plane / fmax * 255.0).astype(np.uint8)


def save_plane(plane: np.ndarray, path: str) -> None:
    from ..io.imagefile import save_png

    save_png(path, normalize_to_u8(plane))


def debug_dir() -> str | None:
    return os.environ.get("LIBSRCNN_TPU_DEBUG_DIR") or None


def dump_planes(named_planes: dict[str, np.ndarray], prefix: str = "") -> list[str]:
    """Write each named float plane to the debug dir (if configured).

    Mirrors the reference's per-stage dumps: resized_Y/Cb/Cr/A, the 64
    conv1 maps, 32 conv2 maps, and conv3 (`libsrcnn.cpp:731-850`).
    """
    d = debug_dir()
    if d is None:
        return []
    os.makedirs(d, exist_ok=True)
    written = []
    for name, plane in named_planes.items():
        path = os.path.join(d, f"{prefix}{name}.png")
        save_plane(np.asarray(plane), path)
        written.append(path)
    return written
