#!/usr/bin/env python3
"""Extract the SRCNN 9-1-5 pre-trained parameters from the reference header.

The reference bakes 8,129 floats into ``/root/reference/src/convdata.h``
(`convdata.h:19,32,677,686,979,982`): conv1 64x9x9 + bias[64], conv2 32x64
(1x1) + bias[32], conv3 32x5x5 + scalar bias.  This tool parses the numeric
literals (pure data, no code) and re-packs them as HWIO tensors in an ``.npz``
so the JAX framework loads them at runtime instead of compile time.

Orientation notes (critical for bit-parity, see SURVEY.md section 2.6):

* conv1: reference applies ``kernel[x][y] * src[row+x][col+y]``
  (`libsrcnn.cpp:402-408`), i.e. index 0 is the row (dy) offset -> HWIO is
  ``w1[dy, dx, 0, f] = raw[f, dy, dx]``.
* conv2: plain 1x1, ``w2[0, 0, i, o] = raw[o, i]`` (`libsrcnn.cpp:433-437`).
* conv3: reference applies ``kernel[i][x][y] * src[row+y][col+x]``
  (`libsrcnn.cpp:506-512`) -- the 5x5 is stored spatially TRANSPOSED relative
  to conv1, so ``w3[dy, dx, i, 0] = raw[i, dx, dy]``.

All convolutions are cross-correlations (no kernel flip), matching
``lax.conv_general_dilated`` semantics.
"""

import re
import sys

import numpy as np

REF = "/root/reference/src/convdata.h"
OUT = "libsrcnn_tpu/models/weights/srcnn_915.npz"

FLOAT_RE = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _grab(text: str, decl: str, count: int) -> np.ndarray:
    """Extract `count` float literals following the declaration `decl`."""
    start = text.index(decl)
    eq = text.index("=", start)
    end = text.index(";", eq)
    body = text[eq + 1 : end]
    # strip // comments and the 'f' suffixes
    body = re.sub(r"//[^\n]*", "", body)
    vals = [float(m.group(0)) for m in FLOAT_RE.finditer(body)]
    if len(vals) != count:
        raise ValueError(f"{decl}: expected {count} floats, got {len(vals)}")
    return np.asarray(vals, dtype=np.float32)


def main() -> None:
    text = open(REF).read()

    b1 = _grab(text, "biases_conv1", 64)
    w1_raw = _grab(text, "weights_conv1_data", 64 * 9 * 9).reshape(64, 9, 9)
    b2 = _grab(text, "biases_conv2", 32)
    w2_raw = _grab(text, "weights_conv2_data", 32 * 64).reshape(32, 64)
    b3 = _grab(text, "biases_conv3", 1)
    w3_raw = _grab(text, "weights_conv3_data", 32 * 5 * 5).reshape(32, 5, 5)

    # Re-pack to HWIO with the orientation fixes documented above.
    w1 = np.transpose(w1_raw, (1, 2, 0))[:, :, None, :]          # (9,9,1,64)
    w2 = np.transpose(w2_raw, (1, 0))[None, None, :, :]          # (1,1,64,32)
    w3 = np.transpose(w3_raw, (2, 1, 0))[:, :, :, None]          # (5,5,32,1)
    # w3[dy,dx,i,0] = raw[i,dx,dy]: transpose (i,dx,dy)->(dy,dx,i)

    np.savez(
        OUT,
        w1=w1, b1=b1,
        w2=w2, b2=b2,
        w3=w3, b3=b3,
        version=np.asarray([0, 1, 10, 40], dtype=np.int32),
    )
    total = sum(a.size for a in (w1, b1, w2, b2, w3, b3))
    print(f"wrote {OUT}: {total} params")
    assert total == 8129, total


if __name__ == "__main__":
    sys.exit(main())
