"""Pure-numpy behavioral oracle for the reference pipeline.

Loop-level reimplementation of libsrcnn's default (golden) path with the
same precision choices as the C++ (float32 stages, double accumulation in
the resampler and conv3), used to validate the JAX implementation in unit
tests.  Written from the behavioral spec in SURVEY.md sections 2-3; in
addition, tests/goldens/ holds outputs generated by the actual reference
binary (see tools/gen_goldens.py) as the end-to-end ground truth.
"""

from __future__ import annotations

import numpy as np

from libsrcnn_tpu.config import FilterType, chroma_filter
from libsrcnn_tpu.ops.weights_table import contribution_table


# --- color (`libsrcnn.cpp:233-308`) ---------------------------------------

def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    f = img.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b
    cb = np.float32(128.0) - np.float32(0.1687) * r - np.float32(0.3313) * g + np.float32(0.5) * b
    cr = np.float32(128.0) + np.float32(0.5) * r - np.float32(0.4187) * g - np.float32(0.0813) * b
    planes = [y, cb, cr]
    if img.shape[-1] == 4:
        planes.append(f[..., 3])
    return np.stack(planes).astype(np.float32)


def ycbcr_to_rgb(planes: np.ndarray) -> np.ndarray:
    y = planes[0]
    cb = planes[1] - np.float32(128.0)
    cr = planes[2] - np.float32(128.0)
    r = y + np.float32(45.0) * cr / np.float32(32.0)
    g = y - (np.float32(11.0) * cb + np.float32(23.0) * cr) / np.float32(32.0)
    b = y + np.float32(113.0) * cb / np.float32(64.0)

    def tr(x):
        return np.floor(np.maximum(np.minimum(x, 255.0), 0.0)).astype(np.uint8)

    chans = [tr(r), tr(g), tr(b)]
    if planes.shape[0] == 4:
        chans.append(tr(planes[3]))
    return np.stack(chans, axis=-1)


# --- resize (`frawscale.cpp:162-385`), double accumulation ----------------

def _resize_axis0(plane: np.ndarray, dst: int, ft: FilterType) -> np.ndarray:
    src = plane.shape[0]
    left, w = contribution_table(ft, dst, src)
    out = np.zeros((dst, plane.shape[1]), dtype=np.float32)
    for u in range(dst):
        acc = np.zeros((plane.shape[1],), dtype=np.float64)
        for k in range(w.shape[1]):
            i = left[u] + k
            # The reference accumulates over [iLeft, iRight] which the
            # weights table keeps in-bounds (`frawscale.cpp:315-325`); our
            # window spans the full padded width, so entries past src-1
            # (zero-weight padding, `frawscale.cpp:85-108`) are skipped.
            if i >= src:
                continue
            acc += w[u, k] * plane[i].astype(np.float64)
        out[u] = acc.astype(np.float32)
    return out


def resize_plane(plane: np.ndarray, dst_h: int, dst_w: int, ft: FilterType) -> np.ndarray:
    src_h, src_w = plane.shape
    if dst_h == src_h and dst_w == src_w:
        return plane.copy()
    if dst_w <= src_w:
        out = _resize_axis0(plane.T, dst_w, ft).T  # horizontal first
        out = _resize_axis0(out, dst_h, ft)
    else:
        out = _resize_axis0(plane, dst_h, ft)      # vertical first
        out = _resize_axis0(out.T, dst_w, ft).T
    return out


# --- SRCNN conv stack (`libsrcnn.cpp:350-529`) -----------------------------

def edge_pad(p: np.ndarray, n: int) -> np.ndarray:
    return np.pad(p, n, mode="edge")


def conv99(y: np.ndarray, w1: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """w1: HWIO (9,9,1,64). float32 accumulation like the reference."""
    h, w = y.shape
    src = edge_pad(y, 4)
    out = np.zeros((64, h, w), dtype=np.float32)
    k = w1[:, :, 0, :]  # (9,9,64)
    for f in range(64):
        acc = np.zeros((h, w), dtype=np.float32)
        for dy in range(9):
            for dx in range(9):
                acc = acc + np.float32(k[dy, dx, f]) * src[dy : dy + h, dx : dx + w]
        out[f] = np.maximum(acc + b1[f], 0.0)
    return out


def conv11(c1: np.ndarray, w2: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """c1: (64,H,W); w2 HWIO (1,1,64,32)."""
    k = w2[0, 0]  # (64,32)
    out = np.einsum("ihw,io->ohw", c1.astype(np.float32), k.astype(np.float32))
    out = out + b2[:, None, None]
    return np.maximum(out, 0.0).astype(np.float32)


def conv55(c2: np.ndarray, w3: np.ndarray, b3: float) -> np.ndarray:
    """c2: (32,H,W); w3 HWIO (5,5,32,1).  Per-channel double accumulation,
    float32 cross-channel sum, then clamp (`libsrcnn.cpp:500-524`)."""
    _, h, w = c2.shape
    out = np.zeros((h, w), dtype=np.float32)
    k = w3[:, :, :, 0]  # (5,5,32)
    for i in range(32):
        src = edge_pad(c2[i], 2).astype(np.float64)
        accd = np.zeros((h, w), dtype=np.float64)
        for dy in range(5):
            for dx in range(5):
                accd += np.float64(k[dy, dx, i]) * src[dy : dy + h, dx : dx + w]
        out = out + accd.astype(np.float32)
    out = out + np.float32(b3)
    return np.clip(out, 0.0, 255.0).astype(np.float32)


def srcnn_y(y: np.ndarray, params: dict) -> np.ndarray:
    c1 = conv99(y, np.asarray(params["w1"]), np.asarray(params["b1"]))
    c2 = conv11(c1, np.asarray(params["w2"]), np.asarray(params["b2"]))
    return conv55(c2, np.asarray(params["w3"]), float(np.asarray(params["b3"])))


# --- full pass (`doSRCNN`, `libsrcnn.cpp:628-923`) -------------------------

def do_srcnn(img: np.ndarray, multiply: float, ft: FilterType = FilterType.BICUBIC,
             params: dict | None = None):
    if params is None:
        from libsrcnn_tpu.models.srcnn import _load_npz
        params = _load_npz()
    d = img.shape[-1]
    planes = rgb_to_ycbcr(img)
    rs_w = int(np.float32(img.shape[1]) * np.float32(multiply))
    rs_h = int(np.float32(img.shape[0]) * np.float32(multiply))
    cf = chroma_filter(ft)
    rz = [resize_plane(planes[0], rs_h, rs_w, ft)]
    rz += [resize_plane(planes[c], rs_h, rs_w, cf) for c in range(1, d)]
    y_sr = srcnn_y(rz[0], params)
    merged = np.stack([y_sr, *rz[1:]])
    out = ycbcr_to_rgb(merged)
    conv = np.floor(y_sr).astype(np.uint8)
    return out, conv
