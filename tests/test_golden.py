"""End-to-end regression vs the ACTUAL reference binary outputs.

Goldens are generated by tools/gen_goldens.py running the reference library
built from a reference checkout (SURVEY.md section 4: the reference binary
is the oracle).  Acceptance per BASELINE.json is SSIM >= 0.99; the
pipeline is within 1 u8 LSB everywhere, so we assert much tighter.
"""

import os

import numpy as np
import pytest

from libsrcnn_tpu import FilterType, SRCNNConfig, upscale
from libsrcnn_tpu.eval import psnr, ssim

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


@pytest.fixture(scope="module")
def goldens():
    if not os.path.exists(GOLDENS):
        pytest.skip("goldens.npz missing -- run tools/build_reference.sh && tools/gen_goldens.py")
    return np.load(GOLDENS)


def _cases(z):
    return [m.split(",") for m in z["meta"]]


def test_golden_cases_present(goldens):
    assert len(_cases(goldens)) >= 15


@pytest.mark.parametrize("idx", range(29))
def test_against_reference_binary(goldens, idx):
    cases = _cases(goldens)
    if idx >= len(cases):
        pytest.skip("fewer cases")
    key, name, mult, filt, step, _ms = cases[idx]
    img = goldens[f"in_{name}"]
    cfg = SRCNNConfig(filter=FilterType(int(filt)), step_scale=bool(int(step)))
    out, conv = upscale(img, float(mult), cfg, return_conv_map=True)
    gout = goldens[f"out_{key}"]
    gconv = goldens[f"conv_{key}"]

    assert out.shape == gout.shape
    assert conv.shape == gconv.shape
    d = np.abs(out.astype(int) - gout.astype(int))
    assert d.max() <= 1, f"{key}: max u8 diff {d.max()}"
    assert (d > 0).mean() < 0.02, f"{key}: {100*(d>0).mean():.2f}% pixels differ"
    s = ssim(out, gout)
    assert s >= 0.999, f"{key}: ssim {s}"
    assert psnr(out, gout) >= 60.0
    assert np.abs(conv.astype(int) - gconv.astype(int)).max() <= 1


# --- the reference's own shipped golden PNGs (`README.md:38-53`) ----------

def test_shipped_butterfly_srcnn_png():
    """Our x2 bicubic SRCNN output matches the PNG the reference SHIPS
    (`Pictures/butterfly_srcnn.png` of a reference checkout named by
    LIBSRCNN_REFERENCE_DIR) within 1 u8 LSB -- the de-facto regression
    golden the reference repo itself publishes."""
    pics = os.path.join(os.environ.get("LIBSRCNN_REFERENCE_DIR", ""),
                        "Pictures")
    if not os.path.exists(os.path.join(pics, "butterfly_srcnn.png")):
        pytest.skip("needs the reference's output PNGs, which are not in "
                    "this repository: set LIBSRCNN_REFERENCE_DIR to a "
                    "reference checkout")
    from PIL import Image

    img = np.asarray(Image.open(
        os.path.join(pics, "butterfly.png")).convert("RGB"))
    ref = np.asarray(Image.open(
        os.path.join(pics, "butterfly_srcnn.png")).convert("RGB"))
    out, conv = upscale(img, 2.0, SRCNNConfig(filter=FilterType.BICUBIC),
                        return_conv_map=True)
    assert out.shape == ref.shape
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1, f"max u8 diff {d.max()}"
    assert ssim(out, ref) >= 0.999

    refconv = np.asarray(Image.open(
        os.path.join(pics, "butterfly_srcnn_convolution.png")).convert("L"))
    dc = np.abs(conv.astype(int) - refconv.astype(int))
    assert dc.max() <= 1, f"conv map max u8 diff {dc.max()}"
