"""io/imagefile, utils/tick, utils/debugtool."""

import os
import time

import numpy as np
import pytest

from libsrcnn_tpu.io import imagefile
from libsrcnn_tpu.utils import debugtool, tick


def test_magic_sniffing(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    for ext, fmt in [("png", "PNG"), ("jpg", "JPEG"), ("bmp", "BMP")]:
        p = str(tmp_path / f"x.{ext}")
        from PIL import Image

        Image.fromarray(img).save(p)
        assert imagefile.sniff_format(p) == fmt


def test_unknown_format_rejected(tmp_path):
    p = str(tmp_path / "x.dat")
    with open(p, "wb") as f:
        f.write(b"GARBAGE!")
    assert imagefile.sniff_format(p) is None
    with pytest.raises(ValueError):
        imagefile.load_image(p)


def test_roundtrip_rgba(tmp_path):
    rgba = np.random.default_rng(0).integers(0, 256, (6, 5, 4), np.uint8)
    p = str(tmp_path / "a.png")
    imagefile.save_png(p, rgba)
    back = imagefile.load_image(p)
    np.testing.assert_array_equal(back, rgba)


def test_gray_promoted_to_rgb(tmp_path):
    from PIL import Image

    g = np.random.default_rng(1).integers(0, 256, (7, 7), np.uint8)
    p = str(tmp_path / "g.png")
    Image.fromarray(g, mode="L").save(p)
    img = imagefile.load_image(p)
    assert img.shape == (7, 7, 3)
    np.testing.assert_array_equal(img[..., 0], g)


def test_tick_monotonic():
    a = tick.get_tick_count()
    time.sleep(0.012)
    b = tick.get_tick_count()
    assert b - a >= 10


def test_debug_normalize():
    p = np.array([[0.0, 50.0], [100.0, 200.0]], np.float32)
    u = debugtool.normalize_to_u8(p)
    assert u.dtype == np.uint8 and u.max() == 255
    np.testing.assert_array_equal(u, (p / 200.0 * 255).astype(np.uint8))
    assert debugtool.normalize_to_u8(np.zeros((2, 2))).max() == 0


def test_dump_planes(tmp_path, monkeypatch):
    monkeypatch.setenv("LIBSRCNN_TPU_DEBUG_DIR", str(tmp_path))
    written = debugtool.dump_planes({"conv3": np.ones((4, 4), np.float32)})
    assert len(written) == 1 and os.path.exists(written[0])
    monkeypatch.delenv("LIBSRCNN_TPU_DEBUG_DIR")
    assert debugtool.dump_planes({"x": np.ones((2, 2))}) == []


def test_load_image_paletted_transparency(tmp_path):
    """Paletted PNGs carry alpha in a tRNS chunk: must load as RGBA."""
    from PIL import Image

    from libsrcnn_tpu.io import load_image

    rgba = np.zeros((8, 8, 4), np.uint8)
    rgba[..., 0] = 200
    rgba[..., 3] = 255
    rgba[:4, :, 3] = 0  # top half transparent
    p = str(tmp_path / "pal.png")
    Image.fromarray(rgba).convert("P").save(p)  # keeps transparency info
    got = load_image(p)
    assert got.shape[-1] == 4, got.shape
    assert (got[:4, :, 3] == 0).all() and (got[4:, :, 3] == 255).all()


def test_distributed_initialize_noops_on_plain_host(monkeypatch):
    """initialize() with all defaults on a non-pod host must no-op, not
    raise out of jax.distributed auto-detection."""
    import os

    from libsrcnn_tpu.parallel import distributed

    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()  # must not raise
