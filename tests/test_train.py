"""Training subsystem: data synthesis, sharded step, checkpointing."""

import os

import numpy as np
import pytest

import jax

from libsrcnn_tpu.config import FilterType
from libsrcnn_tpu.models import srcnn
from libsrcnn_tpu.parallel.mesh import make_mesh
from libsrcnn_tpu.train import Trainer, make_patch_batch, synthesize_pair
from libsrcnn_tpu.train.trainer import load_checkpoint, loss_fn, save_checkpoint


GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "goldens.npz")


def _butterfly_full():
    """The reference's 256x256 butterfly picture, as committed in the
    goldens archive."""
    return np.load(GOLDENS)["in_butterfly_full"]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    # smooth images (noise is unlearnable): random low-freq gradients
    out = []
    for _ in range(3):
        a, b = rng.uniform(0, 255, 2)
        g = np.linspace(a, b, 48)[:, None] + np.linspace(b, a, 48)[None, :]
        img = np.clip(g / 2, 0, 255).astype(np.uint8)
        out.append(np.stack([img] * 3, -1))
    return out


def test_synthesize_pair_shapes(images):
    lr, hr = synthesize_pair(images[0], 2.0)
    assert lr.shape == hr.shape == (48, 48)
    # downscale-upscale loses detail: pair differs but is correlated
    assert not np.array_equal(lr, hr)
    assert np.corrcoef(lr.ravel(), hr.ravel())[0, 1] > 0.9


def test_make_patch_batch(images):
    lr, hr = make_patch_batch(images, 8, patch=16, seed=1)
    assert lr.shape == hr.shape == (8, 16, 16)
    with pytest.raises(ValueError):
        make_patch_batch(images, 2, patch=64)


def test_pretrained_loss_beats_identity(images):
    """The pre-trained SRCNN should reconstruct better than the classical
    interpolation alone on a real photo crop."""
    hr = _butterfly_full()
    lr_y, hr_y = synthesize_pair(hr, 2.0)
    params = srcnn.load_params()
    import jax.numpy as jnp

    mse_srcnn = float(loss_fn(params, jnp.asarray(lr_y), jnp.asarray(hr_y)))
    mse_interp = float(np.mean((lr_y - hr_y) ** 2))
    assert mse_srcnn < mse_interp


def test_training_reduces_loss(images):
    tr = Trainer(learning_rate=1e-3, seed=0)
    batches = [make_patch_batch(images, 8, patch=16, seed=s) for s in range(20)]
    losses = tr.fit(batches)
    assert losses[-1] < losses[0] * 0.5, losses[::5]


def test_sharded_training_matches_unsharded(images):
    batches = [make_patch_batch(images, 8, patch=16, seed=s) for s in range(3)]
    tr_plain = Trainer(params=srcnn.load_params(), learning_rate=1e-5)
    tr_mesh = Trainer(params=srcnn.load_params(), learning_rate=1e-5,
                      mesh=make_mesh({"data": 2, "row": 2, "col": 2}))
    l_plain = tr_plain.fit(list(batches))
    l_mesh = tr_mesh.fit(list(batches))
    np.testing.assert_allclose(l_plain, l_mesh, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(tr_plain.params["w1"]),
                               np.asarray(tr_mesh.params["w1"]), atol=1e-5)


@pytest.mark.parametrize("axes", [{"data": 1, "row": 2, "col": 2},
                                  {"data": 1, "row": 1, "col": 4},
                                  {"data": 4, "row": 1, "col": 1}])
def test_sharded_step_matches_unsharded_large_patches(images, axes):
    """Regression: with the patch rows split over ``row`` and the filters
    over ``col`` at once, XLA's partitioner returned a loss ~70x too large
    at every patch size; the trainer keeps the filters replicated there."""
    batch = make_patch_batch(images, 16, patch=32, seed=0)
    one = Trainer(params=srcnn.load_params(), learning_rate=1e-5).fit(
        [batch, batch])
    n = int(np.prod(list(axes.values())))
    tr = Trainer(params=srcnn.load_params(), learning_rate=1e-5,
                 mesh=make_mesh(axes, jax.devices()[:n]))
    np.testing.assert_allclose(tr.fit([batch, batch]), one, rtol=1e-4)


def test_checkpoint_roundtrip(tmp_path, images):
    tr = Trainer(learning_rate=1e-4, seed=3)
    tr.fit([make_patch_batch(images, 4, patch=16)])
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, tr.params, tr.step)
    params, step = load_checkpoint(p)
    assert step == 1
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(tr.params[k]))


def test_orbax_checkpoint_roundtrip(tmp_path):
    from libsrcnn_tpu.train.trainer import (load_checkpoint_orbax,
                                            save_checkpoint_orbax)

    params = srcnn.load_params()
    save_checkpoint_orbax(str(tmp_path / "ck"), params, step=7)
    p2, step = load_checkpoint_orbax(str(tmp_path / "ck"))
    assert step == 7
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]), np.asarray(p2[k]))


def test_graft_entry():
    import __graft_entry__ as g

    fn, args = g.entry()
    out, conv = jax.jit(fn)(*args)
    assert out.shape == (256, 256, 3) and conv.shape == (256, 256)
    g.dryrun_multichip(8)


def test_generic_model_family(images):
    import functools

    import jax.numpy as jnp

    from libsrcnn_tpu.models import srcnn_generic as G

    spec = G.ModelSpec(f1=5, n1=16, f2=3, n2=8, f3=3)
    params = G.init_params(jax.random.key(4), spec)
    assert G.spec_of(params) == spec
    assert spec.param_count() == sum(int(np.prod(np.asarray(v).shape))
                                     for v in params.values())
    y = np.random.default_rng(40).uniform(0, 255, (20, 24)).astype(np.float32)
    out = np.asarray(G.forward_y(params, jnp.asarray(y)))
    assert out.shape == (20, 24) and out.min() >= 0 and out.max() <= 255

    # 9-1-5 through the generic forward == the specialized forward
    p915 = G.from_pretrained()
    np.testing.assert_allclose(
        np.asarray(G.forward_y(p915, jnp.asarray(y))),
        np.asarray(srcnn.forward_y(p915, jnp.asarray(y))), atol=1e-5)
    with pytest.raises(ValueError):
        G.from_pretrained(spec)

    # the variant trains through the shared Trainer
    fw = functools.partial(G.forward_y, spec=spec)
    tr = Trainer(params=params, learning_rate=1e-3, forward=fw)
    losses = tr.fit([make_patch_batch(images, 8, patch=16, seed=s)
                     for s in range(10)])
    assert losses[-1] < losses[0]


def test_checkpoint_roundtrip_any_family(tmp_path):
    """save/load_checkpoint must round-trip non-9-1-5 param dicts (vdsr
    trainers save in_w/mid_w/...)."""
    import jax

    from libsrcnn_tpu.models import vdsr
    from libsrcnn_tpu.train import trainer

    spec = vdsr.VDSRSpec(depth=4, ch=4)
    params = vdsr.init_params(jax.random.key(0), spec)
    path = str(tmp_path / "ck.npz")
    trainer.save_checkpoint(path, params, step=7)
    got, step = trainer.load_checkpoint(path)
    assert step == 7
    assert set(got) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(params[k]))
