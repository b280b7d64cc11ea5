"""The port's SiameseChipDataset (data/chip_generators.py) against the JAX
package's on ``testing.make_siamese_chip_tree`` trees (centre-trimmed
from 36² to 32², one chip stored HWC). Without augmentation
(``to_fit=False``) the batches are equal exactly; with it, the JAX
dataset's colour and morph draws are injected into the port's and the
batches agree within 1e-6 (the channel means summed in another order;
inputs in [0, 1]); the shuffle order and the NaN fills come from the
shared numpy seed and match exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu import testing as fx
from satellite_computervision_tpu.data.chip_generators import (
    SiameseChipDataset as JaxSiameseChipDataset,
)
from satellite_computervision_tpu.ops.augment import draw_morph_params as jax_draw_morph
from satellite_computervision_tpu_torch.data import chip_generators
from satellite_computervision_tpu_torch.data.chip_generators import SiameseChipDataset

N_CHIPS, DIM, BATCH, SEED = 6, 36, 2, 5
UNET_DIM = (32, 32)


def _tree(root, nan_chip=False):
    tree = fx.make_siamese_chip_tree(str(root), n_chips=N_CHIPS, dim=DIM, seed=1)
    # one chip stored HWC: _to_chw moves its channels to the front
    hwc = np.load(tree["before"][1])
    np.save(tree["before"][1], np.moveaxis(hwc, 0, -1))
    if nan_chip:
        bad = np.load(tree["after"][2])
        bad[0, 5:9, 5:9] = np.nan
        bad[:, 20:22, 10:30] = -20000.0  # below -1 after the divide
        np.save(tree["after"][2], bad)
    return tree


def _datasets(tree, **kw):
    args = (tree["before"], tree["after"], tree["label"])
    kw = dict(batch_size=BATCH, unet_dim=UNET_DIM, seed=SEED, **kw)
    return JaxSiameseChipDataset(*args, **kw), SiameseChipDataset(*args, **kw)


def _jax_draws(n_batches, n_ch):
    """The JAX dataset's key chain: per batch, one colour key per side
    (``aug_color`` splits it into contrast and brightness keys) and one
    morph key."""
    key = jax.random.key(SEED)
    colors, morphs = [], []
    for _ in range(n_batches):
        for _side in range(2):
            key, sub = jax.random.split(key)
            ckey, bkey = jax.random.split(sub)
            colors.append(tuple(
                torch.from_numpy(np.array(jax.random.uniform(
                    k, (n_ch,), minval=1.0 - 0.05, maxval=1.0 + 0.05, dtype=jnp.float32)))
                for k in (ckey, bkey)))
        key, sub = jax.random.split(key)
        morphs.append(tuple(int(p) for p in jax_draw_morph(sub)))
    return colors, morphs


@pytest.mark.parametrize("add_nan_mask", [False, True], ids=["plain", "nan-mask"])
def test_predict_batches_equal_jax_exactly(tmp_path, add_nan_mask):
    tree = _tree(tmp_path, nan_chip=add_nan_mask)
    jds, ds = _datasets(tree, add_nan_mask=add_nan_mask, to_fit=False)
    assert len(ds) == len(jds) == N_CHIPS // BATCH
    np.testing.assert_array_equal(ds.indexes, jds.indexes)
    for _epoch in range(2):  # the reshuffle at each epoch's end
        for got, want in zip(list(ds), list(jds)):  # both epochs end
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.shape == (BATCH, *UNET_DIM, 4) and g.dtype == np.float32
                np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(ds.indexes, jds.indexes)


@pytest.mark.parametrize("add_nan_mask", [False, True], ids=["plain", "nan-mask"])
def test_fit_batches_match_jax_with_injected_draws(tmp_path, monkeypatch, add_nan_mask):
    tree = _tree(tmp_path, nan_chip=add_nan_mask)
    jds, ds = _datasets(tree, add_nan_mask=add_nan_mask, to_fit=True)
    n_batches = 2 * len(ds)
    colors, morphs = _jax_draws(n_batches, 4)
    calls = {"color": 0, "morph": 0}

    def color(gen, n_ch):
        assert gen is ds._gen and n_ch == 4
        calls["color"] += 1
        return colors.pop(0)

    def morph(gen):
        assert gen is ds._gen
        calls["morph"] += 1
        return morphs.pop(0)

    monkeypatch.setattr(chip_generators, "draw_color_params", color)
    monkeypatch.setattr(chip_generators, "draw_morph_params", morph)
    for _epoch in range(2):
        for (got_x, got_y), (want_x, want_y) in zip(list(ds), list(jds)):
            for g, w in zip(got_x, want_x):
                assert g.shape == (BATCH, *UNET_DIM, 4)
                np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
            assert got_y.shape == (BATCH, *UNET_DIM, 1)
            np.testing.assert_array_equal(got_y, np.asarray(want_y))
            assert set(np.unique(got_y)) <= {0.0, 1.0}
    assert calls == {"color": 2 * n_batches, "morph": n_batches}
    assert not colors and not morphs


def test_fit_draws_come_from_the_generator(tmp_path):
    """Without injection the colour and morph draws are the dataset's own
    torch.Generator's: the same seed gives the same batches."""
    tree = _tree(tmp_path)
    a = SiameseChipDataset(tree["before"], tree["after"], tree["label"], batch_size=BATCH,
                           unet_dim=UNET_DIM, seed=3)
    b = SiameseChipDataset(tree["before"], tree["after"], tree["label"], batch_size=BATCH,
                           unet_dim=UNET_DIM, seed=3)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa[0], xb[0])
        np.testing.assert_array_equal(xa[1], xb[1])
        np.testing.assert_array_equal(ya, yb)


def test_nan_without_mask_raises_as_jax_does(tmp_path):
    tree = _tree(tmp_path, nan_chip=True)
    jds, ds = _datasets(tree, add_nan_mask=False, to_fit=False, shuffle=False)
    # batch 1 holds chip 2, whose after side carries the NaNs
    with pytest.raises(ValueError, match="enable add_nan_mask"):
        jds[1]
    with pytest.raises(ValueError, match="enable add_nan_mask"):
        ds[1]
    ds[0]  # the other batches are clean
