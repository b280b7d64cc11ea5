"""The port's ops (ops/augment.py, normalize.py, classes.py) against the JAX
package's, on the same numpy inputs and injected draws. Tolerance rtol
1e-5 / atol 1e-6: the same float32 arithmetic, reduced in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.ops import augment as jaug
from satellite_computervision_tpu.ops import classes as jcls
from satellite_computervision_tpu.ops import normalize as jnorm
from satellite_computervision_tpu_torch.ops import augment, classes, normalize

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nan_aware", [False, True])
@pytest.mark.parametrize("per_channel", [True, False])
def test_aug_color_matches_jax(rng, per_channel, nan_aware):
    img = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    if nan_aware:
        img[0, 1, 2, 0] = np.nan
    key = jax.random.key(3)
    want = jaug.aug_color(key, img, per_channel=per_channel, nan_aware=nan_aware)
    # the JAX function's own draws, injected
    ckey, bkey = jax.random.split(key)
    shape = (3,) if per_channel else ()
    contra = jax.random.uniform(ckey, shape, minval=0.95, maxval=1.05)
    bright = jax.random.uniform(bkey, shape, minval=0.95, maxval=1.05)
    got = augment.aug_color(_t(img), _t(contra), _t(bright), nan_aware=nan_aware)
    _close(got, want)


def _color_draws(key, n_ch):
    ckey, bkey = jax.random.split(key)
    return (jax.random.uniform(ckey, (n_ch,), minval=0.95, maxval=1.05),
            jax.random.uniform(bkey, (n_ch,), minval=0.95, maxval=1.05))


def test_aug_color_per_chip_draws_on_a_batch(rng):
    """(B, 1, 1, C) multipliers recolor each chip with its own draws, as
    the JAX pipeline's vmap of aug_color over chip keys does."""
    imgs = rng.uniform(0, 1, (3, 8, 8, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.key(9), 3)
    want = jax.vmap(jaug.aug_color)(keys, imgs)
    contra, bright = jax.vmap(lambda k: _color_draws(k, 2))(keys)
    got = augment.aug_color(_t(imgs), _t(contra)[:, None, None], _t(bright)[:, None, None])
    _close(got, want)


def test_draw_color_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(1)
    contra, bright = augment.draw_color_params(gen, 5, contra_adj=0.2)
    assert contra.shape == bright.shape == (5,)
    assert 0.8 <= contra.min() and contra.max() <= 1.2
    assert 0.95 <= bright.min() and bright.max() <= 1.05
    contra, bright = augment.draw_color_params(gen, 5, per_channel=False)
    assert contra.shape == bright.shape == ()


@pytest.mark.parametrize("ndim", [3, 4])
def test_aug_morph_uses_draw_morph_params(rng, ndim):
    """aug_morph == apply_morph of draw_morph_params from the same seed, on
    (H, W, C) chips and (T, H, W, C) series; the draws cover all eight
    dihedral transforms."""
    img = torch.from_numpy(rng.normal(size=(2, 6, 6, 3)[4 - ndim:]).astype(np.float32))
    seen = set()
    for seed in range(40):
        out, params = augment.aug_morph(torch.Generator().manual_seed(seed), img,
                                        return_params=True)
        assert params == augment.draw_morph_params(torch.Generator().manual_seed(seed))
        want = jaug.apply_morph(img.numpy(), jnp.asarray(params[0]), jnp.asarray(params[1]),
                                jnp.asarray(params[2]))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        seen.add(params)
    assert len(seen) >= 12


AXES = [(2,), (0, 1), (0, 1, 2)]


@pytest.mark.parametrize("nan_aware", [False, True])
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_rescale_image_matches_jax(rng, axes, nan_aware):
    x = rng.uniform(-5, 50, (8, 8, 4)).astype(np.float32)
    if nan_aware:
        x[3, 3, 1] = np.nan
    _close(normalize.rescale_image(_t(x), axes, nan_aware=nan_aware),
           jnorm.rescale_image(x, axes, nan_aware=nan_aware))


def test_rescale_image_moments_and_splits(rng):
    x = rng.uniform(0, 50, (8, 8, 4)).astype(np.float32)
    moments = [(0.0, 50.0), (1.0, 40.0), (2.0, 30.0), (0.0, 10.0)]
    _close(normalize.rescale_image(_t(x), moments=moments),
           jnorm.rescale_image(x, moments=moments))
    for splits, m in [([1, 3], None), ([2, 2], moments), ([2, 2], [(0.0, 50.0)])]:
        _close(normalize.rescale_image(_t(x), (0, 1), moments=m, splits=splits),
               jnorm.rescale_image(x, (0, 1), moments=m, splits=splits))
    with pytest.raises(ValueError, match="must sum"):
        normalize.rescale_image(_t(x), splits=[1, 2])


@pytest.mark.parametrize("std_form", [False, True])
@pytest.mark.parametrize("nan_aware", [False, True])
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_normalize_image_matches_jax(rng, axes, nan_aware, std_form):
    x = rng.normal(3.0, 2.0, (8, 8, 4)).astype(np.float32)
    if nan_aware:
        x[0, 5, 2] = np.nan
    kw = dict(nan_aware=nan_aware, std_form=std_form)
    _close(normalize.normalize_image(_t(x), axes, **kw), jnorm.normalize_image(x, axes, **kw))


@pytest.mark.parametrize("std_form", [False, True])
def test_normalize_image_moments_and_splits(rng, std_form):
    x = rng.normal(3.0, 2.0, (8, 8, 5)).astype(np.float32)
    moments = [(3.0, 4.0), (2.0, 1.5), (1.0, 2.0)]
    kw = dict(std_form=std_form)
    _close(normalize.normalize_image(_t(x[..., :3]), moments=moments, **kw),
           jnorm.normalize_image(x[..., :3], moments=moments, **kw))
    for splits, m in [([1, 2], None), ([1, 2], moments), ([2, 1], [(3.0, 4.0)])]:
        # channels past sum(splits) pass through
        _close(normalize.normalize_image(_t(x), (0, 1), moments=m, splits=splits, **kw),
               jnorm.normalize_image(x, (0, 1), moments=m, splits=splits, **kw))


def test_normalize_timeseries_matches_jax(rng):
    x = rng.uniform(0, 12000, (3, 4, 4, 2)).astype(np.float32)
    x[0, 0, 0, 0] = np.nan
    _close(normalize.normalize_timeseries(_t(x)), jnorm.normalize_timeseries(x))


def test_one_hot_matches_jax(rng):
    labels = rng.integers(-1, 5, (4, 6)).astype(np.float32) + 0.3
    for axis in (-1, 0, 1):
        want = jcls.one_hot(labels, 4, axis=axis)
        got = classes.one_hot(_t(labels), 4, axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ints = rng.integers(0, 3, (5,))
    np.testing.assert_array_equal(classes.one_hot(_t(ints), 3).numpy(),
                                  np.asarray(jcls.one_hot(ints, 3)))


def test_merge_classes_matches_jax(rng):
    cond = rng.integers(0, 4, (6, 6)).astype(np.int32)
    other = rng.integers(10, 20, (6, 6)).astype(np.int32)
    trans = [(1, 2), (2, 3), (0, 7)]
    np.testing.assert_array_equal(classes.merge_classes(_t(cond), trans).numpy(),
                                  np.asarray(jcls.merge_classes(cond, trans)))
    np.testing.assert_array_equal(classes.merge_classes(_t(cond), trans, _t(other)).numpy(),
                                  np.asarray(jcls.merge_classes(cond, trans, other)))
