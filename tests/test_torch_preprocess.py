"""The port's fused_preprocess (kernels/preprocess.py; on the CPU its plain
version runs) against the JAX package's Pallas kernel in interpret mode,
with the JAX draws injected (torch's and JAX's random numbers never
match). Tolerance rtol 1e-4 / atol 1e-5, as tests/test_pallas.py holds the
Pallas kernel to the op chain: the same math, the mean summed in another
order. The morphs are data movement and must match exactly. The CUDA
kernel's algebra (fused_preprocess_stats_reference) is held against the
plain version here; the kernel itself in tests/test_torch_cuda.py."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from satellite_computervision_tpu.ops.augment import apply_morph as jax_apply_morph
from satellite_computervision_tpu.pallas import fused_preprocess as jax_fused_preprocess
from satellite_computervision_tpu.pallas.preprocess import (
    draw_augment_params as jax_draw_augment_params,
)
from satellite_computervision_tpu_torch.kernels.preprocess import (
    draw_augment_params,
    fused_preprocess,
    fused_preprocess_reference,
    fused_preprocess_stats_reference,
    recolored_extrema,
)
from satellite_computervision_tpu_torch.ops.augment import apply_morph

TOL = dict(rtol=1e-4, atol=1e-5)
B, K, C = 3, 16, 4


def _jax_draws(key, channels):
    contra, bright, morph = jax_draw_augment_params(key, B, channels)
    return tuple(torch.from_numpy(np.array(a)) for a in (contra, bright, morph))


@pytest.mark.parametrize("augment", [True, False], ids=["augment", "eval"])
@pytest.mark.parametrize("n_color", [C, C - 1, 0])
def test_fused_preprocess_matches_jax_interpret(rng, n_color, augment):
    chips = rng.uniform(0.0, 3000.0, (B, K, K, C)).astype(np.float32)
    if n_color < C:  # trailing label channel, as the pipeline stacks it
        chips[..., n_color:] = (rng.uniform(size=(B, K, K, C - n_color)) > 0.5)
    key = jax.random.key(5)
    want = np.asarray(jax_fused_preprocess(chips, key if augment else None, n_color=n_color,
                                           augment=augment, interpret=True))
    draws = _jax_draws(key, C) if augment else (None, None, None)
    got = fused_preprocess(torch.from_numpy(chips), n_color, *draws, augment=augment)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # label channels pass through (moved by the morph only)
    if not augment:
        np.testing.assert_array_equal(got.numpy()[..., n_color:], chips[..., n_color:])


@pytest.mark.parametrize("flip_v,flip_h,n_rot",
                         list(itertools.product([False, True], [False, True], range(4))))
def test_apply_morph_matches_jax_exactly(rng, flip_v, flip_h, n_rot):
    img = rng.normal(size=(6, 6, 3)).astype(np.float32)
    want = np.asarray(jax_apply_morph(img, jnp.asarray(flip_v), jnp.asarray(flip_h),
                                      jnp.asarray(n_rot)))
    got = apply_morph(torch.from_numpy(img), flip_v, flip_h, n_rot).numpy()
    np.testing.assert_array_equal(got, want)


def test_draws_have_the_jax_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    contra, bright, morph = draw_augment_params(gen, 64, 7, contra_adj=0.1)
    assert contra.shape == bright.shape == (64, 7) and morph.shape == (64, 3)
    assert contra.dtype == torch.float32 and morph.dtype == torch.int32
    assert 0.9 <= contra.min() and contra.max() <= 1.1
    assert 0.95 <= bright.min() and bright.max() <= 1.05
    assert set(morph[:, :2].unique().tolist()) == {0, 1}
    assert set(morph[:, 2].unique().tolist()) == {0, 1, 2, 3}
    again = draw_augment_params(torch.Generator().manual_seed(0), 64, 7, contra_adj=0.1)
    for a, b in zip((contra, bright, morph), again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_errors():
    square = torch.zeros((2, 8, 8, 3))
    with pytest.raises(ValueError, match="square"):
        fused_preprocess(torch.zeros((2, 8, 6, 3)), augment=False)
    with pytest.raises(ValueError, match="requires draws"):
        fused_preprocess(square)
    with pytest.raises(ValueError, match="requires draws"):
        fused_preprocess_reference(square, 3, torch.ones(2, 3), None, None)
    with pytest.raises(ValueError, match="morph"):
        fused_preprocess(square, 3, torch.ones(2, 3), torch.ones(2, 3),
                         torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="n_color"):
        fused_preprocess(square, 4, augment=False)


def _hard_batch(rng, n_color, contra_sign):
    """16 chips, one per morph, with a NaN plane, a +inf and a -inf pixel,
    and contra positive, negative, zero or of mixed sign per chip."""
    b, k, c = 16, 8, C
    chips = rng.uniform(0.0, 3000.0, (b, k, k, c)).astype(np.float32)
    chips[3, ..., 1] = np.nan
    chips[5, 2, 3, 0] = np.inf
    chips[6, 4, 4, 2] = -np.inf
    contra = rng.uniform(0.9, 1.1, (b, c)).astype(np.float32)
    if contra_sign == "negative":
        contra = -contra
    elif contra_sign == "zero":
        contra[:] = 0.0
    elif contra_sign == "mixed":
        contra[::2] *= -1.0
        contra[1::4] = 0.0
    bright = rng.uniform(0.9, 1.1, (b, c)).astype(np.float32)
    morph = np.array([(fv, fh, r) for fv in (0, 1) for fh in (0, 1) for r in range(4)],
                     np.int32)
    return (torch.from_numpy(chips), torch.from_numpy(contra), torch.from_numpy(bright),
            torch.from_numpy(morph))


@pytest.mark.parametrize("contra_sign", ["positive", "negative", "zero", "mixed"])
@pytest.mark.parametrize("n_color", [C, C - 1, 0])
def test_stats_reference_matches_reference(rng, n_color, contra_sign):
    """The kernel's algebra (raw sum/min/max, the recolored extrema through
    the sign of contra) against the plain version: with the plain version's
    own mean the extrema agree bit for bit; the outputs within 1e-6 (the
    mean summed in another order). NaN planes and infinities propagate
    alike; every morph."""
    chips, contra, bright, morph = _hard_batch(rng, n_color, contra_sign)
    want = fused_preprocess_reference(chips, n_color, contra, bright, morph)
    got = fused_preprocess_stats_reference(chips, n_color, contra, bright, morph)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6, equal_nan=True)

    col = chips[..., :n_color]
    mean = col.mean(dim=(1, 2), keepdim=True)
    ct = contra[:, None, None, :n_color]
    br = bright[:, None, None, :n_color]
    recolored = (col - mean) * ct + mean * br
    lo, hi = recolored_extrema(col.amin(dim=(1, 2), keepdim=True),
                               col.amax(dim=(1, 2), keepdim=True), mean, ct, br)
    torch.testing.assert_close(lo, recolored.amin(dim=(1, 2), keepdim=True),
                               rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(hi, recolored.amax(dim=(1, 2), keepdim=True),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("augment", [True, False], ids=["augment", "eval"])
@pytest.mark.parametrize("n_color", [C, C - 1, 0])
def test_stats_reference_matches_jax_interpret(rng, n_color, augment):
    """Both plain versions against the Pallas kernel in interpret mode, with
    the JAX draws injected."""
    chips = rng.uniform(0.0, 3000.0, (B, K, K, C)).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(jax_fused_preprocess(chips, key if augment else None, n_color=n_color,
                                           augment=augment, interpret=True))
    draws = _jax_draws(key, C) if augment else (None, None, None)
    for fn in (fused_preprocess_reference, fused_preprocess_stats_reference):
        got = fn(torch.from_numpy(chips), n_color, *draws, augment=augment)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
