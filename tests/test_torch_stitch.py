"""The port's hann_stitch (kernels/stitch.py) against the JAX package's
Pallas kernel (pallas/stitch.py, run in interpret mode as its own tests
run it) and a direct numpy blend. Tolerances are the JAX test's own
(tests/test_pallas.py: rtol 1e-5, atol 1e-6). The CUDA kernel against the
plain version is in tests/test_torch_cuda.py, which runs on the card."""

import numpy as np
import pytest
import torch

from satellite_computervision_tpu.pallas import stitch as jax_stitch
from satellite_computervision_tpu_torch.kernels import stitch


def _naive_blend(weighted, kernel, rows, cols, side):
    """Place each weighted chip at (r*k, c*k), accumulate, divide by the
    weight sum (the JAX package's normalizer)."""
    c_out = weighted.shape[-1]
    canvas = np.zeros(((rows + 1) * kernel, (cols + 1) * kernel, c_out), np.float32)
    for r in range(rows):
        for c in range(cols):
            canvas[r * kernel : r * kernel + side,
                   c * kernel : c * kernel + side] += weighted[r * cols + c]
    return canvas * jax_stitch.hann_inverse_weights(rows, cols, kernel, side)[..., None]


@pytest.mark.parametrize("side", [8, 24, 48, 640])
def test_hann_window_bit_equal(side):
    np.testing.assert_array_equal(stitch.hann_window_1d(side),
                                  jax_stitch.hann_window_1d(side))


@pytest.mark.parametrize("rows,cols,kernel,side", [(3, 4, 16, 24), (4, 4, 512, 640),
                                                   (1, 2, 16, 32)])
def test_hann_inverse_weights_bit_equal(rows, cols, kernel, side):
    got = stitch.hann_inverse_weights(rows, cols, kernel, side)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jax_stitch.hann_inverse_weights(rows, cols, kernel, side))


@pytest.mark.parametrize("buf", [8, 16], ids=["side_lt_2k", "side_eq_2k"])
def test_hann_stitch_reference_matches_jax(rng, buf):
    k, rows, cols, c_out = 16, 3, 4, 2
    side = k + buf
    weighted = rng.normal(size=(rows * cols, side, side, c_out)).astype(np.float32)
    got = stitch.hann_stitch_reference(torch.from_numpy(weighted), k, rows, cols).numpy()
    want = np.asarray(jax_stitch.hann_stitch(weighted, k, rows, cols, interpret=True))
    assert got.shape == want.shape == ((rows + 1) * k, (cols + 1) * k, c_out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _naive_blend(weighted, k, rows, cols, side),
                               rtol=1e-5, atol=1e-6)


def test_hann_stitch_cpu_runs_plain_version(rng):
    """On a CPU tensor the wrapper is the plain version and launches
    nothing."""
    k, rows, cols = 16, 2, 3
    weighted = torch.from_numpy(
        rng.normal(size=(rows * cols, 24, 24, 1)).astype(np.float32))
    before = stitch.hann_stitch.launches
    got = stitch.hann_stitch(weighted, k, rows, cols)
    assert stitch.hann_stitch.launches == before
    torch.testing.assert_close(got, stitch.hann_stitch_reference(weighted, k, rows, cols),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,kernel,rows,cols", [
    ((12, 40, 40, 1), 16, 3, 4),   # side > 2k
    ((11, 24, 24, 1), 16, 3, 4),   # n != rows*cols
    ((12, 24, 20, 1), 16, 3, 4),   # not square
])
def test_hann_stitch_rejects_bad_shapes(shape, kernel, rows, cols):
    with pytest.raises(ValueError):
        stitch.hann_stitch(torch.zeros(shape), kernel, rows, cols)


@pytest.mark.parametrize("side", [24, 32, 640])
def test_hann_window_2d_is_the_jax_engine_window(side):
    """The window the kernel applies is the JAX engine's chip weight, bit for
    bit (inference/tiles.py::_hann_window there)."""
    from satellite_computervision_tpu.inference.tiles import _hann_window

    np.testing.assert_array_equal(stitch.hann_window_2d(side, "cpu").numpy(),
                                  np.asarray(_hann_window(side)))


@pytest.mark.parametrize("k,buf,rows,cols,c_out", [
    (16, 8, 3, 4, 2),   # side < 2k
    (16, 16, 2, 3, 1),  # side == 2k
    (15, 6, 1, 1, 1),   # one chip, k*C not a multiple of 4
    (15, 6, 2, 3, 1),   # a grid, k*C not a multiple of 4 (the card's scalar path)
    (16, 8, 1, 1, 3),   # one chip, C = 3: k*C a multiple of 4, side*C not
])
def test_apply_window_equals_weighting_first(rng, k, buf, rows, cols, c_out):
    """``apply_window=True`` on raw predictions is the engine's old two-step
    route (multiply by the window, then stitch) bit for bit, on the plain
    version and through the wrapper; and it matches the JAX package's
    weighting + Pallas stitch at the JAX test's tolerance."""
    side = k + buf
    preds = rng.uniform(size=(rows * cols, side, side, c_out)).astype(np.float32)
    p = torch.from_numpy(preds)
    weighted = p * stitch.hann_window_2d(side, "cpu")[..., None]
    want = stitch.hann_stitch_reference(weighted, k, rows, cols)
    for got in (stitch.hann_stitch_reference(p, k, rows, cols, apply_window=True),
                stitch.hann_stitch(p, k, rows, cols, apply_window=True)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    jax_weighted = preds * (jax_stitch.hann_window_1d(side)[:, None]
                            * jax_stitch.hann_window_1d(side)[None, :])[..., None]
    jax_out = np.asarray(jax_stitch.hann_stitch(jax_weighted, k, rows, cols, interpret=True))
    np.testing.assert_allclose(want.numpy(), jax_out, rtol=1e-5, atol=1e-6)
