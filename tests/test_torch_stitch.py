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
