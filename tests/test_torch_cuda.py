"""The port on the card: the hand-written CUDA kernels against their plain
PyTorch versions, and the engine on CUDA against the engine on the CPU.

These tests skip without a CUDA device. The file imports no JAX, so it
also runs on a GPU host that has none (the repository's conftest imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from satellite_computervision_tpu_torch.data.pipeline import make_preprocess_fn
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.kernels import preprocess, stitch
from satellite_computervision_tpu_torch.models import UNet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    # float32 results are compared: keep cuDNN/cuBLAS out of TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k,buf,rows,cols,c_out", [
    (16, 8, 3, 4, 2),     # side < 2k
    (16, 16, 3, 4, 2),    # side == 2k
    (512, 128, 4, 4, 1),  # the solar serving shape
])
def test_hann_stitch_kernel_matches_plain(cuda, k, buf, rows, cols, c_out):
    side = k + buf
    rng = np.random.default_rng(0)
    weighted = torch.from_numpy(
        rng.normal(size=(rows * cols, side, side, c_out)).astype(np.float32)).to(cuda)
    before = stitch.hann_stitch.launches
    got = stitch.hann_stitch(weighted, k, rows, cols)
    torch.cuda.synchronize()
    assert stitch.hann_stitch.launches == before + 1
    want = stitch.hann_stitch_reference(weighted, k, rows, cols)
    # same adds in the same order, IEEE division: equal up to 1e-6
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_hann_stitch_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((12, 24, 24, 1), device=cuda)
    with pytest.raises(ValueError):
        stitch.hann_stitch(x.double(), 16, 3, 4)
    with pytest.raises(ValueError):
        stitch.hann_stitch(x.transpose(1, 2), 16, 3, 4)


@pytest.mark.parametrize("augment", [True, False], ids=["augment", "eval"])
@pytest.mark.parametrize("b,k,c,n_color", [
    (3, 16, 4, 4),      # every channel recolored
    (3, 16, 4, 3),      # a trailing label channel
    (2, 9, 3, 0),       # nothing recolored: the morph only
    (1, 5, 300, 299),   # more channels than a block's 256 threads
    (64, 256, 7, 6),    # the training path: 6 bands + the label
])
def test_fused_preprocess_kernel_matches_plain(cuda, b, k, c, n_color, augment):
    gen = torch.Generator().manual_seed(b * k + c)
    bands = (torch.rand((b, k, k, c), generator=gen) * 3000.0).to(cuda)
    draws = preprocess.draw_augment_params(gen, b, max(n_color, 1)) if augment else (None,) * 3
    before = preprocess.fused_preprocess.launches
    got = preprocess.fused_preprocess(bands, n_color, *draws, augment=augment)
    torch.cuda.synchronize()
    assert preprocess.fused_preprocess.launches == before + 1
    want = preprocess.fused_preprocess_reference(bands, n_color, *draws, augment=augment)
    # min/max exact, the mean summed in another order: outputs in [0, 1]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_fused_preprocess_kernel_propagates_nan(cuda):
    bands = torch.rand((2, 8, 8, 3), device=cuda)
    bands[0, 3, 4, 1] = float("nan")
    got = preprocess.fused_preprocess(bands, 3, augment=False)
    want = preprocess.fused_preprocess_reference(bands, 3, augment=False)
    assert torch.isnan(got[0, ..., 1]).all() and not torch.isnan(got[1]).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6, equal_nan=True)


def test_fused_preprocess_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((2, 8, 8, 3), device=cuda)
    with pytest.raises(ValueError):
        preprocess.fused_preprocess(x.double(), augment=False)
    with pytest.raises(ValueError):
        preprocess.fused_preprocess(x.transpose(1, 2), augment=False)
    with pytest.raises(ValueError, match="requires draws"):
        preprocess.fused_preprocess(x)


def test_make_preprocess_fn_on_cuda_runs_the_kernel(cuda):
    rng = np.random.default_rng(2)
    bands = ["B2", "B3", "B4"]
    batch = {b: rng.uniform(0, 3000, (4, 16, 16)).astype(np.float32) for b in bands}
    batch["landcover"] = rng.integers(0, 2, (4, 16, 16)).astype(np.float32)
    draws = preprocess.draw_augment_params(torch.Generator().manual_seed(0), 4, 3)
    got, want = [], []
    for device, out in ((cuda, got), ("cpu", want)):
        pre = make_preprocess_fn(bands, "landcover", axes=(0, 1), device=device)
        before = preprocess.fused_preprocess.launches
        for train in (True, False):
            out.extend(t.cpu() for t in pre(batch, train=train, draws=draws))
        assert preprocess.fused_preprocess.launches == before + 2 * (device == cuda)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("blend", ["overwrite", "hann"])
def test_engine_cuda_matches_cpu(cuda, blend):
    model = UNet(6, n_classes=1, filters=(8, 16), factors=(2, 2), head="sigmoid",
                 space_to_depth=True)
    scene = np.random.default_rng(1).normal(size=(70, 90, 6)).astype(np.float32)
    kw = dict(kernel=16, buffer=8, batch_size=4, blend=blend)
    before = stitch.hann_stitch.launches
    got = TiledInferenceEngine.from_model(model, device=cuda, **kw).predict_scene(scene)
    assert stitch.hann_stitch.launches == before + (blend == "hann")
    want = TiledInferenceEngine.from_model(model.cpu(), device="cpu", **kw).predict_scene(scene)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
