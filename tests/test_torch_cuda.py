"""The port on the card: the hand-written CUDA kernels against their plain
PyTorch versions, and the engine on CUDA against the engine on the CPU.

These tests skip without a CUDA device. The file imports no JAX, so it
also runs on a GPU host that has none (the repository's conftest imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import copy

import numpy as np
import pytest
import torch

from satellite_computervision_tpu_torch.data.pipeline import make_preprocess_fn
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.kernels import preprocess, stitch
from satellite_computervision_tpu_torch.models import DeepLabV3Plus, SiameseUNet, UNet

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
    (256, 128, 8, 8, 1),  # the change serving shape: side 1.5 k
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


@pytest.mark.parametrize("apply_window", [False, True], ids=["weighted", "window"])
@pytest.mark.parametrize("k,buf,rows,cols,c_out", [
    (16, 8, 3, 4, 2),     # side < 2k, C = 2
    (16, 16, 3, 4, 1),    # side == 2k
    (15, 6, 2, 3, 1),     # k*C not a multiple of 4: the scalar path
    (16, 8, 1, 1, 3),     # one chip; k*C a multiple of 4, side*C not
    (512, 128, 4, 4, 1),  # the solar serving shape
    (256, 128, 8, 8, 1),  # the change serving shape: side 1.5 k
    (512, 256, 8, 8, 1),  # the parking serving shape: 64 x 768² -> 4608²
])
def test_hann_stitch_kernel_bit_equal(cuda, k, buf, rows, cols, c_out, apply_window):
    side = k + buf
    rng = np.random.default_rng(k + rows + c_out)
    chips = torch.from_numpy(
        rng.normal(size=(rows * cols, side, side, c_out)).astype(np.float32)).to(cuda)
    before = stitch.hann_stitch.launches
    got = stitch.hann_stitch(chips, k, rows, cols, apply_window=apply_window)
    torch.cuda.synchronize()
    assert stitch.hann_stitch.launches == before + 1
    want = stitch.hann_stitch_reference(chips, k, rows, cols, apply_window=apply_window)
    # the same products and adds, each rounded on its own, in the same order
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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


def _explicit_draws(b, n_color, seed, morphs=None):
    gen = torch.Generator().manual_seed(seed)
    contra, bright, morph = preprocess.draw_augment_params(gen, b, max(n_color, 1))
    if morphs is not None:
        morph = torch.tensor(morphs, dtype=torch.int32).reshape(b, 3)
    return contra, bright, morph


def _check_against_plain(cuda, bands, n_color, draws, augment=True):
    before = preprocess.fused_preprocess.launches
    got = preprocess.fused_preprocess(bands, n_color, *draws, augment=augment)
    torch.cuda.synchronize()
    assert preprocess.fused_preprocess.launches == before + 1  # one call, one launch
    want = preprocess.fused_preprocess_reference(bands, n_color, *draws, augment=augment)
    # min/max exact, the mean summed in another order: outputs in [0, 1]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5, equal_nan=True)
    return got


def _unaligned(bands):
    """A contiguous copy of ``bands`` whose data starts 4 bytes past a
    16-byte boundary: the kernel then takes its streamed route with scalar
    loads, whatever the shape."""
    flat = torch.empty(bands.numel() + 1, dtype=bands.dtype, device=bands.device)
    out = flat[1:].view(bands.shape)
    out.copy_(bands)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("shape,layout", [
    ((16, 40, 40, 7), "aligned"),     # rows fit in shared memory: resident
    ((16, 40, 40, 7), "unaligned"),   # streamed, scalar loads
    ((16, 296, 296, 8), "aligned"),   # rows do not fit: streamed, 16-byte loads
])
def test_fused_preprocess_kernel_every_morph(cuda, shape, layout):
    """All 16 (flip_v, flip_h, rot90) morphs, one per chip, on a K that
    leaves partial tiles, on each of the kernel's routes."""
    morphs = [(fv, fh, r) for fv in (0, 1) for fh in (0, 1) for r in range(4)]
    gen = torch.Generator().manual_seed(3)
    bands = (torch.rand(shape, generator=gen) * 3000.0).to(cuda)
    if layout == "unaligned":
        bands = _unaligned(bands)
    _check_against_plain(cuda, bands, 6, _explicit_draws(16, 6, 3, morphs))


@pytest.mark.parametrize("k", [5, 17, 33, 250])
@pytest.mark.parametrize("c", [1, 7, 9, 64, 300])
def test_fused_preprocess_kernel_ragged_shapes(cuda, k, c):
    """Ragged K (CTAs with no rows at K = 5, partial tiles) against every
    channel count the staging meets: 1, one chunk, a chunk and a remainder,
    many chunks, more channels than 256 threads. K*C % 4 != 0 takes the
    streamed route with scalar loads, C = 64 and 300 at K = 250 the
    streamed route with 16-byte loads, the rest the resident route."""
    gen = torch.Generator().manual_seed(k * c)
    b = 2
    bands = (torch.rand((b, k, k, c), generator=gen) * 3000.0).to(cuda)
    n_color = max(c - 1, 1)
    morphs = [(1, 0, 1), (0, 1, 3)]
    _check_against_plain(cuda, bands, n_color, _explicit_draws(b, n_color, k, morphs))
    _check_against_plain(cuda, bands, n_color, (None,) * 3, augment=False)


@pytest.mark.parametrize("layout", ["aligned", "unaligned"])
def test_fused_preprocess_kernel_negative_contra_and_nan_plane(cuda, layout):
    """A negative contra swaps the recolored extrema; a NaN plane, or a -inf
    pixel under a negative contra (inf - inf in the recolor), rescales to
    NaN and leaves the other planes alone. B = 1 and B = 4, on the resident
    and the streamed route."""
    gen = torch.Generator().manual_seed(11)
    bands = (torch.rand((4, 64, 64, 7), generator=gen) * 3000.0).to(cuda)
    bands[2, 10, 20, 3] = float("nan")
    bands[1, 5, 5, 4] = float("-inf")
    if layout == "unaligned":
        bands = _unaligned(bands)
    contra, bright, morph = _explicit_draws(4, 6, 11, [(0, 0, 0), (1, 1, 1), (0, 1, 2), (1, 0, 3)])
    contra[1] = -contra[1]
    contra[3, 2] = 0.0
    got = _check_against_plain(cuda, bands, 6, (contra, bright, morph))
    assert torch.isnan(got[2, ..., 3]).all() and torch.isnan(got[1, ..., 4]).all()
    assert not torch.isnan(got[[0, 3]]).any()
    assert not torch.isnan(got[1, ..., [0, 1, 2, 3, 5, 6]]).any()
    _check_against_plain(cuda, bands[1:2].contiguous(), 6, (contra[1:2], bright[1:2], morph[1:2]))


def test_fused_preprocess_kernel_takes_draws_on_either_device(cuda):
    gen = torch.Generator().manual_seed(5)
    bands = torch.rand((3, 32, 32, 4), generator=gen).to(cuda)
    draws = _explicit_draws(3, 4, 5, [(1, 0, 1), (0, 0, 2), (1, 1, 3)])
    host = preprocess.fused_preprocess(bands, 4, *draws)
    dev = preprocess.fused_preprocess(bands, 4, *(d.to(cuda) for d in draws))
    torch.testing.assert_close(host, dev, rtol=0, atol=0)


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


def _engine(cuda, model, **kw):
    return TiledInferenceEngine.from_model(model, device=cuda, **{
        "kernel": 16, "buffer": 8, "batch_size": 4, "blend": "hann", **kw})


@pytest.fixture
def small_unet():
    torch.manual_seed(0)
    return UNet(6, n_classes=1, filters=(8, 16), factors=(2, 2), head="sigmoid",
                space_to_depth=True).eval()


def test_banded_hann_on_card_equals_unbanded(cuda, small_unet):
    """Bands (one halo chip row per interior side) through the CUDA
    hann_stitch, one launch per band, equal the one-shot canvas."""
    scene = np.random.default_rng(2).uniform(0, 1, (150, 70, 6)).astype(np.float32)
    want = _engine(cuda, small_unet).predict_scene(scene)
    before = stitch.hann_stitch.launches
    got = _engine(cuda, small_unet, max_rows=56).predict_scene(scene)
    # 10 chip rows, bands of 3 rows advancing 1: 10 bands
    assert stitch.hann_stitch.launches == before + 10
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_culled_on_card_equals_unculled_on_valid_pixels(cuda, small_unet):
    scene = np.random.default_rng(3).uniform(0.1, 1, (150, 70, 6)).astype(np.float32)
    scene[:60] = 0.0
    scene[:, :20] = 0.0
    valid = torch.from_numpy((scene != 0).any(-1))
    for kw in ({}, {"max_rows": 56}):
        want = _engine(cuda, small_unet, **kw).predict_scene(scene).cpu()
        got = _engine(cuda, small_unet, nodata=0.0, **kw).predict_scene(scene).cpu()
        torch.testing.assert_close(got[valid], want[valid], rtol=0, atol=1e-6)


@pytest.mark.parametrize("prefetch", [1, 2])
def test_predict_scenes_staging_on_card_equals_predict_scene(cuda, small_unet, prefetch):
    """Pinned ring staging + read-back over 7 scenes of two sizes (the ring
    of prefetch + 1 buffers wraps and grows) equals predict_scene scene by
    scene; with nodata the validity rides along from the staging thread."""
    rng = np.random.default_rng(4)
    scenes = []
    for i in range(7):
        s = rng.uniform(0.1, 1, (64 + 16 * (i % 2), 48, 6)).astype(np.float32)
        s[: 8 * i] = 0.0
        scenes.append(s)
    engine = _engine(cuda, small_unet, nodata=0.0)
    got = list(engine.predict_scenes(iter(scenes), prefetch=prefetch, readback=True))
    assert len(got) == 7
    for scene, out in zip(scenes, got):
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, engine.predict_scene(scene).cpu().numpy())


@pytest.fixture
def small_siamese():
    torch.manual_seed(0)
    return SiameseUNet(4, filters=(8, 16), factors=(2, 2)).eval()


def test_siamese_forward_on_card_matches_cpu(cuda, small_siamese):
    """The shared towers, the dilated ASPP and the decoder on the card
    (float32, TF32 off) against the CPU, within 1e-4 x max|logit|."""
    gen = torch.Generator().manual_seed(1)
    before = torch.rand((4, 48, 48, 4), generator=gen)
    after = before + 0.3 * torch.rand((4, 48, 48, 4), generator=gen)
    with torch.no_grad():
        want = small_siamese(before, after)["logits"]
        got = small_siamese.to(cuda)(before.to(cuda), after.to(cuda))["logits"].cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(want.abs().max().item(), 1.0))


@pytest.mark.parametrize("max_rows", [None, 56], ids=["unbanded", "banded"])
def test_change_engine_on_card_matches_cpu(cuda, small_siamese, max_rows):
    """A before/after pair as one 8-band stack through the engine, each
    chip batch split at 4 into the two towers, culled, hann-blended by the
    CUDA kernel: one launch per scene, or per band holding a kept chip."""
    rng = np.random.default_rng(5)
    stack = rng.uniform(0.1, 1, (150, 70, 8)).astype(np.float32)
    stack[:, :30] = 0.0  # both scenes nodata: the first chip column is culled
    kw = dict(kernel=16, buffer=8, batch_size=4, blend="hann", nodata=0.0, max_rows=max_rows)

    def engine(model, device):
        model = model.to(device)
        return TiledInferenceEngine(lambda c: model(c[..., :4], c[..., 4:])["probs"],
                                    device=device, **kw)

    before = stitch.hann_stitch.launches
    got = engine(small_siamese, cuda).predict_scene(stack).cpu()
    # 10 chip rows: one scene, or 10 bands of 3 rows advancing 1
    assert stitch.hann_stitch.launches == before + (1 if max_rows is None else 10)
    want = engine(small_siamese, "cpu").predict_scene(stack)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("side", [64, 72], ids=["even", "odd-c5"])
def test_deeplab_forward_on_card_matches_cpu(cuda, side):
    """DeepLab v3+ (ResNet stages 1/1/1/1, ASPP 32) on the card (float32,
    TF32 off) against the CPU, eval and train mode, within 1e-4 x
    max|logit|: the explicit SAME pads, the -inf max-pool pad and the
    bilinear resizes (72²: C5 of 5² resized to C2 of 18²)."""
    torch.manual_seed(0)
    model = DeepLabV3Plus(3, stage_sizes=(1, 1, 1, 1), aspp_features=32)
    x = torch.rand((2, side, side, 3), generator=torch.Generator().manual_seed(2))
    for train in (False, True):
        cpu, card = (copy.deepcopy(model).train(train) for _ in range(2))
        card.to(cuda)
        with torch.no_grad():
            want = cpu(x)["logits"]
            got = card(x.to(cuda))["logits"].cpu()
        assert got.shape == (2, side, side, 1)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * max(want.abs().max().item(), 1.0))
