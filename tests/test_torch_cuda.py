"""The port on the card: the hand-written CUDA kernels against their plain
PyTorch versions, and the engine on CUDA against the engine on the CPU.

These tests skip without a CUDA device. The file imports no JAX, so it
also runs on a GPU host that has none (the repository's conftest imports
JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from satellite_computervision_tpu_torch.data.pipeline import make_preprocess_fn, prefetch_to_device
from satellite_computervision_tpu_torch.inference import TiledInferenceEngine
from satellite_computervision_tpu_torch.kernels import epilogue, preprocess, stitch
from satellite_computervision_tpu_torch.models import DeepLabV3Plus, SiameseUNet, UNet
from test_torch_epilogue import _bits, folded_unet, unfused_forward

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
    (176, 48, 21, 21, 1),  # the HLS sweep's tile: 21 x 21 chips of 224² at stride 176
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


def test_prefetch_to_device_on_card_keeps_every_batch(cuda):
    """Ten dict batches of three dtypes and three sizes through a ring of
    size + 1 = 3 pinned buffers, reused and grown while the consumer holds
    every earlier batch and keeps its stream busy: each array is its own
    contiguous device tensor, equal to its host array."""
    rng = np.random.default_rng(5)
    batches = []
    for i in range(10):
        side = 256 + 128 * (i % 3)
        weight = rng.normal(size=(4, side, 2 * side)).astype(np.float16)
        batches.append({"bands": rng.normal(size=(4, side, side, 3)).astype(np.float32),
                        "label": rng.integers(0, 2, (4, side, side)).astype(np.uint8),
                        "weight": weight[..., ::2]})  # a strided view
    a = torch.randn(2048, 2048, device=cuda)
    held = []
    for batch in prefetch_to_device(iter(batches), size=2, device=cuda):
        held.append(batch)
        for _ in range(4):  # the consumer's stream runs behind the copies
            a = torch.tanh(a @ a)
    torch.cuda.synchronize()
    assert len(held) == 10
    assert len({t.data_ptr() for b in held for t in b.values()}) == 30
    for host, dev in zip(batches, held):
        assert list(dev) == list(host)
        for k, arr in host.items():
            assert dev[k].device.type == "cuda" and dev[k].is_contiguous()
            np.testing.assert_array_equal(dev[k].cpu().numpy(), arr)


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


def _raw_items(seed, n, side=256):
    """Raw L1C DN bands (masking names) with clouds, a dark vegetated
    block, a B3 = B11 = 0 stripe and QA60 bits 10/11."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bands = {b: rng.uniform(300.0, 3000.0, (side, side)).astype(np.float32)
                 for b in ("B1", "B2", "B3", "B4", "B8", "B10", "B11", "B12")}
        y, x = rng.integers(0, side // 2, 2)
        for b in bands:
            bands[b][y : y + side // 4, x : x + side // 4] = 5000.0
        bands["B2"][: side // 8, : side // 4] = 300.0
        bands["B3"][:, 7:9] = bands["B11"][:, 7:9] = 0.0
        bands["QA60"] = (rng.integers(0, 4, (side, side)) * 1024).astype(np.float32)
        out.append(bands)
    return out


def test_masks_on_card_equal_cpu(cuda):
    """Through ``cloud._exact`` (true division by a 0-dim tensor, the
    square root in float64, explicit band sums) the card's masks, uint8
    scores and float scores are bit-equal to the CPU's."""
    from satellite_computervision_tpu_torch.cloud import masking

    for bands in _raw_items(0, 3):
        host = {k: torch.from_numpy(v) for k, v in bands.items()}
        card = {k: v.to(cuda) for k, v in host.items()}
        for fn in (masking.sentinel_cloud_score, masking.water_score, masking.raw_cloud_score):
            got, want = fn(card).cpu(), fn(host)
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), fn.__name__
        keep = masking.combined_mask(card) & masking.basic_qa_mask(card["QA60"])
        want = masking.combined_mask(host) & masking.basic_qa_mask(host["QA60"])
        assert keep.device.type == "cuda" and torch.equal(keep.cpu(), want)
        assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("t", [2, 5, 6])
def test_median_and_normalize_on_card_equal_cpu(cuda, t):
    from satellite_computervision_tpu_torch.cloud import _exact, compositing

    rng = np.random.default_rng(t)
    stack = rng.uniform(0.0, 3000.0, (t, 96, 80, 4)).astype(np.float32)
    stack[rng.uniform(size=stack.shape) < 0.3] = np.nan
    stack[:, 0, 0] = np.nan  # all masked
    want = compositing.median_composite(stack, device="cpu")
    for band_elements in (compositing._MEDIAN_BAND_ELEMENTS, t * 80 * 4 * 7):
        compositing._MEDIAN_BAND_ELEMENTS, saved = band_elements, compositing._MEDIAN_BAND_ELEMENTS
        try:
            got = compositing.median_composite(torch.from_numpy(stack).to(cuda), device="cuda")
        finally:
            compositing._MEDIAN_BAND_ELEMENTS = saved
        assert got.device.type == "cuda"
        assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got.cpu()), torch.nan_to_num(want))
    norm = compositing.normalize_composite(got, device="cuda").cpu()
    want_norm = compositing.normalize_composite(want, device="cpu")
    assert torch.equal(torch.isnan(norm), torch.isnan(want_norm))
    assert torch.equal(torch.nan_to_num(norm), torch.nan_to_num(want_norm))
    x = torch.from_numpy(rng.uniform(0.0, 9.0, 1 << 20).astype(np.float32))
    assert torch.equal(_exact.sqrt(x.to(cuda)).cpu(), _exact.sqrt(x))
    assert torch.equal(_exact.div(x.to(cuda), 0.15).cpu(), _exact.div(x, 0.15))


@pytest.mark.parametrize("k,buf,rows,cols", [
    (32, 16, 7, 3),      # a band of a small grid
    (512, 128, 7, 5),    # a solar band: rpd + 2 chip rows of 640² chips
])
def test_hann_stitch_kernel_with_row_weights_bit_equal(cuda, k, buf, rows, cols):
    """A band of a taller grid (parallel/spatial.py): the normalizer's rows
    come from the caller; bit-equal to the plain version."""
    side = k + buf
    rng = np.random.default_rng(rows)
    chips = torch.from_numpy(
        rng.normal(size=(rows * cols, side, side, 1)).astype(np.float32)).to(cuda)
    wy = stitch._axis_weight_sum(rows + 4, k, side)[2 * k : (rows + 3) * k].copy()
    wy[:k] = 1.0  # rows off the whole grid's canvas
    row_weights = torch.from_numpy(wy).to(cuda)
    before = stitch.hann_stitch.launches
    got = stitch.hann_stitch(chips, k, rows, cols, apply_window=True, row_weights=row_weights)
    torch.cuda.synchronize()
    assert stitch.hann_stitch.launches == before + 1
    want = stitch.hann_stitch_reference(chips, k, rows, cols, apply_window=True,
                                        row_weights=row_weights)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        stitch.hann_stitch(chips, k, rows, cols, row_weights=row_weights[:-1])


def test_global_batchnorm_at_world_one_matches_batchnorm(cuda, tmp_path):
    """GlobalBatchNorm over a one-rank NCCL group against the plain
    BatchNorm on the same batch: outputs, input gradients and running
    statistics (one-pass against cuDNN's variance: rounding)."""
    import torch.distributed as dist

    from satellite_computervision_tpu_torch.models.blocks import BatchNorm
    from satellite_computervision_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
        use_global_batchnorm,
    )

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    initialize_distributed(f"file://{tmp_path / 'pg'}", device="cuda", timeout=60)
    try:
        group = make_mesh().get_group("data")
        x = torch.from_numpy(np.random.default_rng(0).normal(
            1.0, 2.0, (8, 16, 24, 24)).astype(np.float32)).to(cuda)
        plain = BatchNorm(16, eps=1e-3, momentum=0.1).to(cuda).train()
        glob = use_global_batchnorm(copy.deepcopy(plain), group)
        results = []
        for bn in (plain, glob):
            xs = x.clone().requires_grad_(True)
            y = bn(xs)
            (y * torch.arange(16, device=cuda).view(1, -1, 1, 1)).sum().backward()
            results.append((y.detach(), xs.grad, bn.running_mean, bn.running_var,
                            bn.num_batches_tracked))
        for a, b in zip(*results):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_h5_round_trip_of_a_card_model(cuda):
    """A U-Net on the card (float32) out to the reference's Keras layers
    and back (in memory: the card host may have no h5py) into a model built
    on the meta device: the weights bit-equal, the forward on the card
    bit-equal."""
    from satellite_computervision_tpu_torch.train import keras_export, keras_import
    from satellite_computervision_tpu_torch.train.checkpoint import build_empty

    kw = dict(n_classes=1, filters=(8, 16), factors=(2, 2), head="sigmoid", convs_per_block=1)
    model = UNet(6, **kw).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) + 0.25)
    model = model.to(cuda)
    layers = keras_export.keras_unet_layers(model)
    assert keras_import.infer_unet_arch(layers)["filters"] == (8, 16)
    back = keras_import.load_keras_unet_h5(layers, build_empty(UNet, 6, **kw)).to(cuda)
    want = model.state_dict()
    for k, v in back.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
    x = torch.rand((2, 32, 32, 6), generator=g).to(cuda)
    with torch.no_grad():
        assert torch.equal(back(x)["probs"], model(x)["probs"])


# ---- the conv epilogues (kernels/epilogue.py) at the sweep's shapes: the
# solar U-Net's 16 chips of 640² at each level, and the odd cases
SWEEP_SITES = [(640, 32), (320, 64), (160, 128), (80, 256), (40, 512), (20, 1024)]
SWEEP_CONCATS = [(40, 512, 512), (80, 256, 256), (160, 128, 128), (320, 64, 64), (640, 32, 32)]


def _hard_on_card(shape, dtype, seed):
    """Normals on the card with NaN, +-0, +-inf and -1e30 planted, channels-last."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 3.0
    flat = x.view(-1)
    for i, v in enumerate([float("nan"), 0.0, -0.0, float("inf"), -float("inf"), -1e30]):
        flat[i::61] = v
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _vector_on_card(n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(n, generator=g, device="cuda")
    v[:4] = torch.tensor([0.0, -0.0, -5.0, float("nan")])
    return v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,side,c", [(16, s, c) for s, c in SWEEP_SITES] + [
    (3, 7, 8),      # pixels not a whole number of blocks
    (2, 5, 24),     # 3 (bf16) or 6 (f32) vectors a pixel: blocks of 255 / 252 threads
    (1, 3, 8192),   # 1024 (bf16) or 2048 (f32: past a block) vectors a pixel
])
def test_bias_relu_kernel_bit_equal(cuda, dtype, b, side, c):
    if dtype == torch.float32 and c == 8192:
        with pytest.raises(ValueError):
            epilogue.bias_relu_(_hard_on_card((b, c, side, side), dtype, 0),
                                _vector_on_card(c, dtype, 1))
        return
    y = _hard_on_card((b, c, side, side), dtype, side + c)
    bias = _vector_on_card(c, dtype, c)
    want = epilogue.bias_relu_reference(y.clone(memory_format=torch.channels_last), bias)
    before = epilogue.bias_relu_.launches
    got = epilogue.bias_relu_(y, bias)
    torch.cuda.synchronize()
    assert got is y and epilogue.bias_relu_.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,side,c_skip,c_up", [(16, *s) for s in SWEEP_CONCATS] + [
    (3, 7, 16, 8),   # the sources of unequal widths
    (2, 5, 8, 16),
    (1, 3, 4096, 4096),  # 1024 (bf16) vectors a pixel: a block of 1024 threads
])
def test_cat_affine_relu_kernel_bit_equal(cuda, dtype, b, side, c_skip, c_up):
    skip = _hard_on_card((b, c_skip, side, side), dtype, side + c_skip)
    up = _hard_on_card((b, c_up, side, side), dtype, side + c_up + 1)
    up_bias = _vector_on_card(c_up, dtype, 2)
    scale = _vector_on_card(c_skip + c_up, dtype, 3)
    shift = _vector_on_card(c_skip + c_up, dtype, 4)
    if dtype == torch.float32 and c_skip + c_up > 4096:  # 2048 vectors a pixel: past a block
        with pytest.raises(ValueError):
            epilogue.cat_affine_relu(skip, up, up_bias, scale, shift)
        return
    want = epilogue.cat_affine_relu_reference(skip, up, up_bias, scale, shift)
    before = epilogue.cat_affine_relu.launches
    got = epilogue.cat_affine_relu(skip, up, up_bias, scale, shift)
    torch.cuda.synchronize()
    assert epilogue.cat_affine_relu.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(got), _bits(want))


SWEEP_POOLS = SWEEP_SITES[:5]  # the encoders' last convs: 640² x 32 down to 40² x 512


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,side,c", [(16, s, c) for s, c in SWEEP_POOLS] + [
    (3, 8, 8),      # 4 pooled columns: most of a block's threads idle
    (2, 6, 24),     # 3 (bf16) or 6 (f32) vectors a pixel: blocks of 255 / 252 threads
    (1, 4, 8192),   # 1024 (bf16) or 2048 (f32: past a block) vectors a pixel
])
def test_bias_relu_pool_kernel_bit_equal(cuda, dtype, b, side, c):
    """``bias_relu_pool_`` against ``bias_relu_`` then ``F.max_pool2d`` on
    the card, bit for bit in both outputs, NaN and signed zeros planted in
    windows (channel 1's bias is -0)."""
    if dtype == torch.float32 and c == 8192:
        with pytest.raises(ValueError):
            epilogue.bias_relu_pool_(_hard_on_card((b, c, side, side), dtype, 0),
                                     _vector_on_card(c, dtype, 1))
        return
    y = _hard_on_card((b, c, side, side), dtype, side + c + 2)
    nan = float("nan")
    for (i, j), window in zip([(0, 0), (0, 2), (side - 2, side - 2)],
                              [[[-0.0, 0.0], [-3.0, -0.0]], [[1.0, nan], [nan, -0.0]],
                               [[0.0, -0.0], [nan, 5.0]]]):
        y[-1, 1, i:i + 2, j:j + 2] = torch.tensor(window, dtype=dtype)
    bias = _vector_on_card(c, dtype, c + 1)
    want_y = epilogue.bias_relu_(y.clone(memory_format=torch.channels_last), bias)
    want = torch.nn.functional.max_pool2d(want_y, 2, 2)
    before = epilogue.bias_relu_pool_.launches
    pooled, got_y = epilogue.bias_relu_pool_(y, bias)
    torch.cuda.synchronize()
    assert got_y is y and epilogue.bias_relu_pool_.launches == before + 1
    assert pooled.is_contiguous(memory_format=torch.channels_last)
    assert torch.isnan(pooled[-1, 1, 0, 1])
    assert torch.equal(_bits(got_y), _bits(want_y))
    assert torch.equal(_bits(pooled), _bits(want))


def test_epilogue_kernels_reject_unaligned_activations(cuda):
    y = torch.zeros((2 * 16 * 4 * 4 + 1,), device=cuda)[1:].view(2, 4, 4, 16).permute(0, 3, 1, 2)
    with pytest.raises(ValueError):
        epilogue.bias_relu_(y, torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        epilogue.bias_relu_pool_(y, torch.zeros(16, device=cuda))


def test_folded_solar_unet_served_on_card_bit_equal_to_the_unfused_ops(cuda):
    """The solar U-Net, folded, in bf16 channels-last as ``predict`` serves
    it: its probabilities bit-equal to the forward written out with the
    unfused ops, 27 epilogue launches a chip batch (17 conv sites, 5 conv
    sites with their pools, 5 decoders), each ``serve.forward`` span
    carrying them and its 5 pools."""
    from torch.profiler import ProfilerActivity, profile

    from satellite_computervision_tpu_torch.predict import to_serving
    from satellite_computervision_tpu_torch.utils.profiling import span_log

    net = to_serving(folded_unet(), cuda)
    g = torch.Generator().manual_seed(5)
    chips = (torch.rand((4, 640, 640, 6), generator=g) * 0.4).to(cuda)
    with torch.inference_mode():
        before, pooled = epilogue.launches(), epilogue.bias_relu_pool_.launches
        got = net(chips)["probs"]
        torch.cuda.synchronize()
        assert epilogue.launches() == before + 27
        assert epilogue.bias_relu_pool_.launches == pooled + 5
        want = unfused_forward(net, chips)
    assert torch.equal(got, want)

    engine = TiledInferenceEngine(lambda c: net(c)["probs"], kernel=512, buffer=128,
                                  batch_size=4, blend="hann", device=cuda)
    scene = np.random.default_rng(6).uniform(0, 0.4, (1024, 1536, 6)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.predict_scene(scene)
    forwards = [s.attrs for s in span_log() if s.name == "serve.forward"]
    assert len(forwards) == 2  # 2 x 3 chips in batches of 4
    assert all(a["kernels"] == 27 and a["pooled"] == 5 for a in forwards)


def test_folded_solar_unet_pooling_in_the_kernel_serves_the_unfused_pools_map(cuda, monkeypatch):
    """The served map with each encoder's bias, ReLU and pool in
    ``bias_relu_pool_`` is the map of ``bias_relu_`` then ``F.max_pool2d``
    at those sites, bit for bit."""
    from satellite_computervision_tpu_torch.predict import to_serving

    net = to_serving(folded_unet(), cuda)
    g = torch.Generator().manual_seed(9)
    chips = (torch.rand((4, 640, 640, 6), generator=g) * 0.4).to(cuda)
    with torch.inference_mode():
        got = net(chips)["probs"]
        bias_relu = epilogue.bias_relu_
        monkeypatch.setattr(epilogue, "bias_relu_pool_", lambda y, b: (
            torch.nn.functional.max_pool2d(bias_relu(y, b), 2, 2), y))
        want = net(chips)["probs"]
    assert torch.equal(got, want)


def test_folded_float32_unet_under_bf16_autocast_keeps_the_unfused_ops(cuda):
    """``bench.py``'s serving route: a folded float32 U-Net whose predictor
    runs it under bf16 autocast. Its convs return bf16 beside float32
    biases, so no epilogue kernel runs, and the probabilities are the
    unfused ops' under the same autocast, bit for bit."""
    from satellite_computervision_tpu_torch.bench import predictor

    net = folded_unet().to(cuda)
    g = torch.Generator().manual_seed(8)
    chips = (torch.rand((2, 256, 256, 6), generator=g) * 0.4).to(cuda)
    with torch.inference_mode():
        before = epilogue.launches()
        got = predictor(net)(chips)
        torch.cuda.synchronize()
        assert epilogue.launches() == before
        with torch.autocast("cuda", dtype=torch.bfloat16):
            want = unfused_forward(net, chips)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _prithvi(cuda, **overrides):
    """The configuration's Prithvi-EO-2.0 (``overrides`` replacing keys),
    its seeded float32 weights with the head's BatchNorm calibrated, the
    program's model served in bfloat16 channels-last, and two 224² chips."""
    import json

    from test_torch_prithvi import REPO

    from perfbench import inputs
    from perfbench.families import prithvi as family
    from perfbench.reference.layers import Ops, exact_float32
    from satellite_computervision_tpu_torch.predict import to_serving

    cfg = json.loads((REPO / "perfbench" / "configs" / "prithvi_eo2_300m.json").read_text())
    model = dict(cfg["model"], **overrides)
    spec = dict(json.loads((REPO / "perfbench" / "traffic" / "hls_tile_sweep.json").read_text())
                ["imagery"])
    w = inputs.draw_weights(family.reference.specs(model), inputs.generator(11, "weights", cuda),
                            cuda)
    x = inputs.imagery(inputs.generator(11, "chips", cuda), 2, 224, 24, spec, cuda).round()
    with exact_float32(), torch.no_grad():
        family.reference.logits(w, x, model, Ops("float32"), bn="calibrate")
    net = to_serving(family.build(model, cuda, w).eval(), cuda)
    return model, w, net, x


def _gap(got, want):
    return float((got.float() - want).norm() / want.norm())


def test_prithvi_block_and_encoder_in_bf16_against_the_float32_reference(cuda):
    """At the published widths, one block and the whole 24-layer encoder
    served in bfloat16 against the plain reference in float32 (TF32 off),
    as relative norms of the tokens' difference. bfloat16 keeps 8 bits
    (a relative rounding of 2^-9 a value): one block moved its tokens by
    0.0033 and the encoder by 0.0113 (H100); the limits leave 3x and 2.6x
    of room. The reference in float8 (3 bits) moved the encoder by 0.082,
    2.7x its limit: a program that computed in float8 would fail it."""
    from perfbench.reference import prithvi as ref
    from perfbench.reference.layers import Ops, exact_float32

    model, w, net, x = _prithvi(cuda)
    enc = net.encoder
    with torch.no_grad():
        tokens = enc.embed(net._standardise(x).to(torch.bfloat16), model["frames"])
        with exact_float32():
            want_block = ref.block(tokens.float(), w, "encoder.blocks.0", model["heads"],
                                   Ops("float32"))
            want = ref.encode(w, x, model, Ops("float32"))
            control = ref.encode(w, x, model, Ops("float8"))
        block, encoded = _gap(enc.blocks[0](tokens), want_block), _gap(enc(tokens), want)
    print(f"prithvi bf16 gaps: block {block:.5f}, encoder {encoded:.5f}; "
          f"float8 encoder {_gap(control, want):.5f}")
    assert block < 0.01 and encoded < 0.03
    assert _gap(control, want) > 0.03


def test_prithvi_sdpa_launches_match_the_encoder_span(cuda):
    """Every ``vit.encoder`` span's ``layers`` is one attention kernel on
    the card (the count ``sdpa_roofline`` holds the trace to), and the
    reader gives a share of the roofline, above 0 and at or under 100 %."""
    from test_torch_prithvi import REPO

    from perfbench import manifest, tracing
    from satellite_computervision_tpu_torch.utils.profiling import span_log

    reader = manifest.load_module(REPO / "perfbench" / "layer_metrics" / "sdpa_roofline.py",
                                  "sdpa_roofline")
    model, _, net, x = _prithvi(cuda, depth=2)
    x = torch.cat([x, x])
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        with tracing.profiled(cuda) as prof:
            with tracing.span("window"):
                for _ in range(3):
                    net(x)
                torch.cuda.synchronize()
    table = prof["table"]
    names = sorted({n for k, n, *_ in table["events"] if k == "kernel"
                    and any(s in n.lower() for s in reader.NEEDLES)})
    count, seconds = reader.attention_kernels(table)
    share = reader.read(table, {"device_name": torch.cuda.get_device_name(cuda)})
    print(f"attention kernels {names}: {count} in {seconds * 1e3:.3f} ms; sdpa_roofline {share}")
    logged = [r.attrs for r in span_log() if r.name == "vit.encoder"]
    assert len(logged) == 3 and count == sum(a["layers"] for a in logged) == 3 * 2
    assert logged[0]["tokens"] == 785 and logged[0]["dtype"] == "bfloat16"
    assert share is not None and 0 < share <= 100


def _train_model(family: str):
    """A small solar U-Net (plain stem) or DeepLab v3+ on one ResNet block
    a stage, seeded, channels-last as the training cells hold them."""
    torch.manual_seed(3)
    if family == "unet":
        model = UNet(6, n_classes=1, filters=(8, 16, 32), factors=(2, 2, 2), head="sigmoid")
    else:
        model = DeepLabV3Plus(4, n_classes=1, stage_sizes=(1, 1, 1, 1), aspp_features=32)
    return model.to(memory_format=torch.channels_last)


def _train_batches(cuda, family: str, n: int, batch: int = 4, side: int = 64):
    bands = 6 if family == "unet" else 4
    g = torch.Generator().manual_seed(4)
    return [(torch.randn((batch, side, side, bands), generator=g).to(cuda),
             (torch.rand((batch, side, side, 1), generator=g) > 0.7).float().to(cuda))
            for _ in range(n)]


def _train_steps(cuda, family, batches, monkeypatch, graphed: bool):
    """Steps of a fresh state over ``batches`` (bf16 autocast, weighted
    BCE, the trainer's Adam): the step function, the state and each step's
    returned loss and confusion matrix. ``graphed=False`` never captures."""
    from satellite_computervision_tpu_torch.models import losses
    from satellite_computervision_tpu_torch.train import trainer

    state = trainer.create_train_state(_train_model(family).to(cuda))
    step = trainer.make_train_step(
        lambda y, p: losses.weighted_bce(y, p, pos_weight=2.0, logits=True),
        compute_dtype=torch.bfloat16)
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(trainer, "EAGER_STEPS", 1 << 30)
        outs = [step(state, b) for b in batches]
    torch.cuda.synchronize()
    return step, state, outs


def _train_state_tensors(state) -> dict:
    """Parameters, BatchNorm buffers and Adam's moments and step counts."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    return out


@pytest.fixture
def deterministic():
    """cuDNN's deterministic algorithms, so two runs of one step compare
    bit for bit."""
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def _resize_by_matmul(x, size):
    """``deeplab.resize_bilinear`` (half-pixel centres, clamped at the
    edges) as two matrix products, whose gradient sums in a fixed order:
    the interpolation's own backward adds with atomics, so two eager runs
    of DeepLab differ in their last bits, and no deterministic version
    exists."""
    def weights(n_in, n_out):  # made on the device: a copy from the host breaks a capture
        at = dict(dtype=torch.float64, device=x.device)
        src = ((torch.arange(n_out, **at) + 0.5) * n_in / n_out - 0.5).clamp(0, n_in - 1)
        lo = src.floor()
        col = torch.arange(n_in, **at)
        return ((col == lo[:, None]) * (1 - (src - lo))[:, None]
                + (col == (lo + 1).clamp(max=n_in - 1)[:, None]) * (src - lo)[:, None]).float()

    return torch.einsum("oh,nchw,pw->ncop", weights(x.shape[2], size[0]), x,
                        weights(x.shape[3], size[1]))


@pytest.mark.parametrize("family", ["unet", "deeplab"])
def test_graphed_train_steps_equal_eager_steps(cuda, deterministic, monkeypatch, family):
    """Eight steps from one seed, replayed from a CUDA graph and run
    eagerly, both with the capturable Adam ``create_train_state`` builds on
    the card: two eager steps, one capture whose first replay does its
    work, five replays. Parameters, Adam's moments and step counts,
    BatchNorm's running statistics, the losses and the confusion matrices
    agree bit for bit; a short last batch then runs eagerly and agrees
    too. DeepLab's bilinear resize runs as matrix products
    (:func:`_resize_by_matmul`), so that each side repeats bit for bit."""
    from satellite_computervision_tpu_torch.models import deeplab

    monkeypatch.setattr(deeplab, "resize_bilinear", _resize_by_matmul)
    batches = _train_batches(cuda, family, 8)
    short = _train_batches(cuda, family, 1, batch=3)[0]
    runs = {}
    for graphed in (True, False):
        step, state, outs = _train_steps(cuda, family, batches, monkeypatch, graphed)
        assert state.optimizer.param_groups[0]["capturable"]
        counts = (step.captures, step.replays, step.eager)
        assert counts == ((1, 6, 2) if graphed else (0, 0, 8))
        outs.append(step(state, short))
        assert step.eager == (3 if graphed else 9)
        torch.cuda.synchronize()
        runs[graphed] = (_train_state_tensors(state), outs)
    (tensors, outs), (want_tensors, want_outs) = runs[True], runs[False]
    assert tensors.keys() == want_tensors.keys()
    for k, v in want_tensors.items():
        assert torch.equal(tensors[k], v), k
    for got, want in zip(outs, want_outs):
        assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["cm"], want["cm"])
    assert all(o["cm"].sum() == 4 * 64 * 64 for o in outs[:-1]) and outs[-1]["cm"].sum() == 3 * 64 * 64


@pytest.mark.parametrize("family", ["unet", "deeplab"])
def test_a_step_under_flop_counting_runs_eagerly(cuda, monkeypatch, family):
    """Once the graph is captured, a step under ``FlopCounterMode`` runs
    eagerly and counts the FLOPs an eager step counts; replays go on
    after it."""
    from torch.utils.flop_counter import FlopCounterMode

    batches = _train_batches(cuda, family, 5)
    counted = {}
    for graphed in (True, False):
        step, state, _ = _train_steps(cuda, family, batches[:4], monkeypatch, graphed)
        counter = FlopCounterMode(display=False)
        with counter:
            step(state, batches[4])
        counted[graphed] = counter.get_total_flops()
        if graphed:
            assert (step.captures, step.replays, step.eager) == (1, 2, 3)
            step(state, batches[0])
            assert step.replays == 3
    assert counted[True] == counted[False] > 0


@pytest.mark.parametrize("backend", ["pt", "dcp"])
def test_create_train_state_on_the_card_is_capturable_and_loads_old_checkpoints(cuda, tmp_path,
                                                                                 backend):
    """A CUDA model's Adam is capturable and fused, with the CPU one's
    settings; an optimizer state saved from a non-capturable Adam loads
    into it through either checkpoint backend and it stays so, its step
    counts on the card."""
    from satellite_computervision_tpu_torch.train.checkpoint import CheckpointManager
    from satellite_computervision_tpu_torch.train.trainer import create_train_state

    cpu = create_train_state(_train_model("unet"))
    cpu.model(torch.randn(2, 32, 32, 6))["logits"].sum().backward()
    cpu.optimizer.step()
    CheckpointManager(str(tmp_path), backend=backend).save(cpu, step=1)
    card = create_train_state(_train_model("unet").to(cuda))
    group, old = card.optimizer.param_groups[0], cpu.optimizer.param_groups[0]
    own = ("params", "capturable", "fused")
    assert group["capturable"] and group["fused"] and not old["capturable"]
    assert {k: v for k, v in group.items() if k not in own} == \
        {k: v for k, v in old.items() if k not in own}
    CheckpointManager(str(tmp_path), backend=backend).restore(card)
    assert card.optimizer.param_groups[0]["capturable"] and card.optimizer.param_groups[0]["fused"]
    for p, q in zip(card.model.parameters(), cpu.model.parameters()):
        got, want = card.optimizer.state[p], cpu.optimizer.state[q]
        assert got["step"].device.type == "cuda" and float(got["step"]) == float(want["step"])
        assert torch.equal(got["exp_avg"].cpu(), want["exp_avg"])


def test_a_step_that_reads_the_device_back_stays_eager(cuda, deterministic, monkeypatch):
    """A loss that reads a value back to the host (``float(...)``) cannot
    be captured: the capture fails with a warning, leaves the state as it
    was, and the signature's steps run eagerly from then on, bit-equal to
    steps that never tried. Random draws and memory used across streams
    work after it as before."""
    from satellite_computervision_tpu_torch.models import losses
    from satellite_computervision_tpu_torch.train import trainer

    def syncing(y, p):
        return losses.weighted_bce(y, p, 2.0, logits=True) * (1.0 + 0.0 * float(p.detach().mean()))

    batches = _train_batches(cuda, "unet", 6)
    runs = {}
    for graphed in (True, False):
        state = trainer.create_train_state(_train_model("unet").to(cuda))
        step = trainer.make_train_step(syncing, compute_dtype=torch.bfloat16)
        with monkeypatch.context() as m:
            if not graphed:
                m.setattr(trainer, "EAGER_STEPS", 1 << 30)
            with pytest.warns(RuntimeWarning, match="CUDA graph") if graphed else \
                    contextlib.nullcontext():
                outs = [step(state, b) for b in batches]
        assert (step.captures, step.replays, step.eager) == (0, 0, 6)
        assert torch.cuda.current_stream() == torch.cuda.default_stream()
        runs[graphed] = (_train_state_tensors(state), outs)
    for k, v in runs[False][0].items():
        assert torch.equal(runs[True][0][k], v), k
    for got, want in zip(runs[True][1], runs[False][1]):
        assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["cm"], want["cm"])
    torch.randn(8, device=cuda)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    for _ in range(8):
        with torch.cuda.stream(side):
            t = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
        t.record_stream(torch.cuda.current_stream())
        t.add_(1)
        del t
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() - before <= 2 * (64 << 20)
