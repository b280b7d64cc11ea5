"""``swin_attn_roofline`` over a hand-written table: the windowed
attention's least time, from the ``swin.stage`` spans' shapes, over its
kernels' device time, and no reading where the kernels and the spans'
layers disagree."""

import pytest

from conftest import REPO
from perfbench import manifest, program_spans, tracing, window_attention_counts

READER = manifest.load_module(REPO / "perfbench" / "layer_metrics" / "swin_attn_roofline.py",
                              "reader_swin_attn_roofline")
H100 = "NVIDIA H100 80GB HBM3"
CUTLASS = "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel)"
# the first stage at 512^2: 32 images of 16 x 16 windows, 4 heads of 32;
# the program passes its unrolled block's mask once and its rolled block's
# once a window of every image
STAGE0 = {"stage": 0, "images": 32, "windows": 256, "tokens": 64, "heads": 4, "head_dim": 32,
          "layers": 2, "rolled": 1, "dtype": "bfloat16",
          "mask_bytes": (1 + 32 * 256) * 4 * 64 * 64 * 2, "padded_tokens": 0}
STAGE3 = dict(STAGE0, stage=3, windows=4, heads=32, mask_bytes=(1 + 32 * 4) * 32 * 64 * 64 * 2)


def _table(kernels=4, us=200.0):
    ev = [["host", tracing.WINDOW, 0.0, 2000.0, 1],
          ["kernel", "nvjet_tst_128x64_64x8_1x2_h_bz_TNT", 10.0, 50.0, 0]]
    ev += [["kernel", CUTLASS, 100.0 + 300.0 * i, us, 0] for i in range(kernels)]
    return {"window_us": 2000.0, "events": ev}


@pytest.fixture
def spans(monkeypatch):
    logged = [("serve.forward", 5.0, 1900.0, {}), ("swin.stage", 20.0, 800.0, dict(STAGE0)),
              ("swin.stage", 900.0, 1500.0, dict(STAGE3)),
              ("swin.stage", 2100.0, 2300.0, dict(STAGE0))]  # starts after the window
    monkeypatch.setattr(program_spans, "spans", lambda table: logged)


def test_counts_from_the_shapes():
    flops = window_attention_counts.stage_flops(STAGE0)
    assert flops == 2 * 4 * 32 * 256 * 4 * 64 ** 2 * 32
    qkvo = 2 * 4 * 32 * 256 * 4 * 64 * 32 * 2
    # the mask's distinct values: one a window-head of the rolled call (the
    # same in every image), one a head of the other; not the copies passed
    mask = (256 + 1) * 4 * 64 * 64 * 2
    assert window_attention_counts.mask_bytes(STAGE0) == mask
    assert window_attention_counts.stage_bytes(STAGE0) == qkvo + mask
    # 32 FLOPs a byte of Q, K, V and O, below the card's 295: bound by memory
    assert window_attention_counts.stage_least_s(STAGE0, 989e12, 3.35e12) == pytest.approx(
        (qkvo + mask) / 3.35e12)
    assert window_attention_counts.stage_bytes(dict(STAGE0, dtype="float32")) == 2 * (qkvo + mask)
    # no roll (a window covering the map): one copy a call
    assert window_attention_counts.mask_bytes(dict(STAGE0, rolled=0)) == 2 * 4 * 64 * 64 * 2


def test_reads_least_over_device_time(spans):
    least = sum(window_attention_counts.stage_least_s(a, 989e12, 3.35e12)
                for a in (STAGE0, STAGE3))
    value = READER.read(_table(), {"device_name": H100})
    assert value == pytest.approx(100.0 * least / 800e-6)
    assert READER.attention_kernels(_table()) == (4, pytest.approx(800e-6))


@pytest.mark.parametrize("kernels", [3, 5])
def test_no_reading_when_kernels_and_layers_disagree(spans, kernels):
    assert READER.read(_table(kernels), {"device_name": H100}) is None


def test_no_reading_without_a_peak_or_spans(spans, monkeypatch):
    assert READER.read(_table(), {"device_name": "cpu"}) is None
    monkeypatch.setattr(program_spans, "spans", lambda table: None)
    assert READER.read(_table(), {"device_name": H100}) is None
    monkeypatch.setattr(program_spans, "spans", lambda table: [("vit.encoder", 1.0, 2.0, {})])
    assert READER.read(_table(), {"device_name": H100}) is None
